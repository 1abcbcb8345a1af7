"""The persistent steppers' fused schedule (K3 and K4), on the CPU.

``interval_steps_kernel`` (``csrc/fdtd_steps.cu``, K4) and
``shard_steps_kernel`` (``csrc/fdtd_shard.cu``, K3) share their device
code (``csrc/yee_persist.cuh``): a step is an H pass and an E pass with
the MUR walls x → y → z fused into it, two grid barriers a step. In the
E pass each thread writes only its own cells, and a wall cell's final E
is computed from H, the old E and the one or two interior updates of its
neighbours, which the thread recomputes itself. The kernels run only on
the card (``tests/test_torch_cuda.py`` holds them to their twins there).
Here that E pass, transcribed cell for cell into NumPy
(:func:`emulate_steps`: every output written once into a fresh array,
nothing read from it), is held bit for bit to the plain twins
``interval_steps_plain`` and ``shard_steps_plain``: under MUR and PEC for
whole grids (padded past the grid, and with a lone interior plane), and
under MUR, PEC and PML_4 for slabs whose x walls lie inside, on the edge
of and outside the slab, the straddle slab included. The resident form
fixes a z wall cell's Ex and Ey from the next or previous lane's final
value where that lane holds the neighbour (a warp shuffle); the
transcription takes that route for the block and lane layouts given, and
recomputes elsewhere, as the kernel does. The walk's ``e_update_mur_kernel``
(``csrc/fdtd_chunk.cu``) is the same E pass on one thread a cell, its
walls at ``YeeOperands.mur_walls`` on every axis (a block's y walls too):
:func:`emulate_e_update_mur` is held bit for bit to ``e_update_mur_plain``
(``e_update_plain``, then ``mur_faces_plain`` for x, y and z) on
synthetic grids, on the walk's slabs and blocks (walls inside, on the
halo plane, outside) and without walls.
"""

import shutil

import numpy as np
import pytest
import torch

from _explicit_ranks import port_sim
from fdtd_solver_antennas_tpu_torch.ops import _build, fdtd_cuda, fdtd_shard, fdtd_steps
from fdtd_solver_antennas_tpu_torch.ops.fdtd_cuda import YeeOperands

f32 = np.float32


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Test workers share the cores (pytest-xdist)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the kernels' step in NumPy
# ---------------------------------------------------------------------------

def _np(t):
    return None if t is None else t.numpy().copy()


def _fwd(a, axis):
    """a[i + 1] along ``axis``, 0 past the end."""
    out = np.zeros_like(a)
    idx = [slice(None)] * 3
    src = list(idx)
    idx[axis], src[axis] = slice(0, -1), slice(1, None)
    out[tuple(idx)] = a[tuple(src)]
    return out


def _bwd(a, axis):
    """a[i − 1] along ``axis``, 0 before the start."""
    out = np.zeros_like(a)
    idx = [slice(None)] * 3
    src = list(idx)
    idx[axis], src[axis] = slice(1, None), slice(0, -1)
    out[tuple(idx)] = a[tuple(src)]
    return out


def _vec(v, axis):
    shape = [1, 1, 1]
    shape[axis] = -1
    return v.reshape(shape)


class _Kernel:
    """The operands as the kernel sees them (``persist::Ops``)."""

    def __init__(self, ops: YeeOperands, x_walls):
        self.n = tuple(ops.shape)
        self.ca = [_np(a) for a in ops.ca]
        self.cb = [_np(a) for a in ops.cb]
        self.src = [_np(a) for a in ops.src]
        self.ip = [_np(a) for a in ops.inv_p]
        self.id = [_np(a) for a in ops.inv_d]
        self.pml = None if ops.pml is None else {
            k: [_np(a) for a in v] for k, v in ops.pml.items()}
        self.dtmu = f32(ops.dtmu)
        self.mur = None if ops.mur is None else [
            [f32(c) for c in pair] for pair in ops.mur]
        q = ops.grid_shape
        self.lo = (x_walls[0], 0, 0)
        self.hi = (x_walls[1], q[1] - 1, q[2] - 1)

    def h_pass(self, E, H, psi_h):
        """``h_cell`` over every cell (in place, as the kernel)."""
        ex, ey, ez = E
        ipx, ipy, ipz = (_vec(self.ip[a], a) for a in range(3))
        dEz_y = (_fwd(ez, 1) - ez) * ipy
        dEy_z = (_fwd(ey, 2) - ey) * ipz
        dEx_z = (_fwd(ex, 2) - ex) * ipz
        dEz_x = (_fwd(ez, 0) - ez) * ipx
        dEy_x = (_fwd(ey, 0) - ey) * ipx
        dEx_y = (_fwd(ex, 1) - ex) * ipy
        if self.pml is not None:
            b = [_vec(self.pml["bh"][a], a) for a in range(3)]
            c = [_vec(self.pml["ch"][a], a) for a in range(3)]
            P = psi_h
            P[0][...] = b[1] * P[0] + c[1] * dEz_y
            P[1][...] = b[2] * P[1] + c[2] * dEy_z
            P[2][...] = b[2] * P[2] + c[2] * dEx_z
            P[3][...] = b[0] * P[3] + c[0] * dEz_x
            P[4][...] = b[0] * P[4] + c[0] * dEy_x
            P[5][...] = b[1] * P[5] + c[1] * dEx_y
            H[0][...] = H[0] - self.dtmu * ((dEz_y + P[0]) - (dEy_z + P[1]))
            H[1][...] = H[1] - self.dtmu * ((dEx_z + P[2]) - (dEz_x + P[3]))
            H[2][...] = H[2] - self.dtmu * ((dEy_x + P[4]) - (dEx_y + P[5]))
        else:
            H[0][...] = H[0] - self.dtmu * (dEz_y - dEy_z)
            H[1][...] = H[1] - self.dtmu * (dEx_z - dEz_x)
            H[2][...] = H[2] - self.dtmu * (dEy_x - dEx_y)

    def e_own(self, Eo, H, psi_e, s):
        """``e_cell``'s own update of every cell, before any wall."""
        hx, hy, hz = H
        idx, idy, idz = (_vec(self.id[a], a) for a in range(3))
        dHz_y = (hz - _bwd(hz, 1)) * idy
        dHy_z = (hy - _bwd(hy, 2)) * idz
        dHx_z = (hx - _bwd(hx, 2)) * idz
        dHz_x = (hz - _bwd(hz, 0)) * idx
        dHy_x = (hy - _bwd(hy, 0)) * idx
        dHx_y = (hx - _bwd(hx, 1)) * idy
        if self.pml is not None:
            b = [_vec(self.pml["be"][a], a) for a in range(3)]
            c = [_vec(self.pml["ce"][a], a) for a in range(3)]
            P = psi_e
            P[0][...] = b[1] * P[0] + c[1] * dHz_y
            P[1][...] = b[2] * P[1] + c[2] * dHy_z
            P[2][...] = b[2] * P[2] + c[2] * dHx_z
            P[3][...] = b[0] * P[3] + c[0] * dHz_x
            P[4][...] = b[0] * P[4] + c[0] * dHy_x
            P[5][...] = b[1] * P[5] + c[1] * dHx_y
            cu = ((dHz_y + P[0]) - (dHy_z + P[1]),
                  (dHx_z + P[2]) - (dHz_x + P[3]),
                  (dHy_x + P[4]) - (dHx_y + P[5]))
        else:
            cu = (dHz_y - dHy_z, dHx_z - dHz_x, dHy_x - dHx_y)
        out = []
        for m in range(3):
            v = self.ca[m] * Eo[m] + self.cb[m] * cu[m]
            if self.src[m] is not None:
                v = v + self.src[m] * f32(s)
            out.append(v)
        return out

    def e_at(self, Eo, H, m, x, s):
        """``e_at``: the interior update of component m at cell x, as its
        owner computes it (no CPML: MUR and CPML exclude each other)."""
        hx, hy, hz = H
        i, j, k = x
        zero = f32(0)
        if m == 0:
            hz_ym = hz[i, j - 1, k] if j > 0 else zero
            hy_zm = hy[i, j, k - 1] if k > 0 else zero
            cu = ((hz[x] - hz_ym) * self.id[1][j]
                  - (hy[x] - hy_zm) * self.id[2][k])
        elif m == 1:
            hx_zm = hx[i, j, k - 1] if k > 0 else zero
            hz_xm = hz[i - 1, j, k] if i > 0 else zero
            cu = ((hx[x] - hx_zm) * self.id[2][k]
                  - (hz[x] - hz_xm) * self.id[0][i])
        else:
            hy_xm = hy[i - 1, j, k] if i > 0 else zero
            hx_ym = hx[i, j - 1, k] if j > 0 else zero
            cu = ((hy[x] - hy_xm) * self.id[0][i]
                  - (hx[x] - hx_ym) * self.id[1][j])
        v = self.ca[m][x] * Eo[m][x] + self.cb[m][x] * cu
        if self.src[m] is not None:
            v = v + self.src[m][x] * f32(s)
        return v

    def inside(self, x):
        return all(0 <= c < n for c, n in zip(x, self.n))

    def mur_fix(self, Eo, H, m, x, s):
        """``mur_fix``: the final E of component m at the wall cell x."""
        walls = []  # (axis, side), last axis first
        for b in (2, 1, 0):
            if b == m:
                continue
            if x[b] == self.lo[b]:
                walls.append((b, 0))
            elif x[b] == self.hi[b]:
                walls.append((b, 1))
        (B, sB), rest = walls[0], walls[1:]
        nb = list(x)
        nb[B] += -1 if sB else 1
        nb = tuple(nb)
        eo_nb = en_nb = f32(0)
        if self.inside(nb):
            eo_nb = Eo[m][nb]
            if rest:
                (A, sA), = rest
                d = list(nb)
                d[A] += -1 if sA else 1
                d = tuple(d)
                eo_d = en_d = f32(0)
                if self.inside(d):
                    eo_d, en_d = Eo[m][d], self.e_at(Eo, H, m, d, s)
                en_nb = eo_d + self.mur[A][sA] * (en_d - eo_nb)
            else:
                en_nb = self.e_at(Eo, H, m, nb, s)
        return eo_nb + self.mur[B][sB] * (en_nb - Eo[m][x])

    def near(self, layout, c, side):
        """Whether the resident form's z fix of cell c finds its neighbour
        (c + 1 for the low wall, c − 1 for the high one) in the next or
        previous lane of its warp: ``layout`` is (blocks, threads)."""
        blocks, threads = layout
        cells = int(np.prod(self.n))
        per_block = -(-cells // blocks)
        first = c // per_block * per_block
        lane = (c - first) % threads % 32
        if side == 0:
            return lane < 31 and c + 1 < min(first + per_block, cells)
        return lane > 0

    def e_pass(self, Eo, H, psi_e, s, layout=None, paths=None):
        """The E pass: each cell's final E written once into a new array
        from H, the old E and recomputed neighbours, never read back;
        with ``layout``, as the resident form runs it, the Ex and Ey of a
        z wall cell whose neighbour is the next or previous lane's take
        that neighbour's final value (read once it is final) instead.
        ``paths`` counts the z fixes by route."""
        own = self.e_own(Eo, H, psi_e, s)
        En = [np.full(self.n, np.nan, f32) for _ in range(3)]
        on_wall = np.zeros(self.n, bool)
        if self.mur is not None:
            for b in range(3):
                for w in (self.lo[b], self.hi[b]):
                    if 0 <= w < self.n[b]:
                        on_wall[(slice(None),) * b + (w,)] = True
        deferred = []
        for m in range(3):
            En[m][~on_wall] = own[m][~on_wall]
            for x in zip(*np.nonzero(on_wall)):
                tangential = any(
                    x[b] in (self.lo[b], self.hi[b]) for b in range(3) if b != m)
                if layout is not None and m < 2 and x[2] in (self.lo[2], self.hi[2]):
                    deferred.append((m, x))
                    continue
                En[m][x] = (self.mur_fix(Eo, H, m, x, s) if tangential
                            else own[m][x])
        for m, x in deferred:  # every other cell is final by now
            side = 0 if x[2] == self.lo[2] else 1
            c = int(np.ravel_multi_index(x, self.n))
            if self.near(layout, c, side):
                nb = (x[0], x[1], x[2] + (1 if side == 0 else -1))
                En[m][x] = Eo[m][nb] + self.mur[2][side] * (En[m][nb] - Eo[m][x])
                route = "lane"
            else:
                En[m][x] = self.mur_fix(Eo, H, m, x, s)
                route = "recomputed"
            if paths is not None:
                paths[route] = paths.get(route, 0) + 1
        return En


def emulate_steps(ops: YeeOperands, st, wf, x_walls, layout=None, paths=None):
    """The kernels' steps from ``st`` in NumPy; returns (E, H, ψ_e, ψ_h).
    ``layout`` None: the streamed form; (blocks, threads): the resident
    form's z fixes by warp shuffle."""
    kern = _Kernel(ops, x_walls)
    E = [_np(e) for e in st.e[st.parity]]
    H = [_np(h) for h in st.h]
    psi_e = [_np(p) for p in st.psi_e]
    psi_h = [_np(p) for p in st.psi_h]
    for s in wf:
        kern.h_pass(E, H, psi_h)
        E = kern.e_pass(E, H, psi_e, s, layout, paths)
    return E, H, psi_e, psi_h


def _assert_state_equals(st, got, rows=slice(None)):
    E, H, psi_e, psi_h = got
    ref = (*st.e[st.parity], *st.h, *st.psi_e, *st.psi_h)
    for i, (a, b) in enumerate(zip((*E, *H, *psi_e, *psi_h), ref, strict=True)):
        assert not np.isnan(a).any(), f"array {i}: a cell was never written"
        np.testing.assert_array_equal(a[rows], b.numpy()[rows],
                                      err_msg=f"array {i}")


# ---------------------------------------------------------------------------
# synthetic operands: every edge and corner case on a few hundred cells
# ---------------------------------------------------------------------------

def _operands(shape, grid_shape, boundary, seed, x_rows=None):
    """Random coefficients, profiles and MUR coefficients on ``shape``;
    the source on Ez and Ex only."""
    rng = np.random.default_rng(seed)

    def arr(*s, lo=-1.0, hi=1.0):
        return torch.from_numpy(rng.uniform(lo, hi, s).astype(f32))

    pml = mur = None
    if boundary == "MUR":
        mur = tuple((float(f32(rng.uniform(-0.9, 0.9))),
                     float(f32(rng.uniform(-0.9, 0.9)))) for _ in range(3))
    elif boundary == "PML_4":
        pml = {k: tuple(arr(n, lo=0.0) for n in shape)
               for k in ("bh", "ch", "be", "ce")}
    return YeeOperands(
        shape=tuple(shape), grid_shape=tuple(grid_shape),
        dtmu=float(f32(rng.uniform(0.1, 0.5))),
        inv_p=tuple(arr(n, lo=0.2) for n in shape),
        inv_d=tuple(arr(n, lo=0.2) for n in shape),
        ca=tuple(arr(*shape, lo=0.5) for _ in range(3)),
        cb=tuple(arr(*shape) for _ in range(3)),
        src=(arr(*shape), None, arr(*shape)),
        mur=mur, pml=pml,
        probes=fdtd_cuda.ProbeTable.empty(),
        mur_x_rows=x_rows,
    )


def _random_state(shape, pml, seed):
    rng = np.random.default_rng(seed)
    st = fdtd_cuda.new_state(shape, "cpu", pml)
    for t in (*st.e[0], *st.e[1], *st.h, *st.psi_e, *st.psi_h):
        t.copy_(torch.from_numpy(rng.standard_normal(t.shape).astype(f32)))
    return st


# whole grids: (array shape, grid shape); padded past the grid on x and y,
# and grids with one interior plane (q = 3) on x and z
GRIDS = [((7, 6, 5), (6, 5, 5)), ((4, 9, 3), (3, 8, 3)), ((5, 3, 6), (5, 3, 4))]


# (blocks, threads) of the resident form's z fixes; None: the streamed form
LAYOUTS = [None, (3, 64), (2, 32)]


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("shape,grid_shape", GRIDS)
@pytest.mark.parametrize("boundary", ["MUR", "PEC"])
def test_interval_schedule_equals_the_twin(shape, grid_shape, boundary, layout):
    ops = _operands(shape, grid_shape, boundary, seed=sum(shape))
    st = _random_state(shape, False, seed=3)
    wf = [0.37, -0.21, 0.55]
    paths = {}
    got = emulate_steps(ops, st, wf, (0, grid_shape[0] - 1), layout, paths)
    fdtd_steps.interval_steps_plain(ops, st, wf)
    _assert_state_equals(st, got)
    if layout is not None and boundary == "MUR":
        assert paths.get("lane", 0) > 0, paths


@pytest.mark.parametrize("layout", LAYOUTS[1:])
def test_z_fixes_take_both_routes(layout):
    """Some z wall cells find their neighbour in the next or previous lane,
    others (at a warp's or block's edge) recompute it."""
    shape, grid_shape = GRIDS[0]
    ops = _operands(shape, grid_shape, "MUR", seed=1)
    st = _random_state(shape, False, seed=2)
    paths = {}
    got = emulate_steps(ops, st, [0.5], (0, grid_shape[0] - 1), layout, paths)
    fdtd_steps.interval_steps_plain(ops, st, [0.5])
    _assert_state_equals(st, got)
    assert paths.get("lane", 0) > 0 and paths.get("recomputed", 0) > 0, paths


# slab x walls (global rows 0 and Qx − 1 as slab rows) on a 6-row slab:
# both inside, on both edges, one outside either way, a lower wall on the
# last row and an upper wall on the first (the straddle slab), both
# outside; a neighbour outside the slab reads 0
X_WALLS = [(1, 4), (0, 5), (-3, 2), (3, 8), (5, 10), (-4, 0), (-10, -5)]


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("x_walls", X_WALLS)
def test_shard_schedule_equals_the_twin_under_mur(x_walls, layout):
    shape = (6, 5, 4)
    ops = _operands(shape, (x_walls[1] - x_walls[0] + 1, 5, 4), "MUR",
                    seed=20 + x_walls[0], x_rows=x_walls)
    st = _random_state(shape, False, seed=5)
    wf = [0.4, -0.3, 0.2]
    got = emulate_steps(ops, st, wf, x_walls, layout)
    fdtd_shard.shard_steps_plain(ops, st, wf)
    _assert_state_equals(st, got)


@pytest.mark.parametrize("boundary", ["PEC", "PML_4"])
@pytest.mark.parametrize("x_walls", [(1, 4), (-4, 0)])
def test_shard_schedule_equals_the_twin_without_walls(boundary, x_walls):
    shape = (6, 5, 4)
    ops = _operands(shape, (x_walls[1] - x_walls[0] + 1, 5, 4), boundary,
                    seed=11, x_rows=x_walls)
    st = _random_state(shape, boundary == "PML_4", seed=13)
    wf = [0.1, 0.7]
    got = emulate_steps(ops, st, wf, x_walls)
    fdtd_shard.shard_steps_plain(ops, st, wf)
    _assert_state_equals(st, got)


# ---------------------------------------------------------------------------
# the operands the port builds: whole grids and x-slabs of real scenes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("boundary", ["MUR", "PEC"])
def test_interval_schedule_on_a_scene(boundary):
    sim = port_sim("straddle", boundary, 1)
    ops = sim.operands
    st = _random_state(sim.padded_shape, False, seed=17)
    wf = [0.3, -0.6, 0.9, 0.2]
    got = emulate_steps(ops, st, wf, (0, sim.grid.shape[0] - 1), (7, 640))
    fdtd_steps.interval_steps_plain(ops, st, wf)
    _assert_state_equals(st, got)


@pytest.mark.parametrize("kind,boundary,n_dev,rank", [
    ("straddle", "MUR", 4, 3),   # the top wall on the first owned row
    ("straddle", "MUR", 4, 0),   # the bottom wall inside, the top outside
    ("straddle", "MUR", 4, 2),
    ("straddle", "PEC", 4, 1),
    ("small", "PML_4", 2, 1),
    ("small", "MUR", 1, 0),      # one rank: both walls inside the slab
])
def test_shard_schedule_on_a_slab(kind, boundary, n_dev, rank):
    sim = port_sim(kind, boundary, n_dev, decim=4)
    sh = fdtd_shard.build_shard_stepper(sim, n_dev, rank)
    st = _random_state(sh.ops.shape, boundary == "PML_4", seed=19 + rank)
    wf = [0.5, -0.25, 0.125][:min(3, sh.K)]
    got = emulate_steps(sh.ops, st, wf, sh.ops.mur_x_rows, (3, 1024))
    fdtd_shard.shard_steps_plain(sh.ops, st, wf)
    _assert_state_equals(st, got, rows=sh.owned)


# ---------------------------------------------------------------------------
# the walk's fused E half-step (e_update_mur_kernel, one thread a cell)
# ---------------------------------------------------------------------------

def emulate_e_update_mur(ops: YeeOperands, st, s, paths=None):
    """``e_update_mur_kernel`` in NumPy: the E pass above on one thread a
    cell in flat order (lane c mod 32, whatever the block's size),
    so a z wall cell takes its neighbour's values from the next lane
    (low wall) unless it is lane 31 or the last cell, or from the previous
    lane (high wall) unless it is lane 0; its walls at
    ``ops.mur_walls(axis)`` for x, y and z. Returns (new E, ψ_e)."""
    kern = _Kernel(ops, ops.mur_walls(0))
    kern.lo, kern.hi = (tuple(ops.mur_walls(b)[side] for b in range(3))
                        for side in (0, 1))
    E = [_np(e) for e in st.e[st.parity]]
    H = [_np(h) for h in st.h]
    psi_e = [_np(p) for p in st.psi_e]
    return kern.e_pass(E, H, psi_e, s, (1, 32), paths), psi_e


def _assert_e_update_mur(ops, st, s):
    """The emulated kernel == ``e_update_mur_plain`` on every cell of the
    new E (and ψ_e); returns the z fixes by route."""
    paths = {}
    got, psi_e = emulate_e_update_mur(ops, st, s, paths)
    fdtd_cuda.e_update_mur_plain(ops, st, s)
    for i, (a, b) in enumerate(zip((*got, *psi_e),
                                   (*st.e[1 - st.parity], *st.psi_e),
                                   strict=True)):
        assert not np.isnan(a).any(), f"array {i}: a cell was never written"
        np.testing.assert_array_equal(a, b.numpy(), err_msg=f"array {i}")
    return paths


@pytest.mark.parametrize("x_walls", X_WALLS)
@pytest.mark.parametrize("shape", [(6, 5, 4), (6, 3, 11)])
def test_e_update_mur_schedule_on_synthetic_slabs(shape, x_walls):
    """Slab x walls inside, on either edge and outside, on a grid whose
    z lines (11) put wall cells on both sides of lane edges."""
    ops = _operands(shape, (x_walls[1] - x_walls[0] + 1, *shape[1:]), "MUR",
                    seed=31 + x_walls[0], x_rows=x_walls)
    paths = _assert_e_update_mur(ops, _random_state(shape, False, seed=7), 0.45)
    assert paths.get("lane", 0) > 0, paths
    if shape[2] == 11:  # cell 32 = (0, 2, 10), a high z wall on lane 0
        assert paths.get("recomputed", 0) > 0, paths


@pytest.mark.parametrize("boundary", ["PEC", "PML_4"])
def test_e_update_mur_without_walls_is_e_update(boundary):
    shape = (5, 4, 6)
    ops = _operands(shape, shape, boundary, seed=5)
    paths = _assert_e_update_mur(ops, _random_state(shape, boundary == "PML_4",
                                                    seed=9), -0.3)
    assert paths == {}


@pytest.mark.parametrize("kind,n_dev,coords", [
    ("straddle", 4, (3, 0)),         # the top x wall on the first owned row
    ("straddle", 4, (2, 0)),         # the top x wall on the upper halo row
    ("small", 1, (0, 0)),            # one rank: every wall inside
    ("small", 3, (0, 0)),            # a 3-rank x split: the bottom x wall,
    ("small", 3, (1, 0)),            # no x wall,
    ("small", 3, (2, 0)),            # the top x wall
    ("small", (2, 3, 1), (1, 2)),    # an x-y block: the top x and y walls
    ("ystraddle", (1, 4, 1), (0, 3)),  # the top y wall on the first plane
])
def test_e_update_mur_schedule_on_walk_blocks(kind, n_dev, coords):
    sim = port_sim(kind, "MUR", n_dev)
    sx, sy = (n_dev, 1) if isinstance(n_dev, int) else n_dev[:2]
    Px, Py, _ = sim.padded_shape
    cx, cy = coords
    ops = fdtd_shard.slab_operands(sim, cx, Px // sx, 1, "cpu",
                                   y=(cy, Py // sy, 1) if sy > 1 else None)
    paths = _assert_e_update_mur(ops, _random_state(ops.shape, False, seed=3),
                                 0.8)
    assert paths.get("lane", 0) > 0, paths


# ---------------------------------------------------------------------------
# the build names a library by its sources, headers included
# ---------------------------------------------------------------------------

def test_an_edited_header_changes_the_library_tag(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    users = ("fdtd_steps", "fdtd_shard", "fdtd_chunk")
    gather = {"fdtd_chunk": ["probe_rows.cuh"]}  # the probe table's header
    for name in users:
        assert [p.name for p in _build.sources(name)] == [
            f"{name}.cu", *gather.get(name, []), "yee_persist.cuh"]
    assert [p.name for p in _build.sources("fdtd_chunk_march")] == [
        "fdtd_chunk_march.cu", "probe_rows.cuh"]
    before = {n: _build.tag(n) for n in (*users, "roll_chain", "fdtd_chunk_march")}
    header = csrc / "yee_persist.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: _build.tag(n) for n in before}
    for name in users:
        assert after[name] != before[name], name
    assert after["roll_chain"] == before["roll_chain"]
    assert after["fdtd_chunk_march"] == before["fdtd_chunk_march"]
    probe = csrc / "probe_rows.cuh"
    probe.write_text(probe.read_text() + "\n// edited\n")
    again = {n: _build.tag(n) for n in before}
    for name in ("fdtd_chunk", "fdtd_chunk_march"):
        assert again[name] != after[name], name
    for name in ("fdtd_steps", "fdtd_shard", "roll_chain"):
        assert again[name] == after[name], name


def test_the_tag_follows_every_source_and_the_flags(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    first = _build.tag("fdtd_shard")
    assert _build.tag("fdtd_shard") == first  # deterministic
    src = csrc / "fdtd_shard.cu"
    src.write_text(src.read_text() + "\n")
    second = _build.tag("fdtd_shard")
    assert second != first
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-lineinfo",))
    assert _build.tag("fdtd_shard") != second
