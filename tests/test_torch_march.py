"""The stream march's plan (``fdtd_stream.march_plan``) and its schedule, on the CPU.

The march (``march_kernel`` in ``csrc/fdtd_stream.cu``) carries stream
mode under MUR and PEC walls: each block owns a y–z tile of one x segment
and marches along x with T time levels of a few planes in shared memory.
The kernel itself runs only on the card (``tests/test_torch_cuda.py``
holds it to its twin there). Here the plan is checked on its own terms
(every core cell of every plane written by exactly one block, no core or
segment a lone wall plane, shared memory within the card's limit, the
mixed scene filling the card) and the kernel's schedule, transcribed
step for step into NumPy (:func:`emulate_march`), is held to the plain
twin ``stream_steps_plain`` bit for bit: the same planes, levels, boxes,
ring slots, deferred lower wall and held-over upper wall, on grids cut
into several tiles and segments.
"""

import itertools

import numpy as np
import pytest
import torch

from fdtd_solver_antennas_tpu_torch.models.scene import Scene
from fdtd_solver_antennas_tpu_torch.ops import fdtd_cuda, fdtd_shard, fdtd_stream
from fdtd_solver_antennas_tpu_torch.ops.fdtd import FDTDConfig, build_simulation
from fdtd_solver_antennas_tpu_torch.ops.mesh import MeshBuilder

MIXED = (141, 201, 152)  # the 4.2M-cell mixed patch+horn scene
TALL = (161, 121, 160)  # the tall patch
SHAPES = [MIXED, TALL, (56, 55, 50), (19, 17, 13), (33, 49, 17), (161, 121, 131)]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Test workers share the cores (pytest-xdist)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pieces(n, length, origin, count):
    return [(max(0, b * length - origin), min(n, (b + 1) * length - origin))
            for b in range(count)]


def _blocks(shape, grid_shape, T, mur, pml=False):
    core, origin, tiles, (seg, so, segs), smem = fdtd_stream.march_plan(
        shape, grid_shape, T, mur, pml=pml)
    xs = _pieces(shape[0], seg, so, segs)
    ys = _pieces(shape[1], core[0], origin[0], tiles[0])
    zs = _pieces(shape[2], core[1], origin[1], tiles[1])
    return xs, ys, zs, smem


KINDS = [(True, False), (False, False), (False, True)]  # MUR, PEC, CPML


def _max_Ts():
    for shape, (mur, pml) in itertools.product(SHAPES, KINDS):
        for T in range(1, fdtd_stream.max_T(shape, mur, pml) + 1):
            yield shape, mur, pml, T


@pytest.mark.parametrize("shape,mur,pml,T", list(_max_Ts()))
def test_plan_covers_every_core_cell_once(shape, mur, pml, T):
    xs, ys, zs, _ = _blocks(shape, shape, T, mur, pml)
    count = np.zeros(shape, np.int32)
    for (x0, x1), (y0, y1), (z0, z1) in itertools.product(xs, ys, zs):
        count[x0:x1, y0:y1, z0:z1] += 1
    assert (count == 1).all()


@pytest.mark.parametrize("shape", SHAPES + [(17, 33, 49), (35, 18, 65)])
@pytest.mark.parametrize("grid_pad", [0, 3])
def test_plan_leaves_no_lone_wall_plane(shape, grid_pad):
    """Under MUR no core (y, z) and no segment (x) is the lone wall plane
    q − 1 or the lone plane 0, also where the array is padded past the
    grid."""
    grid = tuple(n - grid_pad for n in shape)
    xs, ys, zs, _ = _blocks(shape, grid, 4, True)
    for pieces, q in zip((xs, ys, zs), grid):
        for a, b in pieces:
            assert b - a >= 1
            assert (a, b) != (q - 1, q) and (a, b) != (0, 1)


@pytest.mark.parametrize("mur,pml", KINDS)
def test_plan_shared_memory_fits_every_T_max_T_allows(mur, pml):
    for shape, m, p, T in _max_Ts():
        if (m, p) == (mur, pml):
            *_, smem = fdtd_stream.march_plan(shape, shape, T, mur, pml=pml)
            assert smem <= fdtd_stream.SMEM_LIMIT, (shape, mur, pml, T)
    # the depths the engine picks at the large grids: 4 under MUR and
    # CPML, 5 under PEC; two blocks an SM under MUR and PEC (two 1 KB
    # reserves), one under CPML, whose ψ slots take 12 T floats a cell
    T = 5 if not (mur or pml) else 4
    for shape in (MIXED, TALL, (100, 109, 50)):
        assert fdtd_stream.max_T(shape, mur, pml) == T
        smem = fdtd_stream.march_plan(shape, shape, T, mur, pml=pml)[4]
        blocks_per_sm = 233_472 // (smem + 1024)
        assert blocks_per_sm == (1 if pml else 2), (shape, smem)
        assert fdtd_stream.march_blocks(pml) == blocks_per_sm * 132
    floats = {(True, False): 44, (False, False): 42, (False, True): 84}
    assert fdtd_stream.march_plan(MIXED, MIXED, T, mur, pml=pml)[4] == (
        24 * 24 * 4 * floats[mur, pml])


@pytest.mark.parametrize("pml", [False, True])
def test_mixed_scene_fills_the_card(pml):
    """Under MUR two segments of 130 tiles fill the 264 two-a-SM slots;
    under CPML one segment of 130 blocks takes 130 of the 132 SMs."""
    core, origin, tiles, (seg, so, segs), _ = fdtd_stream.march_plan(
        MIXED, MIXED, 4, not pml, pml=pml)
    assert tiles == (13, 10) and segs == (1 if pml else 2)
    blocks = tiles[0] * tiles[1] * segs
    assert 0.98 * fdtd_stream.march_blocks(pml) <= blocks <= fdtd_stream.march_blocks(pml)
    assert fdtd_stream.march_plan(TALL, TALL, 4, not pml, pml=pml)[2:4] == (
        (8, 10), (54, 0, 3))


def test_plan_refuses_what_does_not_fit():
    with pytest.raises(ValueError, match="march takes no T=8"):
        fdtd_stream.march_plan(MIXED, MIXED, 8, True)


# ---------------------------------------------------------------------------
# the kernel's schedule in NumPy
# ---------------------------------------------------------------------------

def _np(t):
    return None if t is None else t.numpy()


def emulate_march(ops, st, wf, blocks=None, batch=1):
    """``march_kernel`` of ``csrc/fdtd_stream.cu`` block by block, in
    float32 with the kernel's order of operations, on the rows
    ``[v0, m)`` the host launches it on (``fdtd_stream.march_view``: a
    slab's walls), cut as ``march_plan`` cuts it for ``blocks`` resident
    blocks (default ``march_blocks``) over ``batch`` variants. Under CPML
    each cell's ψ moves through T thread-private slots (level 1 from the
    registers loaded the iteration before, level T to the other set), and
    a ψ in its axis's ``flat_runs`` run is skipped. Returns the new E3, H3
    and, under CPML, ψ_e6 and ψ_h6; cells no block writes stay NaN (a
    skipped ψ, 0: the other set starts at 0 there)."""
    v0, x_lo, x_hi = fdtd_stream.march_view(ops)
    n0, n1, n2 = ops.shape
    n0 -= v0
    q1, q2 = ops.grid_shape[1:]
    T = len(wf)
    mur = ops.mur is not None
    pml = ops.pml is not None
    f32 = np.float32
    core, origin, tiles, (seg, so, segs), _ = fdtd_stream.march_plan(
        (n0, n1, n2), ops.grid_shape, T, mur, x_hi, blocks, batch, pml)

    def view(t):
        return None if t is None else _np(t)[v0:]

    E_in = [view(e) for e in st.e[st.parity]]
    H_in = [view(h) for h in st.h]
    ca, cb, src = ([view(a) for a in arr] for arr in (ops.ca, ops.cb, ops.src))
    ip = [view(ops.inv_p[0]), *(_np(a) for a in ops.inv_p[1:])]
    idd = [view(ops.inv_d[0]), *(_np(a) for a in ops.inv_d[1:])]
    dtmu = f32(ops.dtmu)
    mc = [[f32(c) for c in pair] for pair in ops.mur] if mur else None
    E_all = [np.full(ops.shape, np.nan, f32) for _ in range(3)]
    H_all = [np.full(ops.shape, np.nan, f32) for _ in range(3)]
    E_out, H_out = [e[v0:] for e in E_all], [h[v0:] for h in H_all]
    R = T + 2
    if pml:  # no walls: v0 is 0
        psi_in = [_np(p) for p in (*st.psi_e, *st.psi_h)]  # ψ_e 0..5, ψ_h 6..11
        keep = [k.numpy() for k in fdtd_stream.psi_slabs(ops)]
        psi_out = [np.where(k, np.nan, 0).astype(f32) * np.ones(ops.shape, f32)
                   for k in keep]
        runs = fdtd_stream.flat_runs(ops.pml)
        prof = {key: [_np(a) for a in ops.pml[key]] for key in ("bh", "ch", "be", "ce")}

    def shift(a, axis, d):
        """a[i + d] along ``axis`` (d = ±1), 0 past the region."""
        out = np.zeros_like(a)
        src_ = [slice(None)] * a.ndim
        dst = [slice(None)] * a.ndim
        if d > 0:
            src_[axis], dst[axis] = slice(1, None), slice(0, -1)
        else:
            src_[axis], dst[axis] = slice(0, -1), slice(1, None)
        out[tuple(dst)] = a[tuple(src_)]
        return out

    for sg, by, bz in itertools.product(range(segs), range(tiles[0]), range(tiles[1])):
        cy0, cy1 = max(0, by * core[0] - origin[0]), min(n1, (by + 1) * core[0] - origin[0])
        cz0, cz1 = max(0, bz * core[1] - origin[1]), min(n2, (bz + 1) * core[1] - origin[1])
        x0, x1 = max(0, sg * seg - so), min(n0, (sg + 1) * seg - so)
        if cy0 >= cy1 or cz0 >= cz1 or x0 >= x1:
            continue
        ry, rz = max(0, cy0 - T), max(0, cz0 - T)
        Ly, Lz = min(n1, cy1 + T) - ry, min(n2, cz1 + T) - rz
        sy, sz = slice(ry, ry + Ly), slice(rz, rz + Lz)
        Er = np.zeros((R, 3, Ly, Lz), f32)
        Hr = np.zeros((R, 3, Ly, Lz), f32)
        O = np.zeros((2, 3, Ly, Lz), f32)
        W = np.zeros((2, Ly, Lz), f32)
        gy = ry + np.arange(Ly)[:, None]
        gz = rz + np.arange(Lz)[None, :]
        ipy, ipz = ip[1][sy][:, None], ip[2][sz][None, :]
        idy, idz = idd[1][sy][:, None], idd[2][sz][None, :]
        core_m = (gy >= cy0) & (gy < cy1) & (gz >= cz0) & (gz < cz1)
        if pml:
            Ps = np.zeros((T, 12, Ly, Lz), f32)  # each cell's T slots
            pin = np.zeros((12, Ly, Lz), f32)  # level 1's ψ, loaded ahead

            def on(side, ax, x):
                """Whether side's ψ of derivative axis ``ax`` can change."""
                lo, hi = runs[side][ax]
                i = (x, gy, gz)[ax]
                return (i < lo) | (i >= hi)

            def bc(side, ax, x):
                b, c = (prof["bh"], prof["ch"]) if side == 0 else (prof["be"], prof["ce"])
                if ax == 0:
                    return b[0][x], c[0][x]
                sl = sy if ax == 1 else sz
                shp = (-1, 1) if ax == 1 else (1, -1)
                return b[ax][sl].reshape(shp), c[ax][sl].reshape(shp)

            def psi_level(side, x, t, d, act, write):
                """One side's ψ at level t of plane x (side 0: H, slots
                6..11; 1: E, slots 0..5), stored as the kernel stores it;
                returns the six ψ, 0 where skipped."""
                off = 6 if side == 0 else 0
                out = []
                for m, ax in enumerate(fdtd_stream.PSI_AXIS):
                    o = on(side, ax, x) & act
                    b, c = bc(side, ax, x)
                    old = pin[off + m] if t == 1 else Ps[x % T, off + m]
                    new = np.where(o, b * old + c * d[m], f32(0)).astype(f32)
                    if t < T:
                        Ps[x % T, off + m][o] = new[o]
                    else:
                        w = o & write
                        psi_out[off + m][x, sy, sz][w] = new[w]
                    out.append(new)
                return out

        def dh(H, Hm, idx_):
            """Backward differences of H in ψ order."""
            hx, hy, hz = H
            hz_xm = Hm[2] if Hm is not None else np.zeros_like(hz)
            hy_xm = Hm[1] if Hm is not None else np.zeros_like(hy)
            return ((hz - shift(hz, 0, -1)) * idy, (hy - shift(hy, 1, -1)) * idz,
                    (hx - shift(hx, 1, -1)) * idz, (hz - hz_xm) * idx_,
                    (hy - hy_xm) * idx_, (hx - shift(hx, 0, -1)) * idy)

        def curl(d, p=None):
            if p is None:
                return d[0] - d[1], d[2] - d[3], d[4] - d[5]
            return ((d[0] + p[0]) - (d[1] + p[1]), (d[2] + p[2]) - (d[3] + p[3]),
                    (d[4] + p[4]) - (d[5] + p[5]))

        def e_cell(E, x, cu, s):
            g = (x, sy, sz)
            v = []
            for m in range(3):
                val = ca[m][g] * E[m] + cb[m][g] * cu[m]
                if src[m] is not None:
                    val = val + src[m][g] * f32(s)
                v.append(val)
            return v

        def fix(E, Oo, act, axis, side, coef, comps):
            """MUR on the wall rows (axis 0 = y, 1 = z) of one plane."""
            g, L = (gy, Ly) if axis == 0 else (gz, Lz)
            wall = 0 if side == 0 else (q1 if axis == 0 else q2) - 1
            lw = wall - (ry if axis == 0 else rz)
            ln = lw + (1 if side == 0 else -1)
            if not (0 <= lw < L and 0 <= ln < L):
                return
            sel = (lambda a, i: a[i, :]) if axis == 0 else (lambda a, i: a[:, i])
            rows = sel(act, lw)
            for m in comps:
                new = sel(Oo[m], ln) + coef * (sel(E[m], ln) - sel(Oo[m], lw))
                sel(E[m], lw)[rows] = new[rows]

        xs_, xl = max(0, x0 - T), min(n0, x1 + T)
        for p in range(xs_, x1 + T):
            if p < xl:
                for m in range(3):
                    Er[p % R, m] = E_in[m][p, sy, sz]
                    Hr[p % R, m] = H_in[m][p, sy, sz]
            for t in range(1, T + 1):
                x = p - t
                lo = max(0, x0 - T + t - 1)
                if x < lo or x >= min(n0, x1 + T - t):
                    continue
                s = wf[t - 1]
                E, H = Er[x % R], Hr[x % R]
                Hm = Hr[(x - 1) % R] if x > 0 else None
                act = ((gy >= max(cy0 - T + t - 1, ry)) & (gy < min(cy1 + T - t, ry + Ly))
                       & (gz >= max(cz0 - T + t - 1, rz)) & (gz < min(cz1 + T - t, rz + Lz)))
                defer0 = mur and x_lo and x == 0
                with0 = mur and x_lo and x == 1 and lo == 0
                # H
                ex, ey, ez = E
                Ep = Er[(x + 1) % R] if x + 1 < n0 else np.zeros_like(E)
                ipx = ip[0][x]
                d = ((shift(ez, 0, 1) - ez) * ipy, (shift(ey, 1, 1) - ey) * ipz,
                     (shift(ex, 1, 1) - ex) * ipz, (Ep[2] - ez) * ipx,
                     (Ep[1] - ey) * ipx, (shift(ex, 0, 1) - ex) * ipy)
                write = core_m & (x0 <= x < x1)
                ps = psi_level(0, x, t, d, act, write) if pml else None
                for m, cu in enumerate(curl(d, ps)):
                    H[m][act] = (H[m] - dtmu * cu)[act]
                # E
                if not defer0:
                    Ox = O[x & 1]
                    d = dh(H, Hm, idd[0][x])
                    cu = curl(d, psi_level(1, x, t, d, act, write) if pml else None)
                    old = E.copy()
                    v = e_cell(old, x, cu, s)
                    if mur:
                        Ox[:, act] = old[:, act]
                    E[0][act] = v[0][act]
                    if mur and x == x_hi:
                        E[1][act], E[2][act] = W[0][act], W[1][act]
                    else:
                        E[1][act], E[2][act] = v[1][act], v[2][act]
                    if mur and x == x_hi - 1:
                        Ew = Er[(x + 1) % R]
                        cx = mc[0][1]
                        W[0][act] = (Ox[1] + cx * (v[1] - Ew[1]))[act]
                        W[1][act] = (Ox[2] + cx * (v[2] - Ew[2]))[act]
                    if with0:
                        E0 = Er[0]
                        cu0 = curl(dh(Hr[0], None, idd[0][0]))
                        old0 = E0.copy()
                        v0 = e_cell(old0, 0, cu0, s)
                        O[0][:, act] = old0[:, act]
                        cx = mc[0][0]
                        E0[0][act] = v0[0][act]
                        E0[1][act] = (Ox[1] + cx * (v[1] - O[0][1]))[act]
                        E0[2][act] = (Ox[2] + cx * (v[2] - O[0][2]))[act]
                if mur:
                    for axis, comps in ((0, (0, 2)), (1, (0, 1))):
                        for side in (0, 1):
                            coef = mc[axis + 1][side]
                            if not defer0:
                                fix(E, O[x & 1], act, axis, side, coef, comps)
                            if with0:
                                fix(Er[0], O[0], act, axis, side, coef, comps)
                if t == T:
                    planes = []
                    if not defer0 and x0 <= x < x1:
                        planes.append(x)
                    if with0 and x0 == 0:
                        planes.append(0)
                    for px in planes:
                        for m in range(3):
                            E_out[m][px, sy, sz][core_m] = Er[px % R, m][core_m]
                            H_out[m][px, sy, sz][core_m] = Hr[px % R, m][core_m]
            if pml and p < xl:  # plane p's ψ, for its level 1 next iteration
                for m, ax in enumerate(fdtd_stream.PSI_AXIS):
                    for side, off in ((0, 6), (1, 0)):
                        pin[off + m] = np.where(on(side, ax, p),
                                                psi_in[off + m][p, sy, sz], f32(0))
    return (*E_all, *H_all, *(psi_out if pml else ()))


def _sim(boundary, tall=False):
    """The scene of tests/test_stream_kernel.py (``tall``: 131 z lines;
    under CPML the wider footprint and finer mesh of its PML cases)."""
    pml = boundary.startswith("PML")
    span = 52 if pml else 40
    mb = MeshBuilder()
    mb.add_line("x", [-span, span, 0.0, -6.0])
    mb.add_line("y", [-span * 0.75, span * 0.75, 0.0])
    if tall:
        mb.add_line("z", np.linspace(-20, 30, 131))
    else:
        mb.add_line("z", [-20, 30])
        mb.add_line("z", np.linspace(0, 1.6, 3))
    grid = mb.build(4.0 if pml else 5.0)
    scene = Scene()
    scene.add_material_box("sub", 4.3, 0.005, [-20, -20, 0], [20, 20, 1.6], 0)
    scene.add_metal_box("patch", [-15, -12, 1.6], [15, 12, 1.6], priority=10)
    scene.add_metal_box("gnd", [-20, -20, 0], [20, 20, 0], priority=10)
    scene.add_lumped_port(1, 50.0, [-6, 0, 0], [-6, 0, 1.6], direction="z")
    cfg = FDTDConfig(n_steps_max=40, check_every=40, end_criteria=1e-30,
                     boundary=boundary, probe_decimation=4)
    return build_simulation(scene, grid, f0=2.45e9, fc=1.225e9, cfg=cfg,
                            device="cpu", port_freqs_hz=np.linspace(2e9, 3e9, 5),
                            nf_freqs_hz=np.array([2.45e9]))


def _random_state(shape, seed, ops=None):
    """Random E and H; with CPML ``ops`` random ψ too, each 0 outside its
    slab (``fdtd_stream.psi_slabs``), as a run leaves it."""
    rng = np.random.default_rng(seed)
    pml = ops is not None and ops.pml is not None
    st = fdtd_cuda.new_state(shape, "cpu", pml=pml)
    for t in (*st.e[0], *st.e[1], *st.h, *st.psi_e, *st.psi_h):
        t.copy_(torch.from_numpy(rng.standard_normal(t.shape).astype(np.float32)))
    if pml:
        for t, keep in zip((*st.psi_e, *st.psi_h), fdtd_stream.psi_slabs(ops)):
            t.masked_fill_(~keep, 0.0)
    return st


def _core_key(boundary):
    return "pml" if boundary.startswith("PML") else boundary.lower()


def _assert_equal(got, st):
    """The emulated arrays against the state's E, H (and ψ), bit for bit."""
    for a, ref in zip(got, (*st.fields, *st.psi_e, *st.psi_h), strict=True):
        np.testing.assert_array_equal(a, ref.numpy())


def _straddles(n, core, origin, tiles, run):
    """Whether a core of the cut [b·core − origin, …) holds cells on both
    sides of an edge of a flat run (``run``: the runs' edges)."""
    return any(a < e < b for a, b in _pieces(n, core, origin, tiles)
               for e in run if 0 < e < n)


@pytest.mark.parametrize("boundary,tall,T,core", [
    ("MUR", False, 1, (5, 4)), ("MUR", False, 2, (6, 5)),
    ("MUR", False, 3, (4, 6)), ("MUR", False, 4, (5, 4)),
    ("PEC", False, 2, (5, 4)), ("PEC", False, 5, (6, 5)),
    ("MUR", True, 4, (16, 16)), ("PEC", True, 3, (14, 14)),
    ("PML_4", False, 1, (5, 4)), ("PML_4", False, 2, (6, 5)),
    ("PML_4", False, 3, (4, 6)), ("PML_4", False, 4, (5, 4)),
    ("PML_4", True, 4, (16, 16)),
])
def test_schedule_equals_the_plain_twin(monkeypatch, boundary, tall, T, core):
    """The kernel's schedule against T plain leapfrog steps on a random
    state, bit for bit, with small cores so that the grid is cut into
    several tiles per axis and several x segments (lone-plane shifts
    included where the shapes give them). Under CPML the ψ too, with
    slabs that straddle a tile's edge in y and z."""
    monkeypatch.setitem(fdtd_stream._MARCH_CORE, _core_key(boundary), core)
    sim = _sim(boundary, tall)
    ops = sim.operands
    pml = ops.pml is not None
    shape = tuple(ops.shape)
    _, origin, tiles, (seg, so, segs), _ = fdtd_stream.march_plan(
        shape, ops.grid_shape, T, boundary == "MUR", pml=pml)
    assert segs >= 2 and tiles[1] >= 2 and (tall or tiles[0] >= 2)
    if pml and not tall:
        runs = fdtd_stream.flat_runs(ops.pml)
        for ax in (1, 2):
            assert _straddles(shape[ax], core[ax - 1], origin[ax - 1],
                              tiles[ax - 1], runs[0][ax] + runs[1][ax])
    st = _random_state(shape, 17 + T, ops)
    wf = [0.37, -0.21, 0.55, 0.13, 0.4][:T]
    got = emulate_march(ops, st, wf)
    fdtd_stream.stream_steps_plain(ops, st, wf)
    _assert_equal(got, st)


@pytest.mark.parametrize("boundary", ["MUR", "PML_4"])
def test_batch_schedule_equals_the_plain_twin(monkeypatch, boundary):
    """Three design variants of one grid in one batched launch (the
    ``kBatch`` instances): each variant's own ca/cb, fields and ψ, the x
    cut counting the blocks of the whole batch, variant 1 frozen. Each
    active variant's schedule equals ``stream_steps_batch_plain`` bit for
    bit; the frozen one is left as it was."""
    monkeypatch.setitem(fdtd_stream._MARCH_CORE, _core_key(boundary), (5, 4))
    sim = _sim(boundary)
    ops = sim.operands
    pml = ops.pml is not None
    shape = tuple(ops.shape)
    B, act = 3, (True, False, True)
    ca = tuple(torch.stack([c * (1 + 0.01 * (b + 1) * (m + 1)) for b in range(B)])
               for m, c in enumerate(ops.ca))
    cb = tuple(torch.stack([c * (1 - 0.02 * b) for b in range(B)]) for c in ops.cb)
    bops = fdtd_cuda.batch_operands(ops, ca, cb)
    rng = np.random.default_rng(41)
    st = fdtd_cuda.new_batch_state(shape, "cpu", pml, B)
    for t in (*st.e[0], *st.e[1], *st.h, *st.psi_e, *st.psi_h):
        t.copy_(torch.from_numpy(rng.standard_normal(t.shape).astype(np.float32)))
    if pml:
        for t, keep in zip((*st.psi_e, *st.psi_h), fdtd_stream.psi_slabs(ops)):
            t.masked_fill_(~keep, 0.0)
    before = [st.variant(b) for b in range(B)]
    got = [emulate_march(fdtd_cuda.variant_operands(bops, b), before[b],
                         [0.2, -0.4, 0.7, 0.1], batch=B) if act[b] else None
           for b in range(B)]
    frozen = [t.clone() for t in (*before[1].fields, *before[1].psi_e,
                                  *before[1].psi_h)]
    fdtd_stream.stream_steps_batch_plain(bops, st, [0.2, -0.4, 0.7, 0.1], act)
    for b in range(B):
        v = st.variant(b)
        if act[b]:
            _assert_equal(got[b], v)
        else:
            for x, y in zip((*v.fields, *v.psi_e, *v.psi_h), frozen, strict=True):
                assert torch.equal(x, y)


def test_schedule_with_the_lone_plane_shift(monkeypatch):
    """A cut whose cores and segments would end on the lone wall plane on
    every axis (n % core == 1) shifts by one cell, and the schedule still
    equals the twin."""
    sim = _sim("MUR")
    ops = sim.operands
    n0, n1, n2 = ops.shape
    core = (n1 - 1) // 2, (n2 - 1) // 2
    assert n1 % core[0] == 1 and n2 % core[1] == 1
    monkeypatch.setitem(fdtd_stream._MARCH_CORE, "mur", core)
    tiles = fdtd_stream.march_plan(ops.shape, ops.grid_shape, 3, True)[2]
    assert n0 == 19  # seven segments of 3 planes: 19 % 3 == 1
    blocks = tiles[0] * tiles[1] * 7
    _, origin, _, (seg, so, segs), _ = fdtd_stream.march_plan(
        ops.shape, ops.grid_shape, 3, True, blocks=blocks)
    assert origin == (1, 1) and (seg, so, segs) == (3, 1, 7)
    st = _random_state(ops.shape, seed=5)
    wf = [0.2, -0.4, 0.7]
    got = emulate_march(ops, st, wf, blocks)
    fdtd_stream.stream_steps_plain(ops, st, wf)
    _assert_equal(got, st)


# ---------------------------------------------------------------------------
# a rank's x-slab (the explicit run at Pz > 128): the walls where the slab
# has them
# ---------------------------------------------------------------------------

# (boundary, ranks, rank, T, window, march_view) on the 13-line straddle
# scene of tests/_explicit_ranks.py (Qx = 13; at 4 ranks Px = 16, n = 4);
# under CPML on its 16-line tall_z scene (z = 131), whose slabs hold the
# x slab's rows, the out-of-domain halo rows (b = c = 0) or neither
SLABS = [
    ("MUR", 1, 0, 3, 3, (4, 1, 12)),  # one rank: both walls, view from row W
    ("MUR", 1, 0, 3, 1, (4, 1, 12)),  # a remainder window
    ("MUR", 4, 0, 3, 3, (4, 1, -1)),  # rank 0: the lower wall at slab row W
    ("MUR", 4, 1, 3, 3, (0, 1, -1)),  # W = n: the lower wall on slab row 0
    ("MUR", 4, 2, 3, 3, (0, 0, 8)),  # the upper wall in the upper halo
    ("MUR", 4, 3, 3, 3, (0, 0, 4)),  # the straddle: the first owned row
    ("MUR", 4, 3, 2, 2, (0, 0, 3)),
    ("PEC", 4, 3, 3, 3, (0, 0, -1)),
    ("PEC", 1, 0, 3, 2, (0, 0, -1)),
    ("PML_4", 1, 0, 3, 3, (0, 0, -1)),
    ("PML_4", 1, 0, 3, 2, (0, 0, -1)),  # a remainder window
    ("PML_4", 2, 1, 3, 3, (0, 0, -1)),
    ("PML_4", 4, 0, 3, 3, (0, 0, -1)),  # halo rows out of the domain
    ("PML_4", 4, 1, 3, 3, (0, 0, -1)),  # the x slab's edge in the slab
    ("PML_4", 4, 2, 2, 2, (0, 0, -1)),
    ("PML_4", 4, 3, 3, 3, (0, 0, -1)),
]


def _slab(boundary, n_dev, rank, T):
    from _explicit_ranks import port_sim

    kind = "tall_z" if boundary.startswith("PML") else "straddle"
    sim = port_sim(kind, boundary, n_dev, decim=4)
    return fdtd_stream.build_stream_shard_stepper(sim, n_dev, rank, "cpu",
                                                  t_steps=T)


@pytest.mark.parametrize("boundary,n_dev,rank,T,window,view", SLABS)
def test_slab_schedule_equals_the_plain_twin(monkeypatch, boundary, n_dev,
                                             rank, T, window, view):
    """The schedule on a slab, from the view the host launches
    (``march_view``), against ``fdtd_shard.shard_steps_plain`` with the
    walls at ``mur_x_rows``, bit for bit on every row of the view; cores
    of 5×4 and segments of at most 6 planes, so that the upper wall of
    rank 2 falls on a segment's last plane. Under CPML the ψ too, their x
    flat run cut by the slab (``flat_runs`` of its profiles)."""
    monkeypatch.setitem(fdtd_stream._MARCH_CORE, _core_key(boundary), (5, 4))
    sh = _slab(boundary, n_dev, rank, T)
    ops = sh.ops
    mur, pml = boundary == "MUR", ops.pml is not None
    assert (sh.K, sh.W, sh.m) == (T, T + 1, sh.n + 2 * T + 2)
    assert fdtd_stream.march_view(ops) == view
    v0, _x_lo, x_hi = view
    n0 = ops.shape[0] - v0
    tiles = fdtd_stream.march_plan((n0, *ops.shape[1:]), ops.grid_shape, T,
                                   mur, x_hi, pml=pml)[2]
    blocks = tiles[0] * tiles[1] * 4
    _, _, _, (seg, so, segs), _ = fdtd_stream.march_plan(
        (n0, *ops.shape[1:]), ops.grid_shape, T, mur, x_hi, blocks, pml=pml)
    assert seg <= 6 and segs >= 3
    starts = [max(0, b * seg - so) for b in range(segs)]
    assert x_hi not in starts
    if (n_dev, rank, mur) == (4, 2, True):
        assert x_hi + 1 in starts  # the wall is a segment's last plane
    st = _random_state(ops.shape, 23 + rank, ops)
    wf = [0.31, -0.52, 0.44][:window]
    got = emulate_march(ops, st, wf, blocks)
    fdtd_shard.shard_steps_plain(ops, st, wf)
    for a, ref in zip(got, (*st.fields, *st.psi_e, *st.psi_h), strict=True):
        np.testing.assert_array_equal(a[v0:], ref.numpy()[v0:])


@pytest.mark.parametrize("n_dev", [1, 2, 4])
def test_slab_plan_leaves_no_segment_on_the_upper_wall(n_dev):
    """At every rank of the tall straddle scene (z = 131) and every T the
    slab takes, no x segment starts on the slab's upper wall."""
    from _explicit_ranks import port_sim

    sim = port_sim("tall_straddle", "MUR", n_dev, decim=4)
    for rank in range(n_dev):
        for T in range(1, min(4, sim.padded_shape[0] // n_dev)):
            ops = fdtd_stream.build_stream_shard_stepper(
                sim, n_dev, rank, "cpu", t_steps=T).ops
            v0, _x_lo, x_hi = fdtd_stream.march_view(ops)
            shape = (ops.shape[0] - v0, *ops.shape[1:])
            _, _, _, (seg, so, segs), _ = fdtd_stream.march_plan(
                shape, ops.grid_shape, T, True, x_hi)
            pieces = _pieces(shape[0], seg, so, segs)
            assert sum(b - a for a, b in pieces) == shape[0]
            assert all(a != x_hi for a, _b in pieces), (rank, T, pieces)
