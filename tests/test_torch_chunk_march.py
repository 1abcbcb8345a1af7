"""The marched form of K1 batched (``ops/chunk_march.py``) on the CPU.

``chunk_march_kernel`` of ``csrc/fdtd_chunk_march.cu`` steps a chunk of B
design variants as rounds of T steps: each block marches one variant's
y–z tile of an x segment with T time levels of a ring of planes in shared
memory, each plane's coefficients staged once into a ring of their own,
a barrier among a variant's blocks after every round, the probe gather
after each interval's last round, the result in the field set the last
round wrote. The kernel itself runs only on the card
(``tests/test_torch_cuda.py`` and ``chip_smoke.py`` phase 16 hold it to
its twin there). Here its schedule, transcribed into NumPy round by round,
item by item and level by level (:func:`emulate_chunk_march`), is held bit
for bit to ``chunk_steps_batch_plain`` under MUR and PEC, at B = 1 and at
B = 3 with a frozen variant, over two chunks (the second starting from the
set the first left), at a T that divides D, one that does not and one
past D, on grids cut into several tiles and segments with walls on their
edges; the emulated two-patch sweep is held to the JAX package's vmapped
run; and the host-side plan is checked without a device.
"""

import dataclasses
import itertools
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from fdtd_solver_antennas_tpu_torch.models.scene import Scene
from fdtd_solver_antennas_tpu_torch.ops import chunk_march, fdtd, fdtd_cuda, fdtd_stream
from fdtd_solver_antennas_tpu_torch.ops.fdtd import FDTDConfig, build_simulation
from fdtd_solver_antennas_tpu_torch.ops.mesh import MeshBuilder

SWEEP = (100, 109, 50)  # bench.py's 8-variant sweep's union grid


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Test workers share the cores (pytest-xdist)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _pieces(n, length, origin, count):
    return [(max(0, b * length - origin), min(n, (b + 1) * length - origin))
            for b in range(count)]


# ---------------------------------------------------------------------------
# the kernel's schedule in NumPy
# ---------------------------------------------------------------------------

def _shift(a, axis, d):
    """a[i + d] along ``axis`` (d = ±1), 0 past the region."""
    out = np.zeros_like(a)
    src, dst = [slice(None)] * a.ndim, [slice(None)] * a.ndim
    if d > 0:
        src[axis], dst[axis] = slice(1, None), slice(0, -1)
    else:
        src[axis], dst[axis] = slice(0, -1), slice(1, None)
    out[tuple(dst)] = a[tuple(src)]
    return out


def _march_item(g, b, ty, tz, sg, T, wf, fin, fout):
    """``march_item``: variant b's tile (ty, tz) of segment sg for T
    levels, from the arrays ``fin`` (E3, H3 of the variant) into ``fout``,
    ca/cb/stamps and the x profiles read only from the coefficient rings
    C[x % Tc] and X[x % Tc]. A copy the kernel issues a plane ahead
    (cp.async) lands here at once, so a ring slot still read in the
    iteration that refills it shows."""
    f32 = np.float32
    n0, n1, n2 = g.n
    q1, q2 = g.q
    (cy, cz), (oy, oz) = g.plan.core, g.plan.origin
    seg, so, _ = g.plan.segments
    cy0, cy1 = max(0, ty * cy - oy), min(n1, (ty + 1) * cy - oy)
    cz0, cz1 = max(0, tz * cz - oz), min(n2, (tz + 1) * cz - oz)
    x0, x1 = max(0, sg * seg - so), min(n0, (sg + 1) * seg - so)
    if cy0 >= cy1 or cz0 >= cz1 or x0 >= x1:
        return
    ry, rz = max(0, cy0 - T), max(0, cz0 - T)
    Ly, Lz = min(n1, cy1 + T) - ry, min(n2, cz1 + T) - rz
    sy, sz = slice(ry, ry + Ly), slice(rz, rz + Lz)
    R, Tc = chunk_march.field_planes(), chunk_march.coef_planes(g.mur)
    Er = np.zeros((R, 3, Ly, Lz), f32)
    Hr = np.zeros((R, 3, Ly, Lz), f32)
    O = np.zeros((2, 3, Ly, Lz), f32)
    W = np.zeros((2, Ly, Lz), f32)
    C = np.zeros((Tc, 9, Ly, Lz), f32)  # ca 0..2, cb 3..5, stamps 6..8
    X = np.zeros((Tc, 2), f32)  # 1 / primary and 1 / dual spacing along x
    gy = ry + np.arange(Ly)[:, None]
    gz = rz + np.arange(Lz)[None, :]
    ipy, ipz = g.ip[1][sy][:, None], g.ip[2][sz][None, :]
    idy, idz = g.idd[1][sy][:, None], g.idd[2][sz][None, :]
    core = (gy >= cy0) & (gy < cy1) & (gz >= cz0) & (gz < cz1)
    x_lo, x_hi = g.x_lo, g.x_hi

    def coefs(x):
        """The plane's coefficients as the copies bring them in."""
        k = np.zeros((9, Ly, Lz), f32)
        for m in range(3):
            k[m] = g.ca[m][b][x, sy, sz]
            k[3 + m] = g.cb[m][b][x, sy, sz]
            if g.src[m] is not None:
                k[6 + m] = g.src[m][x, sy, sz]
        return k

    def dh(H, Hm, idx_):
        hx, hy, hz = H
        hz_xm = Hm[2] if Hm is not None else np.zeros_like(hz)
        hy_xm = Hm[1] if Hm is not None else np.zeros_like(hy)
        d = ((hz - _shift(hz, 0, -1)) * idy, (hy - _shift(hy, 1, -1)) * idz,
             (hx - _shift(hx, 1, -1)) * idz, (hz - hz_xm) * idx_,
             (hy - hy_xm) * idx_, (hx - _shift(hx, 0, -1)) * idy)
        return d[0] - d[1], d[2] - d[3], d[4] - d[5]

    def e_cell(E, K, cu, s):
        v = []
        for m in range(3):
            val = K[m] * E[m] + K[3 + m] * cu[m]
            if g.src[m] is not None:
                val = val + K[6 + m] * f32(s)
            v.append(val)
        return v

    def fix(E, Oo, act, axis, side, coef, comps):
        """MUR on the wall rows (axis 0 = y, 1 = z) of one plane."""
        L = Ly if axis == 0 else Lz
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

    def fields_in(p):
        for m in range(3):
            Er[p % R, m] = fin[m][p, sy, sz]
            Hr[p % R, m] = fin[3 + m][p, sy, sz]

    xs, xl = max(0, x0 - T), min(n0, x1 + T)
    fields_in(xs)
    for p in range(xs, x1 + T):
        if p < xl:  # plane p + 1's fields, plane p's coefficients
            if p + 1 < xl:
                fields_in(p + 1)
            C[p % Tc] = coefs(p)
            X[p % Tc] = g.ip[0][p], g.idd[0][p]
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
            full = bool(act.all())

            def put(dst, val):
                """dst = val where the level's box is (everywhere: one
                assignment)."""
                if full:
                    dst[...] = val
                else:
                    dst[act] = val[act]

            defer0 = g.mur and x_lo and x == 0
            with0 = g.mur and x_lo and x == 1 and lo == 0
            ex, ey, ez = E
            Ep = Er[(x + 1) % R] if x + 1 < n0 else np.zeros_like(E)
            ipx = X[x % Tc, 0]
            d = ((_shift(ez, 0, 1) - ez) * ipy, (_shift(ey, 1, 1) - ey) * ipz,
                 (_shift(ex, 1, 1) - ex) * ipz, (Ep[2] - ez) * ipx,
                 (Ep[1] - ey) * ipx, (_shift(ex, 0, 1) - ex) * ipy)
            for m, cu in enumerate((d[0] - d[1], d[2] - d[3], d[4] - d[5])):
                put(H[m], H[m] - g.dtmu * cu)
            if not defer0:
                Ox = O[x & 1]
                old = E.copy()
                v = e_cell(old, C[x % Tc], dh(H, Hm, X[x % Tc, 1]), s)
                if g.mur:
                    for m in range(3):
                        put(Ox[m], old[m])
                put(E[0], v[0])
                if g.mur and x == x_hi:
                    put(E[1], W[0])
                    put(E[2], W[1])
                else:
                    put(E[1], v[1])
                    put(E[2], v[2])
                if g.mur and x == x_hi - 1:
                    Ew = Er[(x + 1) % R]
                    cx = g.mc[0][1]
                    put(W[0], Ox[1] + cx * (v[1] - Ew[1]))
                    put(W[1], Ox[2] + cx * (v[2] - Ew[2]))
                if with0:
                    E0 = Er[0]
                    old0 = E0.copy()
                    v0 = e_cell(old0, C[0], dh(Hr[0], None, X[0, 1]), s)
                    for m in range(3):
                        put(O[0][m], old0[m])
                    cx = g.mc[0][0]
                    put(E0[0], v0[0])
                    put(E0[1], Ox[1] + cx * (v[1] - O[0][1]))
                    put(E0[2], Ox[2] + cx * (v[2] - O[0][2]))
            if g.mur:
                for axis, comps in ((0, (0, 2)), (1, (0, 1))):
                    for side in (0, 1):
                        coef = g.mc[axis + 1][side]
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
                        fout[m][px, sy, sz][core] = Er[px % R, m][core]
                        fout[3 + m][px, sy, sz][core] = Hr[px % R, m][core]


def emulate_chunk_march(ops, st, wf, n0, n_sub, D, bufs, active, plan):
    """``chunk_march_kernel`` for one chunk on a CPU :class:`YeeBatch`, in
    float32 with the kernel's order of operations: rounds of T steps (the
    last of an interval D mod T), every active variant's items marched
    from the set the round before wrote into the other (set 0 the
    variants' current E buffer and H set), the probe rows of each
    interval gathered from the set its last round wrote, each active
    variant's parity and H set flipped when the rounds are odd. The set a
    round writes is filled with NaN first, so a cell no item writes
    shows."""
    act = fdtd_cuda._active_mask(active, st.batch)
    live = [b for b in range(st.batch) if act[b]]
    p, q = fdtd_cuda.one_set(st, live, "emulate_chunk_march")
    if not st.h1:
        st.h1 = tuple(torch.zeros_like(t) for t in st.h)
    sets = [tuple(t.numpy() for t in (*st.e[p], *st.h_set(q)[0])),
            tuple(t.numpy() for t in (*st.e[1 - p], *st.h_set(1 - q)[0]))]
    v0, x_lo, x_hi = fdtd_stream.march_view(ops)
    assert v0 == 0
    g = SimpleNamespace(
        n=tuple(ops.shape), q=tuple(ops.grid_shape[1:]), plan=plan,
        mur=ops.mur is not None, x_lo=x_lo, x_hi=x_hi,
        ca=[c.numpy() for c in ops.ca], cb=[c.numpy() for c in ops.cb],
        src=[None if s is None else s.numpy() for s in ops.src],
        ip=[a.numpy() for a in ops.inv_p], idd=[a.numpy() for a in ops.inv_d],
        dtmu=np.float32(ops.dtmu),
        mc=[[np.float32(c) for c in pair] for pair in ops.mur] if ops.mur else None)
    wf = np.asarray(wf, np.float32)[n0:]
    per = plan.rounds(D)
    ty, tz = plan.tiles
    items = list(itertools.product(range(plan.segments[2]), range(ty), range(tz)))
    assert len(items) == plan.items_per_variant
    for r in range(n_sub * per + 1):
        fin, fout = sets[r & 1], sets[1 - (r & 1)]
        for b in live:
            if r and r % per == 0:  # the interval's last round is done
                j = r // per - 1
                v = fdtd_cuda.YeeState(
                    e=[tuple(torch.from_numpy(a[b]) for a in fin[:3])] * 2,
                    h=tuple(torch.from_numpy(a[b]) for a in fin[3:]))
                fdtd_cuda.probe_gather_plain(ops, v, bufs[b, j])
            if r == n_sub * per:
                continue
            for a in fout:
                a[b] = np.nan
            s0 = (r % per) * plan.T
            T = min(plan.T, D - s0)
            samples = wf[(r // per) * D + s0:][:T]
            for sg, by, bz in items:
                _march_item(g, b, by, bz, sg, T, samples,
                            [a[b] for a in fin], [a[b] for a in fout])
    if n_sub * per % 2:
        for b in live:
            st.parity[b] ^= 1
            st.hset[b] ^= 1


# ---------------------------------------------------------------------------
# the schedule against the plain twin
# ---------------------------------------------------------------------------

def _sim(boundary, decim):
    """tests/test_torch_march.py's small scene (its lumped port and
    Huygens faces give probe rows of every block)."""
    mb = MeshBuilder()
    mb.add_line("x", [-40, 40, 0.0, -6.0])
    mb.add_line("y", [-30, 30, 0.0])
    mb.add_line("z", [-20, 30])
    mb.add_line("z", np.linspace(0, 1.6, 3))
    grid = mb.build(5.0)
    scene = Scene()
    scene.add_material_box("sub", 4.3, 0.005, [-20, -20, 0], [20, 20, 1.6], 0)
    scene.add_metal_box("patch", [-15, -12, 1.6], [15, 12, 1.6], priority=10)
    scene.add_metal_box("gnd", [-20, -20, 0], [20, 20, 0], priority=10)
    scene.add_lumped_port(1, 50.0, [-6, 0, 0], [-6, 0, 1.6], direction="z")
    cfg = FDTDConfig(n_steps_max=40, check_every=40, end_criteria=1e-30,
                     boundary=boundary, probe_decimation=decim)
    return build_simulation(scene, grid, f0=2.45e9, fc=1.225e9, cfg=cfg,
                            device="cpu", port_freqs_hz=np.linspace(2e9, 3e9, 5),
                            nf_freqs_hz=np.array([2.45e9]))


def _batch(sim, batch, seed):
    """Batched operands (variant b's ca/cb scaled by a seeded factor near
    1) and a seeded random batch state at parity 1."""
    rng = np.random.default_rng(seed)
    ops = sim.operands
    scale = torch.from_numpy(rng.uniform(0.9, 1.1, (batch, 1, 1, 1)).astype(np.float32))
    bops = fdtd_cuda.batch_operands(ops, [c[None] * scale for c in ops.ca],
                                    [c[None] * scale for c in ops.cb])
    st = fdtd_cuda.new_batch_state(sim.padded_shape, "cpu", False, batch)
    for t in (*st.e[0], *st.e[1], *st.h):
        t.copy_(torch.from_numpy(rng.standard_normal(t.shape).astype(np.float32)))
    st.parity = [1] * batch
    return bops, st


def _clone(st):
    def c(ts):
        return tuple(t.clone() for t in ts)

    return fdtd_cuda.YeeBatch(e=[c(st.e[0]), c(st.e[1])], h=c(st.h),
                              parity=list(st.parity), h1=c(st.h1),
                              hset=list(st.hset))


# (boundary, D, n_sub, core): T = 3 not dividing D, dividing it, past it;
# cores small enough for several tiles a y-z plane and several segments
CASES = [
    ("MUR", 4, 2, (5, 4)),
    ("MUR", 5, 2, (6, 5)),
    ("MUR", 3, 2, (4, 6)),
    ("PEC", 5, 2, (5, 4)),
    ("PEC", 6, 2, (6, 5)),
    ("PEC", 2, 3, (4, 4)),
]


def _plan(ops, batch, core, blocks=1000):
    """The host plan at a small core; ``blocks`` resident blocks (default:
    many, so the x cut gives several segments)."""
    return chunk_march.plan_layout(
        ops.shape, ops.grid_shape, ops.mur is not None, batch, 1, blocks, core)


@pytest.mark.parametrize("boundary,D,n_sub,core", CASES)
def test_schedule_equals_the_plain_twin_with_a_frozen_variant(boundary, D, n_sub,
                                                               core):
    """B = 3 over two chunks from parity 1, every variant stepping in the
    first, variant 1 frozen in the second: each active variant's current
    fields and samples equal ``chunk_steps_batch_plain`` bit for bit, the
    frozen one keeps every tensor, its samples, its parity and set."""
    sim = _sim(boundary, D)
    ops, st = _batch(sim, 3, seed=31 + D)
    plan = _plan(ops, 3, core)
    assert plan.segments[2] >= 2 and min(plan.tiles) >= 2, plan
    ref = _clone(st)
    rows = ops.probes.n_rows
    assert rows > 0
    wf = np.random.default_rng(7).uniform(-1, 1, 3 + 2 * n_sub * D).astype(np.float32)
    bufs, rbufs = torch.zeros((3, n_sub, rows)), torch.zeros((3, n_sub, rows))
    for i, mask in enumerate(([True] * 3, [True, False, True])):
        n0 = 3 + i * n_sub * D
        if i == 1:
            frozen = [t.clone() for t in st.variant(1).fields]
            frozen_set = (st.parity[1], st.hset[1])
            frozen_bufs = bufs[1].clone()
        emulate_chunk_march(ops, st, wf, n0, n_sub, D, bufs, mask, plan)
        fdtd_cuda.chunk_steps_batch_plain(ops, ref, wf, n0, n_sub, D, rbufs, mask)
        for b in range(3):
            if i == 1 and b == 1:
                continue
            for x, y in zip(st.variant(b).fields, ref.variant(b).fields, strict=True):
                np.testing.assert_array_equal(x.numpy(), y.numpy())
            np.testing.assert_array_equal(bufs[b].numpy(), rbufs[b].numpy())
    assert (st.parity[1], st.hset[1]) == frozen_set
    assert torch.equal(bufs[1], frozen_bufs)
    for x, y in zip(st.variant(1).fields, frozen, strict=True):
        assert torch.equal(x, y)


@pytest.mark.parametrize("boundary,D,n_sub,core", [CASES[1], CASES[3]])
def test_schedule_of_one_variant_equals_chunk_steps_plain(boundary, D, n_sub,
                                                          core):
    """B = 1: the marched chunk equals the unbatched plain chunk on the
    variant's own state, bit for bit."""
    sim = _sim(boundary, D)
    ops, st = _batch(sim, 1, seed=5)
    plan = _plan(ops, 1, core)
    v = st.variant(0)
    ref = fdtd_cuda.YeeState(e=[tuple(t.clone() for t in v.e[k]) for k in range(2)],
                             h=tuple(t.clone() for t in v.h), parity=1)
    rows = ops.probes.n_rows
    wf = np.random.default_rng(9).uniform(-1, 1, 2 + n_sub * D).astype(np.float32)
    bufs, rbufs = torch.zeros((1, n_sub, rows)), torch.zeros((n_sub, rows))
    emulate_chunk_march(ops, st, wf, 2, n_sub, D, bufs, [True], plan)
    fdtd_cuda.chunk_steps_plain(fdtd_cuda.variant_operands(ops, 0), ref, wf, 2,
                                n_sub, D, rbufs)
    for x, y in zip(st.variant(0).fields, ref.fields, strict=True):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
    np.testing.assert_array_equal(bufs[0].numpy(), rbufs.numpy())


def test_schedule_with_the_lone_plane_shift():
    """Cores and segments that would start on the upper wall plane on
    every axis shift by one cell (origin 1), and the schedule still equals
    the twin."""
    sim = _sim("MUR", 4)
    ops, st = _batch(sim, 1, seed=3)
    n0, n1, n2 = ops.shape
    core = (n1 - 1) // 2, (n2 - 1) // 2
    assert n1 % core[0] == 1 and n2 % core[1] == 1
    assert n0 == 19  # seven segments of 3 planes: 19 % 3 == 1
    tiles = _plan(ops, 1, core).tiles
    plan = _plan(ops, 1, core, tiles[0] * tiles[1] * 7)
    assert plan.origin == (1, 1) and plan.segments == (3, 1, 7), plan
    ref = _clone(st)
    rows = ops.probes.n_rows
    wf = np.linspace(-0.5, 0.5, 8).astype(np.float32)
    bufs, rbufs = torch.zeros((1, 2, rows)), torch.zeros((1, 2, rows))
    emulate_chunk_march(ops, st, wf, 0, 2, 4, bufs, [True], plan)
    fdtd_cuda.chunk_steps_batch_plain(ops, ref, wf, 0, 2, 4, rbufs, [True])
    for x, y in zip(st.variant(0).fields, ref.variant(0).fields, strict=True):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
    np.testing.assert_array_equal(bufs.numpy(), rbufs.numpy())


# ---------------------------------------------------------------------------
# the emulated sweep against the JAX package
# ---------------------------------------------------------------------------

def test_emulated_two_patch_sweep_matches_jax():
    """``tests/test_sweep.py``'s two patches through ``run_batched`` with
    the emulated marched chunk in place of ``chunk_steps_batch``, against
    the JAX package's vmapped XLA run: ``steps``, ``e_ratio``, ``uf`` and
    ``if_`` at rtol 2e-4, atol 1e-5·max; the final fields at the JAX
    package's own sweep bound (rtol 2e-3, atol 2e-4·max, ROADMAP C4)."""
    from fdtd_solver_antennas_tpu import PatchAntennaParams as JPatch
    from fdtd_solver_antennas_tpu.solvers import sweep as jsweep
    from fdtd_solver_antennas_tpu_torch.models.params import PatchAntennaParams
    from fdtd_solver_antennas_tpu_torch.solvers import sweep

    geoms = [(26.0, 33.0), (32.0, 41.0)]
    kw = dict(n_steps_max=200, end_criteria=1e-12)
    prep = sweep.prepare_patch_geometry_sweep(
        [PatchAntennaParams.from_user_units(frequency_ghz=2.45, er=4.3, h_mm=1.6,
                                            L_mm=L, W_mm=W) for L, W in geoms],
        device="cpu", **kw)
    assert prep.ok, prep.message
    sim = prep.sim
    assert sim.pallas_mode == "chunk"
    plans = []

    def marched(ops, st, wf, n0, n_sub, D, bufs, active):
        # one tile a plane and one segment, the fewest items to emulate
        # (the cut is held to the twin above)
        plan = chunk_march.plan_layout(ops.shape, ops.grid_shape,
                                       ops.mur is not None, st.batch)
        plan = dataclasses.replace(
            plan, core=tuple(ops.shape[1:]), origin=(0, 0), tiles=(1, 1),
            segments=(ops.shape[0], 0, 1), items_per_variant=1)
        plans.append(plan)
        emulate_chunk_march(ops, st, wf, n0, n_sub, D, bufs, active, plan)

    impl = SimpleNamespace(**{**vars(fdtd_stream.plain), "chunk_steps_batch": marched})
    out, _, _ = sweep._run_batched(prep, impl)
    assert plans and plans[0].T == chunk_march.T
    jprep = jsweep.prepare_patch_geometry_sweep(
        [JPatch.from_user_units(frequency_ghz=2.45, er=4.3, h_mm=1.6, L_mm=L,
                                W_mm=W) for L, W in geoms],
        use_pallas=False, **kw)
    assert jprep.ok, jprep.message
    jout, _, _ = jsweep._run_batched(jprep)

    def close(got, ref, what, rtol=2e-4, atol_rel=1e-5):
        ref = np.asarray(ref)
        atol = atol_rel * max(float(np.abs(ref).max()), 1e-30)
        np.testing.assert_allclose(np.asarray(got), ref, rtol=rtol, atol=atol,
                                   err_msg=what)

    np.testing.assert_array_equal(out["steps"], np.asarray(jout["steps"]))
    close(out["e_ratio"], jout["e_ratio"], "e_ratio")
    juf, jif = np.asarray(jout["uf"]), np.asarray(jout["if_"])
    for b in range(2):
        close(out["uf"][b], juf[b, 0] + 1j * juf[b, 1], f"variant {b} uf")
        close(out["if_"][b], jif[b, 0] + 1j * jif[b, 1], f"variant {b} if_")
        for i, (f, jf) in enumerate(zip(out["fields"], jout["fields"])):
            jf = np.asarray(jf)[b]
            close(f[b].numpy()[tuple(slice(0, n) for n in jf.shape)], jf,
                  f"variant {b} field {i}", rtol=2e-3, atol_rel=2e-4)


# ---------------------------------------------------------------------------
# the host-side plan
# ---------------------------------------------------------------------------

def test_plan_at_the_sweep():
    """The 8-variant sweep (MUR) at one block an SM on 132 SMs: T = 3 and
    the core of least rounds × planes × warps, 14 × 25 (8 × 2 tiles of the
    109 × 50 plane), one segment of all 100 planes, 16 items a variant,
    128 blocks of 640 threads, 227,892 B of shared memory (184,364 B under
    PEC); an interval of D = 244 is 82 rounds (81 of 3, one of 1). A
    16 × 16 core's 484 cells fit the 640 a block holds; a 20 × 20 core's
    676 do not."""
    plan = chunk_march.plan_layout(SWEEP, SWEEP, True, 8, 1, 132)
    assert (plan.T, plan.core, plan.tiles) == (3, (14, 25), (8, 2))
    assert plan.segments == (100, 0, 1) and plan.items_per_variant == 16
    assert (plan.blocks, plan.threads, plan.smem_bytes) == (128, 640, 227_892)
    assert plan.form == "marched" and plan.cells_per_thread == 0
    assert [plan.rounds(D) for D in (244, 4, 3, 5)] == [82, 2, 1, 2]
    pec = chunk_march.plan_layout(SWEEP, SWEEP, False, 8, 1, 132)
    assert pec.smem_bytes == 184_364 <= fdtd_stream.SMEM_LIMIT
    sixteen = chunk_march.plan_layout(SWEEP, SWEEP, True, 8, 1, 132, (16, 16))
    assert (sixteen.threads, sixteen.tiles, sixteen.items_per_variant) == (
        512, (7, 4), 28)
    with pytest.raises(ValueError, match="676 cells"):
        chunk_march.plan_layout(SWEEP, SWEEP, True, 8, 1, 132, (20, 20))


@pytest.mark.parametrize("shape", [SWEEP, (19, 17, 13), (82, 72, 50), (33, 49, 17)])
@pytest.mark.parametrize("mur", [True, False])
def test_plan_covers_every_core_cell_once(shape, mur):
    """At the core the plan picks: each cell of the grid lies in exactly
    one item's core and segment, the core and its halo fit the block's
    cells and its shared memory the card's limit."""
    plan = chunk_march.plan_layout(shape, shape, mur, 3, 1, 132)
    cells = chunk_march.region_cells(plan.core)
    assert cells <= chunk_march.LAYOUT_CELLS
    assert plan.threads == -(-cells // 32) * 32
    assert plan.smem_bytes <= fdtd_stream.SMEM_LIMIT
    count = np.zeros(shape, np.int32)
    for (x0, x1), (y0, y1), (z0, z1) in itertools.product(
            _pieces(shape[0], *plan.segments),
            _pieces(shape[1], plan.core[0], plan.origin[0], plan.tiles[0]),
            _pieces(shape[2], plan.core[1], plan.origin[1], plan.tiles[1])):
        count[x0:x1, y0:y1, z0:z1] += 1
    assert (count == 1).all()
    assert plan.blocks == min(132, 3 * plan.items_per_variant)


def _synthetic_ops(shape, boundary, batch):
    """Operands of ``shape`` with ``batch`` variants of ca/cb (ones), the
    source on Ez; ``boundary`` MUR, PEC or PML (CPML profiles of ones)."""
    ones = tuple(torch.ones(n) for n in shape)
    pml = ({k: ones for k in ("bh", "ch", "be", "ce")}
           if boundary == "PML" else None)
    ops = fdtd_cuda.YeeOperands(
        shape=shape, grid_shape=shape, dtmu=0.25, inv_p=ones, inv_d=ones,
        ca=tuple(torch.ones(shape) for _ in range(3)),
        cb=tuple(torch.ones(shape) for _ in range(3)),
        src=(None, None, torch.ones(shape)),
        mur=((0.1, 0.1),) * 3 if boundary == "MUR" else None, pml=pml,
        probes=fdtd_cuda.ProbeTable.empty())
    return fdtd_cuda.batch_operands(
        ops, [c[None].expand(batch, *shape).contiguous() for c in ops.ca],
        [c[None].expand(batch, *shape).contiguous() for c in ops.cb])


def test_form_picked_for_a_spilling_batch(monkeypatch):
    """The plan takes the marched form by itself where the batch's working
    set exceeds the L2 under MUR or PEC (the 8-variant sweep: 8 × 28.3 MB),
    never under CPML, and not where the batch fits; with ``L2_BYTES``
    patched small a batch of two small variants spills and marches."""
    ws = fdtd.working_set_bytes(SWEEP, 1, False)
    assert 8 * ws > fdtd.L2_BYTES > ws
    assert fdtd_cuda.marches(_synthetic_ops(SWEEP, "MUR", 8), 8)
    assert fdtd_cuda.marches(_synthetic_ops(SWEEP, "PEC", 8), 8)
    assert not fdtd_cuda.marches(_synthetic_ops(SWEEP, "MUR", 1), 1)
    small = (12, 10, 9)
    assert not fdtd_cuda.marches(_synthetic_ops(small, "MUR", 2), 2)
    monkeypatch.setattr(fdtd, "L2_BYTES", fdtd.working_set_bytes(small, 1, False))
    assert fdtd_cuda.marches(_synthetic_ops(small, "MUR", 2), 2)
    assert not fdtd_cuda.marches(_synthetic_ops(small, "MUR", 1), 1)
    assert not fdtd_cuda.marches(_synthetic_ops(small, "PML", 2), 2)


def test_marched_form_refuses_cpml_and_unbatched_states():
    """Forcing the marched form under CPML raises before any build, and
    so does asking it of an unbatched state."""
    ops = _synthetic_ops((12, 10, 9), "PML", 2)
    st = fdtd_cuda.new_batch_state((12, 10, 9), "cpu", True, 2)
    with pytest.raises(ValueError, match="not CPML"):
        fdtd_cuda.chunk_launch_plan(ops, st, "marched")
    one = fdtd_cuda.new_state((12, 10, 9), "cpu", False)
    with pytest.raises(ValueError, match="chunk_steps_batch's alone"):
        fdtd_cuda.chunk_launch_plan(fdtd_cuda.variant_operands(ops, 0), one,
                                    "marched")


def test_march_tune_reads_its_cores():
    """``examples/march_tune.py``'s ``--cores`` as y–z cores, each of its
    own fitting a block."""
    from fdtd_solver_antennas_tpu_torch.examples.march_tune import CORES, parse_cores

    assert parse_cores("14x25,16x17") == ((14, 25), (16, 17))
    assert parse_cores("") == ()
    for core in CORES:
        assert chunk_march.region_cells(core) <= chunk_march.LAYOUT_CELLS
