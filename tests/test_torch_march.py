"""The stream march's plan (``fdtd_stream.march_plan``) and its schedule, on the CPU.

The march carries stream mode: each block owns a y–z tile of one x
segment and marches along x with T time levels of a few planes in shared
memory, ``march_kernel`` in ``csrc/fdtd_stream.cu`` under MUR and PEC
walls, ``cpml_march_kernel`` under CPML (its ca, cb and x scalars staged
in rings a plane ahead, its source stamps read on flagged planes only).
The kernels themselves run only on the card (``tests/test_torch_cuda.py``
holds them to their twins there). Here the plan is checked on its own
terms (every core cell of every plane written by exactly one block, no
core or segment a lone wall plane, shared memory within the card's
limit, the mixed scene filling the card, the CPML cells' T, D and cut)
and each kernel's schedule, transcribed step for step into NumPy
(:func:`emulate_march`, :func:`emulate_cpml_march`), is held to the plain
twin ``stream_steps_plain`` bit for bit: the same planes, levels, boxes,
ring slots, deferred lower wall and held-over upper wall, staged slots
and stamp flags, on grids cut into several tiles and segments.
"""

import dataclasses
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
MICROSTRIP = (105, 90, 73)  # microstrip_3d at mesh quality 5
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
    # reserves), one under CPML, whose ψ slots (12 T floats a cell) and
    # staged ca/cb ring (6 (T + 1)) fill it
    T = 5 if not (mur or pml) else 4
    for shape in (MIXED, TALL, (100, 109, 50), MICROSTRIP):
        assert fdtd_stream.max_T(shape, mur, pml) == T
        smem = fdtd_stream.march_plan(shape, shape, T, mur, pml=pml)[4]
        blocks_per_sm = 233_472 // (smem + 1024)
        assert blocks_per_sm == (1 if pml else 2), (shape, smem)
        assert fdtd_stream.march_blocks(pml) == blocks_per_sm * 132
    # per region cell: E and H rings 6 (T + 2), under MUR 8 more; under
    # CPML the ca/cb ring 6 (T + 1) and the ψ slots 12 T at a fixed stride
    # of 508 cells (a 14x14 core's region is 22x22 = 484), and T + 1
    # planes' 8 x scalars
    smem = {(True, False): 24 * 24 * 4 * 44, (False, False): 24 * 24 * 4 * 42,
            (False, True): 508 * 4 * 114 + 4 * 8 * 5}
    assert fdtd_stream.march_plan(MIXED, MIXED, T, mur, pml=pml)[4] == smem[mur, pml]
    assert fdtd_stream.cpml_stride(4) == 508 >= 22 * 22
    assert [fdtd_stream.cpml_stride(t) for t in range(1, 9)] == [
        576, 576, 576, 508, 420, 356, 312, 276]


@pytest.mark.parametrize("pml", [False, True])
def test_mixed_scene_fills_the_card(pml):
    """Under MUR two segments of 130 tiles fill the 264 two-a-SM slots.
    Under CPML the 14x14 core cuts the mixed scene into 165 tiles: three
    segments of 47 planes, 495 blocks in four rounds of the 132 one-a-SM
    slots, finish sooner (4 × 55 planes) than one segment (2 × 149) or
    two (3 × 79); the tall grid's 108 tiles take one round of 161."""
    core, origin, tiles, (seg, so, segs), _ = fdtd_stream.march_plan(
        MIXED, MIXED, 4, not pml, pml=pml)
    slots = fdtd_stream.march_blocks(pml)
    if pml:
        assert core == (14, 14) and tiles == (15, 11) and (seg, segs) == (47, 3)
        blocks = tiles[0] * tiles[1] * segs
        assert 3 * slots < blocks <= 4 * slots
        assert fdtd_stream.march_plan(TALL, TALL, 4, False, pml=True)[2:4] == (
            (9, 12), (161, 0, 1))
        return
    assert tiles == (13, 10) and segs == 2
    blocks = tiles[0] * tiles[1] * segs
    assert 0.98 * slots <= blocks <= slots
    assert fdtd_stream.march_plan(TALL, TALL, 4, True)[2:4] == (
        (8, 10), (54, 0, 3))


def test_cpml_cells_keep_their_depth_decimation_and_cut():
    """The two CPML cells' grids on the CPU as the benchmark prepares them:
    the GUI's microstrip_3d at mesh quality 5 under PML_8 (105×90×73) and
    the 8-variant canonical sweep under PML_8 (100×109×50 a variant).
    Both resolve to stream mode at T = 4 = ``max_T`` with D = 160 and 244;
    the microstrip's 42 tiles take three segments of 35 planes, 126
    blocks in one round, the sweep's 32 tiles a variant one segment of
    100 planes, 256 blocks in two rounds."""
    from fdtd_solver_antennas_tpu_torch.examples.scenes import sweep_variants
    from fdtd_solver_antennas_tpu_torch.models.params import PatchAntennaParams
    from fdtd_solver_antennas_tpu_torch.solvers.microstrip_3d import (
        prepare_microstrip_patch_3d)
    from fdtd_solver_antennas_tpu_torch.solvers.sweep import (
        prepare_patch_geometry_sweep)

    params = PatchAntennaParams.from_user_units(frequency_ghz=2.45, er=4.3,
                                                h_mm=1.6, loss_tangent=0.02)
    micro = prepare_microstrip_patch_3d(
        params, device="cpu", feed_direction="-X", feed_line_length_mm=20.0,
        mesh_quality=5, boundary="PML_8", n_steps_max=30000, end_criteria=1e-4)
    sweep = prepare_patch_geometry_sweep(
        sweep_variants(), feed_pos_mm=-6.0, n_steps_max=30000,
        end_criteria=1e-4, boundary="PML_8", device="cpu")
    for prep, D, batch, cut in ((micro, 160, 1, ((7, 6), (35, 0, 3))),
                                (sweep, 244, 8, ((8, 4), (100, 0, 1)))):
        assert prep.ok, prep.message
        sim = prep.sim
        shape = tuple(sim.padded_shape)
        assert sim.operands.pml is not None
        assert fdtd_stream.max_T(shape, False, True) == 4
        assert (sim.pallas_mode, sim.stream_T, sim.probe_decim) == (
            "stream", 4, D), sim.pallas_mode_reason
        core, _o, tiles, segments, smem = fdtd_stream.march_plan(
            shape, sim.grid.shape, 4, False, batch=batch, pml=True)
        assert (tiles, segments) == cut
        blocks = tiles[0] * tiles[1] * segments[2] * batch
        assert -(-blocks // fdtd_stream.march_blocks(True)) == (1 if batch == 1 else 2)
        assert smem == 231_808 <= fdtd_stream.SMEM_LIMIT


def test_plan_refuses_what_does_not_fit():
    with pytest.raises(ValueError, match="march takes no T=8"):
        fdtd_stream.march_plan(MIXED, MIXED, 8, True)


# ---------------------------------------------------------------------------
# the kernel's schedule in NumPy
# ---------------------------------------------------------------------------

def _np(t):
    return None if t is None else t.numpy()


def emulate_march(ops, st, wf, blocks=None, batch=1):
    """The march the host launches for ``ops`` block by block, in float32
    with the kernel's order of operations: under CPML
    :func:`emulate_cpml_march`, else ``march_kernel`` of
    ``csrc/fdtd_stream.cu`` on the rows ``[v0, m)`` the host launches it
    on (``fdtd_stream.march_view``: a slab's walls), cut as ``march_plan``
    cuts it for ``blocks`` resident blocks (default ``march_blocks``) over
    ``batch`` variants. Returns the new E3 and H3; cells no block writes
    stay NaN."""
    if ops.pml is not None:
        return emulate_cpml_march(ops, st, wf, blocks, batch)
    v0, x_lo, x_hi = fdtd_stream.march_view(ops)
    n0, n1, n2 = ops.shape
    n0 -= v0
    q1, q2 = ops.grid_shape[1:]
    T = len(wf)
    mur = ops.mur is not None
    f32 = np.float32
    core, origin, tiles, (seg, so, segs), _ = fdtd_stream.march_plan(
        (n0, n1, n2), ops.grid_shape, T, mur, x_hi, blocks, batch)

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

        def dh(H, Hm, idx_):
            return _dh(H, Hm, idx_, idy, idz)

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
                Ep = Er[(x + 1) % R] if x + 1 < n0 else np.zeros_like(E)
                d = _de(E, Ep, ip[0][x], ipy, ipz)
                for m, cu in enumerate(_curl(d)):
                    H[m][act] = (H[m] - dtmu * cu)[act]
                # E
                if not defer0:
                    Ox = O[x & 1]
                    cu = _curl(dh(H, Hm, idd[0][x]))
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
                        cu0 = _curl(dh(Hr[0], None, idd[0][0]))
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
    return (*E_all, *H_all)


def _shift(a, axis, d):
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


def _de(E, Ep, ipx, ipy, ipz):
    """Forward differences of E in ψ order (Ep: plane x + 1's E)."""
    ex, ey, ez = E
    return ((_shift(ez, 0, 1) - ez) * ipy, (_shift(ey, 1, 1) - ey) * ipz,
            (_shift(ex, 1, 1) - ex) * ipz, (Ep[2] - ez) * ipx,
            (Ep[1] - ey) * ipx, (_shift(ex, 0, 1) - ex) * ipy)


def _dh(H, Hm, idx_, idy, idz):
    """Backward differences of H in ψ order (Hm: plane x − 1's H or None)."""
    hx, hy, hz = H
    hz_xm = Hm[2] if Hm is not None else np.zeros_like(hz)
    hy_xm = Hm[1] if Hm is not None else np.zeros_like(hy)
    return ((hz - _shift(hz, 0, -1)) * idy, (hy - _shift(hy, 1, -1)) * idz,
            (hx - _shift(hx, 1, -1)) * idz, (hz - hz_xm) * idx_,
            (hy - hy_xm) * idx_, (hx - _shift(hx, 0, -1)) * idy)


def _curl(d, p=None):
    """The curl from the differences d (ψ order), plus the ψ p."""
    if p is None:
        return d[0] - d[1], d[2] - d[3], d[4] - d[5]
    return ((d[0] + p[0]) - (d[1] + p[1]), (d[2] + p[2]) - (d[3] + p[3]),
            (d[4] + p[4]) - (d[5] + p[5]))


def emulate_cpml_march(ops, st, wf, blocks=None, batch=1):
    """``cpml_march_kernel`` of ``csrc/fdtd_stream.cu`` block by block, in
    float32 with the kernel's order of operations, cut as ``march_plan``
    cuts it (no walls: the whole array) for ``blocks`` resident blocks
    over ``batch`` variants. Its rings as the kernel keeps them, each slot
    advanced by a counter: plane p's fields enter slot p mod (T + 2) and
    its ca, cb (per cell) and x scalars (1 / spacings, the four x profile
    values, the stamp flags of ``fdtd_stream.stamp_planes``) slot
    p mod (T + 1) when it enters, and every level reads them from there;
    each cell's ψ moves through T slots by p mod T (level 1 from the
    registers loaded the iteration before, level T to the other set), a ψ
    in its axis's ``flat_runs`` run skipped; a level adds src s only on a
    plane whose flag has the component's bit. Returns the new E3, H3, ψ_e6
    and ψ_h6; cells no block writes stay NaN (a skipped ψ, 0: the other
    set starts at 0 there)."""
    n0, n1, n2 = ops.shape
    T = len(wf)
    R, Rc = T + 2, T + 1
    f32 = np.float32
    core, origin, tiles, (seg, so, segs), _ = fdtd_stream.march_plan(
        ops.shape, ops.grid_shape, T, False, -1, blocks, batch, True)
    E_in = [_np(e) for e in st.e[st.parity]]
    H_in = [_np(h) for h in st.h]
    coef = [_np(a) for a in (*ops.ca, *ops.cb)]
    src = [_np(a) for a in ops.src]
    flags = fdtd_stream.stamp_planes(ops, n0).numpy()
    prof = {key: [_np(a) for a in ops.pml[key]] for key in ("bh", "ch", "be", "ce")}
    # the x scalars of every plane, as the kernel's seven threads copy them
    xsc = np.zeros((n0, 8), f32)
    for i, a in enumerate((_np(ops.inv_p[0]), _np(ops.inv_d[0]),
                           *(prof[k][0] for k in ("bh", "ch", "be", "ce")))):
        xsc[:, i] = a
    xsc[:, 6] = flags.view(f32)
    ip1, ip2, id1, id2 = (_np(a) for a in (ops.inv_p[1], ops.inv_p[2],
                                           ops.inv_d[1], ops.inv_d[2]))
    dtmu = f32(ops.dtmu)
    E_out = [np.full(ops.shape, np.nan, f32) for _ in range(3)]
    H_out = [np.full(ops.shape, np.nan, f32) for _ in range(3)]
    psi_in = [_np(p) for p in (*st.psi_e, *st.psi_h)]  # ψ_e 0..5, ψ_h 6..11
    keep = [k.numpy() for k in fdtd_stream.psi_slabs(ops)]
    psi_out = [np.where(k, np.nan, 0).astype(f32) * np.ones(ops.shape, f32)
               for k in keep]
    runs = fdtd_stream.flat_runs(ops.pml)

    for sg, by, bz in itertools.product(range(segs), range(tiles[0]), range(tiles[1])):
        cy0, cy1 = max(0, by * core[0] - origin[0]), min(n1, (by + 1) * core[0] - origin[0])
        cz0, cz1 = max(0, bz * core[1] - origin[1]), min(n2, (bz + 1) * core[1] - origin[1])
        x0, x1 = max(0, sg * seg - so), min(n0, (sg + 1) * seg - so)
        if cy0 >= cy1 or cz0 >= cz1 or x0 >= x1:
            continue
        ry, rz = max(0, cy0 - T), max(0, cz0 - T)
        Ly, Lz = min(n1, cy1 + T) - ry, min(n2, cz1 + T) - rz
        sy, sz = slice(ry, ry + Ly), slice(rz, rz + Lz)
        gy = ry + np.arange(Ly)[:, None]
        gz = rz + np.arange(Lz)[None, :]
        ipy, ipz = ip1[sy][:, None], ip2[sz][None, :]
        idy, idz = id1[sy][:, None], id2[sz][None, :]
        core_m = (gy >= cy0) & (gy < cy1) & (gz >= cz0) & (gz < cz1)
        dist = np.maximum(np.maximum(cy0 - gy - 1, gy - cy1 + 1),
                          np.maximum(cz0 - gz - 1, gz - cz1 + 1))
        Er = np.zeros((R, 3, Ly, Lz), f32)
        Hr = np.zeros((R, 3, Ly, Lz), f32)
        C = np.zeros((Rc, 6, Ly, Lz), f32)  # ca 0..2, cb 3..5
        X = np.zeros((Rc, 8), f32)
        Ps = np.zeros((T, 12, Ly, Lz), f32)
        pin = np.zeros((12, Ly, Lz), f32)  # level 1's ψ, loaded ahead

        def on(side, ax, x):
            """Whether side's ψ of derivative axis ``ax`` can change."""
            lo, hi = runs[side][ax]
            i = (x, gy, gz)[ax]
            return (i < lo) | (i >= hi)

        def yz_bc(side, ax):
            b, c = (prof["bh"], prof["ch"]) if side == 0 else (prof["be"], prof["ce"])
            sl, shp = (sy, (-1, 1)) if ax == 1 else (sz, (1, -1))
            return b[ax][sl].reshape(shp), c[ax][sl].reshape(shp)

        def psi_level(side, x, t, px, Xp, d, act, write):
            """One side's ψ at level t of plane x (side 0: H, slots 6..11;
            1: E, slots 0..5), the x profile from the scalar slot ``Xp``,
            stored as the kernel stores it; the six ψ, 0 where skipped."""
            off = 6 if side == 0 else 0
            out = []
            for m, ax in enumerate(fdtd_stream.PSI_AXIS):
                o = on(side, ax, x) & act
                b, c = (Xp[2 + 2 * side], Xp[3 + 2 * side]) if ax == 0 else yz_bc(side, ax)
                old = pin[off + m] if t == 1 else Ps[px, off + m]
                new = np.where(o, b * old + c * d[m], f32(0)).astype(f32)
                if t < T:
                    Ps[px, off + m][o] = new[o]
                else:
                    w = o & write
                    psi_out[off + m][x, sy, sz][w] = new[w]
                out.append(new)
            return out

        xs_, xl = max(0, x0 - T), min(n0, x1 + T)
        sp, cp, pp = xs_ % R, xs_ % Rc, xs_ % T
        for p in range(xs_, x1 + T):
            if p < xl:
                for m in range(3):
                    Er[sp, m] = E_in[m][p, sy, sz]
                    Hr[sp, m] = H_in[m][p, sy, sz]
                for m in range(6):
                    C[cp, m] = coef[m][p, sy, sz]
                X[cp] = xsc[p]
            for t in range(1, T + 1):
                x = p - t
                lo = max(0, x0 - T + t - 1)
                if lo <= x < min(n0, x1 + T - t):
                    s = f32(wf[t - 1])
                    sx = sp - t + R if sp - t < 0 else sp - t
                    cx = cp - t + Rc if cp - t < 0 else cp - t
                    px = pp - t + T if pp - t < 0 else pp - t
                    E, H, Xp = Er[sx], Hr[sx], X[cx]
                    Hm = Hr[R - 1 if sx == 0 else sx - 1] if x > 0 else None
                    Ep = Er[0 if sx == R - 1 else sx + 1] if x + 1 < n0 else np.zeros_like(E)
                    act = dist <= T - t
                    write = core_m & (x0 <= x < x1)
                    # H
                    d = _de(E, Ep, Xp[0], ipy, ipz)
                    ps = psi_level(0, x, t, px, Xp, d, act, write)
                    for m, cu in enumerate(_curl(d, ps)):
                        H[m][act] = (H[m] - dtmu * cu)[act]
                    # E
                    d = _dh(H, Hm, Xp[1], idy, idz)
                    cu = _curl(d, psi_level(1, x, t, px, Xp, d, act, write))
                    stamped = int(Xp[6:7].view(np.int32)[0])
                    for m in range(3):
                        v = C[cx, m] * E[m] + C[cx, 3 + m] * cu[m]
                        if stamped >> m & 1:
                            v = v + src[m][x, sy, sz] * s
                        E[m][act] = v[act]
                    if t == T:
                        for m in range(3):
                            E_out[m][x, sy, sz][write] = E[m][write]
                            H_out[m][x, sy, sz][write] = H[m][write]
                if t == 1 and p < xl:  # plane p's ψ, for its level 1 next
                    for m, ax in enumerate(fdtd_stream.PSI_AXIS):
                        for side, off in ((0, 6), (1, 0)):
                            pin[off + m] = np.where(on(side, ax, p),
                                                    psi_in[off + m][p, sy, sz], f32(0))
            sp = 0 if sp + 1 == R else sp + 1
            cp = 0 if cp + 1 == Rc else cp + 1
            pp = 0 if pp + 1 == T else pp + 1
    return (*E_out, *H_out, *psi_out)


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


def _stamped(ops, planes):
    """``ops`` with random source stamps of Ex and Ez on the x planes
    ``planes`` (Ez's on the first of them only) and none of Ey, in place
    of its ports' (no ``src_planes``)."""
    rng = np.random.default_rng(59)
    src = []
    for m in range(3):
        if m == 1:
            src.append(None)
            continue
        t = torch.zeros(tuple(ops.shape))
        for x in planes[: 1 if m == 2 else None]:
            t[x] = torch.from_numpy(rng.standard_normal(t.shape[1:]).astype(np.float32))
            t[x][rng.random(t.shape[1:]) < 0.9] = 0.0  # a few cells a plane
        src.append(t)
    return dataclasses.replace(ops, src=tuple(src), src_planes=None)


@pytest.mark.parametrize("T", [1, 2, 3, 4])
@pytest.mark.parametrize("case", ["grid", "batch", "slab", "stamps"])
def test_staged_cpml_schedule_equals_the_plain_twin(monkeypatch, case, T):
    """``cpml_march_kernel``'s schedule (:func:`emulate_cpml_march`: its
    rings of fields, ca/cb, x scalars and ψ slots advanced by counters,
    its stamps read on flagged planes only) against ``stream_steps_plain``
    bit for bit at every T it takes, from a random state whose ψ are
    nonzero in their slabs, on 5×4 cores and several x segments: a whole
    grid; a batch of three variants with their own ca/cb, variant 1
    frozen; rank 1 of a two-rank x-slab; stamps on planes off plane 0
    (Ex on planes 3 and n0 − 4, Ez on plane 3, no Ey)."""
    monkeypatch.setitem(fdtd_stream._MARCH_CORE, "pml", (5, 4))
    wf = [0.37, -0.21, 0.55, 0.13][:T]
    if case == "slab":
        ops = _slab("PML_4", 2, 1, T).ops
        assert fdtd_stream.march_view(ops) == (0, 0, -1)
    else:
        ops = _sim("PML_4").operands
    n0 = ops.shape[0]
    if case == "stamps":
        ops = _stamped(ops, (3, n0 - 4))
        flags = fdtd_stream.stamp_planes(ops, n0)
        assert flags[3] == 0b101 and flags[n0 - 4] == 0b001
        assert int(torch.count_nonzero(flags)) == 2
    elif case != "slab":  # the lumped port's plane only, off plane 0
        assert torch.nonzero(fdtd_stream.stamp_planes(ops, n0)).flatten().tolist() != [0]
    if case == "batch":
        B, act = 3, (True, False, True)
        bops = fdtd_cuda.batch_operands(
            ops, tuple(torch.stack([c * (1 + 0.01 * (b + 1) * (m + 1)) for b in range(B)])
                       for m, c in enumerate(ops.ca)),
            tuple(torch.stack([c * (1 - 0.02 * b) for b in range(B)]) for c in ops.cb))
        rng = np.random.default_rng(43 + T)
        st = fdtd_cuda.new_batch_state(tuple(ops.shape), "cpu", True, B)
        for t in (*st.e[0], *st.e[1], *st.h, *st.psi_e, *st.psi_h):
            t.copy_(torch.from_numpy(rng.standard_normal(t.shape).astype(np.float32)))
        for t, keep in zip((*st.psi_e, *st.psi_h), fdtd_stream.psi_slabs(ops)):
            t.masked_fill_(~keep, 0.0)
        before = [st.variant(b) for b in range(B)]
        got = [emulate_cpml_march(fdtd_cuda.variant_operands(bops, b), before[b], wf,
                                  batch=B) if act[b] else None for b in range(B)]
        frozen = [t.clone() for t in (*before[1].fields, *before[1].psi_e,
                                      *before[1].psi_h)]
        fdtd_stream.stream_steps_batch_plain(bops, st, wf, act)
        for b in range(B):
            v = st.variant(b)
            if act[b]:
                _assert_equal(got[b], v)
            else:
                for x, y in zip((*v.fields, *v.psi_e, *v.psi_h), frozen, strict=True):
                    assert torch.equal(x, y)
        return
    tiles = fdtd_stream.march_plan(ops.shape, ops.grid_shape, T, False, pml=True)[2]
    blocks = tiles[0] * tiles[1] * 4  # several x segments on the slab too
    segs = fdtd_stream.march_plan(ops.shape, ops.grid_shape, T, False,
                                  blocks=blocks, pml=True)[3][2]
    assert segs >= 2 and tiles[0] >= 2 and tiles[1] >= 2
    st = _random_state(tuple(ops.shape), 61 + T, ops)
    assert all(bool(p.ne(0).any()) for p in (*st.psi_e, *st.psi_h))
    got = emulate_cpml_march(ops, st, wf, blocks)
    if case == "slab":  # the slab's twin: the steps with its halo rows
        fdtd_shard.shard_steps_plain(ops, st, wf)
    else:
        fdtd_stream.stream_steps_plain(ops, st, wf)
    _assert_equal(got, st)


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
