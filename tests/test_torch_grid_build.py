"""The Yee grid's build on the card (``ops/grid_build.py``,
``csrc/grid_build.cu``) against the host build.

On the CPU: the packed primitive table, read back by the plain PyTorch
twins that walk it as the kernels do, gives ``voxelize()``'s ``eps_r``,
``sigma``, ``pec_*`` and ``sheet_sigma_*`` and the host's reference
``ca_*``/``cb_*`` (``ops/fdtd.py::host_coeffs``) bit for bit, on scenes
that reach every branch of the host voxelizer (the native paint and the
ordered NumPy paint, PEC boxes and polyhedra, the carve rule, sheets on
rotated boxes, ports, padding); so does a CPU ``build_simulation``, which
builds through the twins and counts ``on_device`` 0; the explicit-order
polyhedron and rigid-transform tests agree with the matrix product's
masks on the mixed and horn scenes. On the card (marked ``cuda``, skipped
elsewhere: a CUDA kernel has no CPU mode) each kernel equals its twin and
every CUDA ``build_simulation`` equals the CPU build and the host's
reference bit for bit, coefficients and source columns. No JAX, so the
card's machine runs it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_grid_build.py -q
"""

import dataclasses

import numpy as np
import pytest
import torch

from fdtd_solver_antennas_tpu_torch.models.params import (
    HornAntennaParams,
    PatchAntennaParams,
)
from fdtd_solver_antennas_tpu_torch.models.scene import (
    ConvexPolyhedron,
    Material,
    Scene,
    make_plate,
    rotation_matrix,
)
from fdtd_solver_antennas_tpu_torch.ops import grid_build
from fdtd_solver_antennas_tpu_torch.ops.fdtd import (
    FDTDConfig,
    build_simulation,
    host_coeffs,
)
from fdtd_solver_antennas_tpu_torch.ops.mesh import MeshBuilder
from fdtd_solver_antennas_tpu_torch.ops.voxelize import (
    _edge_axes,
    _poly_window,
    voxelize,
)
from fdtd_solver_antennas_tpu_torch.physics import EPS0
from fdtd_solver_antennas_tpu_torch.utils import tracing

PATCH = dict(frequency_ghz=2.45, er=4.3, h_mm=1.6, loss_tangent=0.02)
MIXED_HORN = dict(frequency_ghz=2.45, throat_a_mm=86.0, throat_b_mm=43.0,
                  aperture_A_mm=150.0, aperture_B_mm=110.0, length_mm=60.0)
KEYS = tuple(p + c for p in ("ca_", "cb_") for c in ("ex", "ey", "ez"))


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Test workers share the cores (pytest-xdist)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# scenes
# ---------------------------------------------------------------------------

def _small(extra=None, res=3.0):
    """The small patch of tests/test_torch_cuda.py at ``res`` mm, with
    ``extra`` primitives (and the mesh lines their sheets lie on)."""
    mb = MeshBuilder()
    mb.add_line("x", [-40, 40, 0.0, -6.0])
    mb.add_line("y", [-40, 40, 0.0, -10.0])
    mb.add_line("z", [-20, 30, -5.0, 10.0])
    mb.add_line("z", np.linspace(0, 1.6, 3))
    grid = mb.build(res)
    s = Scene()
    s.add_material_box("sub", 4.3, 0.005, [-20, -20, 0], [20, 20, 1.6], 0)
    s.add_metal_box("patch", [-15, -12, 1.6], [15, 12, 1.6], priority=10)
    s.add_metal_box("gnd", [-20, -20, 0], [20, 20, 0], priority=10)
    s.add_lumped_port(1, 50.0, [-6, 0, 0], [-6, 0, 1.6], direction="z")
    if extra is not None:
        extra(s)
    return s, grid


def _carve(s):
    """An air box that outranks the patch and the ground: the carve rule."""
    s.add_material_box("air", 1.0, 0.0, [-5, -5, -1], [5, 5, 2], priority=20)


def _sheets(s):
    """Conductive sheets: one on a box rotated about z and translated, one
    stood upright (normal y) by a rotation about x, two flat ones that
    overlap in priority order; and a second port on the same column."""
    s.add_conductive_sheet("rot", 5.8e7 * 35e-6, [-8, -6, 10], [8, 6, 10],
                           priority=12, rotation=rotation_matrix(0, 0, 30),
                           translation=(2.0, 1.0, 0.0))
    s.add_conductive_sheet("upright", 2e3, [-15, -8, 10], [15, 8, 10],
                           priority=13, rotation=rotation_matrix(90, 0, 0))
    s.add_conductive_sheet("flat", 1e3, [-10, -10, -5], [10, 10, -5],
                           priority=11)
    s.add_conductive_sheet("under", 5e2, [-12, -12, -5], [0, 0, -5],
                           priority=11)
    s.add_lumped_port(2, 75.0, [-6, 0, 0], [-6, 0, 1.6], direction="z")


def _polys(s):
    """A PEC plate and a rotated dielectric polyhedron among the materials:
    the ordered NumPy paint with windows."""
    q = np.array([[-10, -10, 5], [10, -8, 8], [12, 10, 12], [-8, 9, 6]], float)
    s.add_polyhedron(make_plate(q, 1.0, s.boxes[1].prop, priority=10))
    s.add_polyhedron(make_plate(q + [0, 0, -12], 2.0,
                                Material("diel", 2.2, 0.01), priority=3,
                                rotation=rotation_matrix(0, 10, 0)))


class _Captured(Exception):
    """Stops a prepare once its scene and grid are known."""


def _scene_of(module, prepare, monkeypatch):
    """The (scene, grid) that ``prepare()`` hands ``module.build_simulation``."""
    seen = {}

    def spy(scene, grid, **kw):
        seen["scene"], seen["grid"] = scene, grid
        raise _Captured

    with monkeypatch.context() as m:
        m.setattr(module, "build_simulation", spy)
        prep = prepare()
    assert not prep.ok and "scene" in seen, prep.message
    return seen["scene"], seen["grid"]


def _mixed(monkeypatch, mesh_quality=1):
    from fdtd_solver_antennas_tpu_torch.solvers import multi_patch_3d as multi

    return _scene_of(multi, lambda: multi.prepare_multi_patch_3d(
        [multi.PatchLike("p", PatchAntennaParams.from_user_units(**PATCH))],
        horns=[multi.HornLike("h", HornAntennaParams.from_user_units(
            **MIXED_HORN), center_x_m=0.18, rot_z_deg=25.0)],
        device="cpu", mesh_quality=mesh_quality, phi_step_deg=30.0,
        theta_step_deg=15.0), monkeypatch)


def _horn(monkeypatch):
    from fdtd_solver_antennas_tpu_torch.solvers import horn

    return _scene_of(horn, lambda: horn.prepare_horn(
        HornAntennaParams.from_user_units(
            frequency_ghz=12.0, throat_a_mm=19.05, throat_b_mm=9.525,
            aperture_A_mm=48.0, aperture_B_mm=36.0, length_mm=40.0),
        device="cpu"), monkeypatch)


def _msl(monkeypatch):
    from fdtd_solver_antennas_tpu_torch.solvers import microstrip

    return _scene_of(microstrip, lambda: microstrip.prepare_microstrip_patch(
        PatchAntennaParams.from_user_units(**PATCH), device="cpu",
        port_mode="msl", boundary="PML_8"), monkeypatch)


def _canonical(monkeypatch):
    from fdtd_solver_antennas_tpu_torch.solvers import patch_fixed

    return _scene_of(patch_fixed, lambda: patch_fixed.prepare_patch_fixed(
        PatchAntennaParams.from_user_units(**PATCH), device="cpu"),
        monkeypatch)


SCENES = {
    "small": lambda mp: _small(),
    "carve": lambda mp: _small(_carve),
    "sheets": lambda mp: _small(_sheets),
    "polyhedra": lambda mp: _small(_polys),
    "canonical": _canonical,
    "msl": _msl,
    "mixed_q1": _mixed,
}


def _twin_build(scene, grid, sim, mur):
    """The table and the twins' cells and coefficients for ``sim``'s build."""
    table = grid_build.pack_scene(scene, grid, sim.ports)
    eps, sigma = grid_build.paint_cells(table)
    coeffs = grid_build.edge_coeffs(table, eps, sigma, sim.dt, mur,
                                    sim.padded_shape)
    return table, (eps, sigma), coeffs


def _reference(scene, grid, sim):
    """The host's reference coefficients of ``sim``'s build, as tensors."""
    mur = sim.cfg.boundary.upper().startswith("MUR")
    ref = host_coeffs(scene, grid, sim.ports, sim.dt, mur, sim.padded_shape)
    return {k: torch.from_numpy(v) for k, v in ref.items()}


def _cpu_sim(scene, grid, boundary="MUR", pad=(1, 1, 1), device="cpu"):
    cfg = FDTDConfig(n_steps_max=100, check_every=100, boundary=boundary)
    return build_simulation(
        scene, grid, f0=2.45e9, fc=1.225e9, cfg=cfg, device=device,
        port_freqs_hz=np.linspace(2e9, 3e9, 5),
        nf_freqs_hz=np.array([2.45e9]), pad_multiple=pad)


# ---------------------------------------------------------------------------
# CPU: the table and its twins against the host
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", list(SCENES))
def test_twin_walks_the_table_to_voxelize_bit_for_bit(which, monkeypatch):
    scene, grid = SCENES[which](monkeypatch)
    sim = _cpu_sim(scene, grid,
                   boundary="PML_8" if which == "msl" else "MUR")
    table, (eps, sigma), _ = _twin_build(scene, grid, sim, True)
    vox = voxelize(scene, grid)
    np.testing.assert_array_equal(eps.numpy(), vox.eps_r)
    np.testing.assert_array_equal(sigma.numpy(), vox.sigma)
    for c, comp in enumerate("xyz"):
        pec, add = grid_build.edge_raster_plain(table, c)
        np.testing.assert_array_equal(pec.numpy(), getattr(vox, "pec_e" + comp))
        want = getattr(vox, "sheet_sigma_e" + comp)
        assert (add is None) == (want is None), comp
        if want is not None:
            np.testing.assert_array_equal(add.numpy(), want)
    assert (vox.eps_r > 1.0).any() and vox.pec_ex.any()
    if which == "sheets":  # every component carries sheet current
        assert all(getattr(vox, "sheet_sigma_e" + c) is not None
                   for c in "xyz")
    if which == "carve":
        assert table.carve


@pytest.mark.parametrize("which,boundary,pad", [
    ("small", "MUR", (1, 1, 1)), ("small", "PEC", (1, 1, 1)),
    ("small", "PML_4", (1, 1, 1)), ("small", "MUR", (2, 1, 1)),
    ("small", "MUR", (3, 2, 4)), ("carve", "MUR", (1, 1, 1)),
    ("sheets", "MUR", (1, 1, 1)), ("polyhedra", "PML_4", (2, 1, 1)),
    ("canonical", "PML_8", (1, 1, 1)), ("msl", "PML_8", (1, 1, 1)),
    ("mixed_q1", "MUR", (1, 1, 1))])
def test_twin_coefficients_equal_the_host_build(which, boundary, pad,
                                                 monkeypatch):
    scene, grid = SCENES[which](monkeypatch)
    sim = _cpu_sim(scene, grid, boundary, pad)
    _, _, coeffs = _twin_build(scene, grid, sim, boundary == "MUR")
    ref = _reference(scene, grid, sim)
    assert set(coeffs) == set(sim.coeffs) == set(ref) == set(KEYS)
    for k in KEYS:
        assert coeffs[k].dtype == torch.float32
        assert tuple(coeffs[k].shape) == sim.padded_shape
        assert torch.equal(coeffs[k], ref[k]), k
        assert torch.equal(sim.coeffs[k], ref[k]), k


def test_table_holds_the_host_order(monkeypatch):
    """Materials by ascending (priority, insertion), PEC next, sheets by
    descending priority; port folds in scene order; windows as the host
    tests: the native paint everywhere, PEC boxes on every edge."""
    scene, grid = _small(_sheets)
    _carve(scene)
    sim = _cpu_sim(scene, grid)
    t = grid_build.pack_scene(scene, grid, sim.ports)
    assert (t.n_mat, t.n_pec, t.n_sheet, t.n_fold) == (2, 2, 4, 2)
    prios = [t.irec(m)[4] for m in range(t.n_mat + t.n_pec + t.n_sheet)]
    assert prios == [0, 20, 10, 10, 13, 12, 11, 11]
    sheet_vals = [float(t.rec(m)[21]) for m in range(4, 8)]
    assert sheet_vals == [2e3, 5.8e7 * 35e-6, 1e3, 5e2]  # ties keep order
    assert [t.irec(m)[5] for m in range(4, 8)] == [1, 2, 2, 2]  # normals
    assert t.carve
    q = grid.shape
    assert t.window(0, 0) == tuple(slice(0, n - 1) for n in q)
    assert t.window(2, 1) == tuple(slice(0, n) for n in q)
    folds = t.i32[t.fold_ioff:].view(-1, grid_build.FOLD_I).tolist()
    assert len(folds) == len(sim.ports) == 2
    for f, (fr, prt) in enumerate(zip(folds, sim.ports)):
        assert fr[0] == prt.axis == 2
        box = [(s, s + 1) if isinstance(s, int) else (s.start, s.stop)
               for s in prt.sl]
        assert fr[1:7] == [v for lo_hi in box for v in lo_hi]
        assert float(t.f64[t.fold_off + f]) == prt.sigma_p
    for a, kind in enumerate(("lines", "cpad", "dual")):
        assert t.vec(kind, a).numel() == q[a]
    np.testing.assert_array_equal(t.vec("lines", 1).numpy(), grid.y)
    np.testing.assert_array_equal(t.vec("dual", 2).numpy(),
                                  grid.dual_deltas_m("z"))


def _kernel_walk(t, dt, mur, padded_shape):
    """``csrc/grid_build.cu``'s two kernels transcribed line for line into
    Python, one cell and one edge at a time, reading the flat table at the
    kernels' offsets: (eps, sigma, {key: (padded) float32 array})."""
    tab, itab = t.f64.numpy(), t.i32.numpy()
    REC_D, REC_I, WIN, FOLD_I = (grid_build.REC_D, grid_build.REC_I,
                                 grid_build.WIN, grid_build.FOLD_I)
    q = t.q

    def in_window(w, i, j, k):
        return w[0] <= i < w[1] and w[2] <= j < w[3] and w[4] <= k < w[5]

    def contains(m, x, y, z):
        r, ri = tab[m * REC_D:], itab[m * REC_I:]
        p0, p1, p2 = x - r[18], y - r[19], z - r[20]
        if ri[1]:
            q0, q1, q2 = p0 - r[15], p1 - r[16], p2 - r[17]
            p0 = q0 * r[6] + q1 * r[9] + q2 * r[12] + r[15]
            p1 = q0 * r[7] + q1 * r[10] + q2 * r[13] + r[16]
            p2 = q0 * r[8] + q1 * r[11] + q2 * r[14] + r[17]
        if ri[0] == 0:
            return (r[0] <= p0 <= r[3] and r[1] <= p1 <= r[4]
                    and r[2] <= p2 <= r[5])
        pl = t.planes_off + 4 * ri[2]
        for _ in range(ri[3]):
            if not p0 * tab[pl] + p1 * tab[pl + 1] + p2 * tab[pl + 2] <= tab[pl + 3]:
                return False
            pl += 4
        return True

    n = (q[0] - 1, q[1] - 1, q[2] - 1)
    eps, sigma = np.empty(n[0] * n[1] * n[2]), np.empty(n[0] * n[1] * n[2])
    for tt in range(eps.size):  # paint_cells_kernel
        k, r = tt % n[2], tt // n[2]
        j, i = r % n[1], r // n[1]
        x, y, z = (tab[t.cpad_off[a] + v] for a, v in enumerate((i, j, k)))
        e, s = grid_build.BACKGROUND_EPS, 0.0
        for m in range(t.n_mat):
            if in_window(itab[m * REC_I + WIN:], i, j, k) and contains(m, x, y, z):
                e, s = tab[m * REC_D + 21], tab[m * REC_D + 22]
        eps[tt], sigma[tt] = e, s
    out = {}
    P = tuple(padded_shape)
    for c, comp in enumerate(("ex", "ey", "ez")):  # edge_coeffs_kernel
        ca_o, cb_o = np.zeros(P, np.float32), np.zeros(P, np.float32)
        for i, j, k in np.ndindex(*P):
            if i >= q[0] or j >= q[1] or k >= q[2]:
                continue  # a pad cell: zero
            idx = (i, j, k)
            pt = [tab[(t.cpad_off[a] if a == c else t.lines_off[a]) + idx[a]]
                  for a in range(3)]
            wo = WIN + 6 * (1 + c)
            pec_prio = grid_build.NEG
            for m in range(t.n_mat, t.n_mat + t.n_pec):
                prio = itab[m * REC_I + 4]
                if (prio > pec_prio and in_window(itab[m * REC_I + wo:], *idx)
                        and contains(m, *pt)):
                    pec_prio = prio
            pec = pec_prio > grid_build.NEG
            if pec and t.carve:
                mat_prio = grid_build.NEG
                for m in range(t.n_mat):
                    prio = itab[m * REC_I + 4]
                    if (prio > mat_prio and in_window(itab[m * REC_I + wo:], *idx)
                            and contains(m, *pt)):
                        mat_prio = prio
                pec = pec_prio >= mat_prio
            if pec:
                continue
            lo, hi = [0] * 3, [0] * 3
            for a in range(3):
                hi[a] = idx[a] if idx[a] < n[a] else n[a] - 1
                lo[a] = hi[a] if a == c else max(idx[a] - 1, 0)
            u, v = (1 if c == 0 else 0), (1 if c == 2 else 2)
            off = []
            for w in range(4):
                at = list(lo)
                at[u] = hi[u] if w & 1 else lo[u]
                at[v] = hi[v] if w & 2 else lo[v]
                off.append((at[0] * n[1] + at[1]) * n[2] + at[2])
            H = 0.5
            e_avg = H * (H * (eps[off[0]] + eps[off[1]])
                         + H * (eps[off[2]] + eps[off[3]]))
            sig = H * (H * (sigma[off[0]] + sigma[off[1]])
                       + H * (sigma[off[2]] + sigma[off[3]]))
            s0 = t.n_mat + t.n_pec
            for m in range(s0, s0 + t.n_sheet):
                na = itab[m * REC_I + 5]
                if (na != c and in_window(itab[m * REC_I + wo:], *idx)
                        and contains(m, *pt)):
                    ni = min(idx[na], q[na] - 1)
                    sig = sig + tab[m * REC_D + 21] / tab[t.dual_off[na] + ni]
                    break
            for f in range(t.n_fold):
                fr = itab[t.fold_ioff + f * FOLD_I:]
                if (fr[0] == c and fr[1] <= i < fr[2] and fr[3] <= j < fr[4]
                        and fr[5] <= k < fr[6]):
                    sig = sig + tab[t.fold_off + f]
            e = e_avg * EPS0
            beta = sig * dt / (2.0 * e)
            ca, cb = (1.0 - beta) / (1.0 + beta), (dt / e) / (1.0 + beta)
            if idx[c] == q[c] - 1:
                ca = cb = 0.0
            for b in range(3):
                if b != c and idx[b] in (0, q[b] - 1):
                    ca, cb = (1.0 if mur else 0.0), 0.0
            ca_o[idx], cb_o[idx] = ca, cb
        out["ca_" + comp], out["cb_" + comp] = ca_o, cb_o
    return eps.reshape(n), sigma.reshape(n), out


@pytest.mark.parametrize("which,boundary,pad", [
    ("small", "MUR", (2, 1, 1)), ("carve", "PEC", (1, 1, 1)),
    ("sheets", "MUR", (1, 1, 1)), ("polyhedra", "PML_4", (1, 2, 1))])
def test_kernel_transcription_equals_the_host_build(which, boundary, pad):
    """The kernels' own walk of the table, at the kernels' offsets and in
    their operation order, gives the host's raster and coefficients."""
    extra = {"small": None, "carve": _carve, "sheets": _sheets,
             "polyhedra": _polys}[which]
    scene, grid = _small(extra, res=6.0)
    sim = _cpu_sim(scene, grid, boundary, pad)
    t = grid_build.pack_scene(scene, grid, sim.ports)
    eps, sigma, coeffs = _kernel_walk(t, sim.dt, boundary == "MUR",
                                      sim.padded_shape)
    vox = voxelize(scene, grid)
    np.testing.assert_array_equal(eps, vox.eps_r)
    np.testing.assert_array_equal(sigma, vox.sigma)
    ref = _reference(scene, grid, sim)
    for k in KEYS:
        np.testing.assert_array_equal(coeffs[k], ref[k].numpy(), err_msg=k)
    assert t.carve == (which == "carve")
    assert (vox.sheet_sigma_ex is not None) == (which == "sheets")


def test_table_refuses_a_sheet_on_a_polyhedron():
    scene, grid = _small()
    from fdtd_solver_antennas_tpu_torch.models.scene import ConductiveSheet

    q = np.array([[-10, -10, 5], [10, -8, 8], [12, 10, 12], [-8, 9, 6]], float)
    scene.add_polyhedron(make_plate(q, 1.0, ConductiveSheet("s", 1.0)))
    with pytest.raises(ValueError, match="ConvexPolyhedron"):
        grid_build.pack_scene(scene, grid)


def _matmul_local(prim, pts):
    """World → local as the matrix product the explicit order replaced."""
    pts = np.asarray(pts, float) - np.asarray(prim.translation, float)
    if prim.rotation is not None:
        o = np.asarray(prim.rotation_origin, float)
        pts = (pts - o) @ np.asarray(prim.rotation, float) + o
    return pts


@pytest.mark.parametrize("which", ["mixed_q1", "horn"])
def test_explicit_order_agrees_with_the_matrix_product(which, monkeypatch):
    """The polyhedron test and the rigid transform summed element by
    element give the matrix product's masks on every point set the host
    tests (each primitive's window on the cells and the three edges)."""
    scene, grid = (_horn(monkeypatch) if which == "horn"
                   else _mixed(monkeypatch))
    sets = [tuple(grid.centers(n) for n in "xyz")]
    sets += [_edge_axes(grid, c) for c in ("ex", "ey", "ez")]
    polys = rotated = tested = 0
    for prim in scene.boxes:
        for axes in sets:
            sl = _poly_window(prim, *axes, pad=1e-6)
            if sl is None:
                continue
            sub = np.stack(np.meshgrid(axes[0][sl[0]], axes[1][sl[1]],
                                       axes[2][sl[2]], indexing="ij"), -1)
            local = _matmul_local(prim, sub)
            if isinstance(prim, ConvexPolyhedron):
                n = np.asarray(prim.planes, float)
                want = np.all(local @ n[:, :3].T <= n[:, 3] + 1e-9, axis=-1)
            else:
                want = np.all((local >= prim.lo - 1e-9)
                              & (local <= prim.hi + 1e-9), axis=-1)
            np.testing.assert_array_equal(prim.contains(sub), want)
            tested += want.sum()
        polys += isinstance(prim, ConvexPolyhedron)
        rotated += prim.rotation is not None
    assert polys == 4 and tested > 0
    if which == "mixed_q1":
        assert rotated > 0


def test_cpu_build_counts_on_device_zero():
    scene, grid = _small()
    before = {r.index for r in tracing.records()}
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        sim = _cpu_sim(scene, grid)
    vox = [r for r in tracing.records() if r.index not in before
           and r.name == "fdtd.prepare.voxelize"]
    assert [r.counts for r in vox] == [{"on_device": 0}]
    assert grid_build.launches == dict.fromkeys(grid_build.KERNELS, 0)
    ref = _reference(scene, grid, sim)
    for k in KEYS:
        assert torch.equal(sim.coeffs[k], ref[k]), k


def test_host_copies_fill_on_demand_from_the_coefficients():
    scene, grid = _small()
    sim = _cpu_sim(scene, grid, pad=(2, 1, 1))
    want = {k: v.copy() for k, v in sim._coeffs_np.items()}
    bare = dataclasses.replace(sim, _coeffs_host=None)
    got = bare._coeffs_np
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert bare._coeffs_np is got  # filled once


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CUDA kernels have no CPU mode)")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.fixture
def packs(monkeypatch):
    """The (scene, grid, ports) of every table the builds pack."""
    seen, real = [], grid_build.pack_scene

    def record(scene, grid, ports=()):
        seen.append((scene, grid, ports))
        return real(scene, grid, ports)

    monkeypatch.setattr(grid_build, "pack_scene", record)
    return seen


def _same_build(card, host, packs):
    """Every coefficient and source column of the card's build and the
    CPU's, bit for bit, and the card's coefficients against the host's
    reference of the same scene and grid."""
    assert card.device.type == "cuda" and host.device.type == "cpu"
    assert card.padded_shape == host.padded_shape
    assert set(card.coeffs) == set(host.coeffs)
    for k in card.coeffs:
        assert torch.equal(card.coeffs[k].cpu(), host.coeffs[k]), k
    scene, grid = next((s, g) for s, g, p in packs if p is card.ports)
    ref = _reference(scene, grid, card)
    assert set(ref) == set(card.coeffs)
    for k in card.coeffs:
        assert torch.equal(card.coeffs[k].cpu(), ref[k]), k
    assert len(card.ports) == len(host.ports)
    for a, b in zip(card.ports, host.ports):
        np.testing.assert_array_equal(a.src_col, b.src_col)
        np.testing.assert_array_equal(a.src_col_unit, b.src_col_unit)
    assert len(card.msl_ports) == len(host.msl_ports)
    for a, b in zip(card.msl_ports, host.msl_ports):
        np.testing.assert_array_equal(a.src_col, b.src_col)
        np.testing.assert_array_equal(a.src_col_unit, b.src_col_unit)
    for a, b in zip(card.operands.src, host.operands.src):
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a.cpu(), b)


def _on_device_counts(build):
    before = {r.index for r in tracing.records()}
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        out = build()
    counts = [r.counts["on_device"] for r in tracing.records()
              if r.index not in before and r.name == "fdtd.prepare.voxelize"]
    return out, counts


@pytest.mark.cuda
@pytest.mark.parametrize("which,boundary,pad", [
    ("small", "MUR", (2, 1, 1)), ("carve", "MUR", (1, 1, 1)),
    ("sheets", "PEC", (1, 1, 1)), ("polyhedra", "PML_4", (1, 1, 1))])
def test_kernels_equal_their_twins(cuda, which, boundary, pad, monkeypatch):
    scene, grid = SCENES[which](monkeypatch)
    sim = _cpu_sim(scene, grid, boundary, pad)
    table = grid_build.pack_scene(scene, grid, sim.ports).to(cuda)
    grid_build.reset_launch_counts()
    cells = grid_build.paint_cells(table)
    coeffs = grid_build.edge_coeffs(table, *cells, sim.dt, boundary == "MUR",
                                    sim.padded_shape)
    assert grid_build.launches == {"paint_cells": 1, "edge_coeffs": 1}
    plain_cells = grid_build.paint_cells_plain(table)
    plain = grid_build.edge_coeffs_plain(table, *plain_cells, sim.dt,
                                         boundary == "MUR", sim.padded_shape)
    for a, b in zip(cells, plain_cells):
        assert torch.equal(a, b)
    ref = _reference(scene, grid, sim)
    for k in KEYS:
        assert torch.equal(coeffs[k], plain[k]), k
        assert torch.equal(coeffs[k].cpu(), ref[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("which,boundary,pad", [
    ("small", "MUR", (1, 1, 1)), ("small", "MUR", (2, 1, 1)),
    ("carve", "MUR", (1, 1, 1)), ("sheets", "MUR", (1, 1, 1)),
    ("polyhedra", "PML_4", (2, 1, 1)), ("msl", "PML_8", (1, 1, 1))])
def test_card_build_equals_the_host_build(cuda, which, boundary, pad,
                                          monkeypatch, packs):
    scene, grid = SCENES[which](monkeypatch)
    host, cpu_counts = _on_device_counts(
        lambda: _cpu_sim(scene, grid, boundary, pad))
    card, card_counts = _on_device_counts(
        lambda: _cpu_sim(scene, grid, boundary, pad, device=cuda))
    assert cpu_counts == [0] and card_counts == [1]
    _same_build(card, host, packs)
    assert card._coeffs_host is None
    got = card._coeffs_np  # filled on demand from the card's tensors
    for k, v in host._coeffs_np.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


@pytest.mark.cuda
@pytest.mark.parametrize("boundary", ["MUR", "PML_8"])
def test_canonical_patch_card_build_equals_the_host_build(cuda, boundary,
                                                           packs):
    from fdtd_solver_antennas_tpu_torch.solvers.patch_fixed import (
        prepare_patch_fixed,
    )

    preps = [prepare_patch_fixed(PatchAntennaParams.from_user_units(**PATCH),
                                 boundary=boundary, device=d)
             for d in (cuda, "cpu")]
    assert all(p.ok for p in preps), [p.message for p in preps]
    _same_build(preps[0].sim, preps[1].sim, packs)


@pytest.mark.cuda
def test_msl_microstrip_card_build_equals_the_host_build(cuda, packs):
    from fdtd_solver_antennas_tpu_torch.solvers.microstrip import (
        prepare_microstrip_patch,
    )

    preps = [prepare_microstrip_patch(
        PatchAntennaParams.from_user_units(**PATCH), device=d,
        port_mode="msl", boundary="PML_8") for d in (cuda, "cpu")]
    assert all(p.ok for p in preps), [p.message for p in preps]
    assert preps[0].sim.msl_ports
    _same_build(preps[0].sim, preps[1].sim, packs)


@pytest.mark.cuda
def test_mixed_scene_card_build_equals_the_host_build(cuda, packs):
    """The mixed patch+horn scene at mesh quality 2, as the benchmark's
    design cell and the smoke build it."""
    from fdtd_solver_antennas_tpu_torch.examples.scenes import mixed_designer

    sims = []
    for dev in ("cuda", "cpu"):
        scene = mixed_designer()
        scene.device = dev
        prep = scene.prepare()
        assert prep.ok, prep.message
        sims.append(prep.sim)
    assert sims[0].grid.shape == (141, 201, 152)
    _same_build(*sims, packs)


@pytest.mark.cuda
@pytest.mark.parametrize("shared", [True, False])
def test_sweep_builds_equal_the_host_builds(cuda, shared, packs):
    """The delta path's naked build and, where the substrates differ, the
    per-variant builds on worker threads, stacked."""
    from fdtd_solver_antennas_tpu_torch.solvers.sweep import (
        prepare_patch_geometry_sweep,
    )

    variants = [PatchAntennaParams.from_user_units(
        frequency_ghz=2.45, er=4.3 if shared else 4.3 + 0.1 * i, h_mm=1.6,
        loss_tangent=0.02, W_mm=37.26 + 0.5 * i, L_mm=28.83 + 0.4 * i)
        for i in range(3)]
    preps = [prepare_patch_geometry_sweep(variants, device=d)
             for d in (cuda, "cpu")]
    assert all(p.ok for p in preps), [p.message for p in preps]
    _same_build(preps[0].sim, preps[1].sim, packs)
    for k in KEYS:
        assert torch.equal(preps[0].batched_coeffs[k].cpu(),
                           preps[1].batched_coeffs[k]), k
