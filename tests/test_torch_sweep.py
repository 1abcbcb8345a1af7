"""The geometry sweep (``solvers/sweep.py``) and batched K1 on the CPU.

The JAX package runs a sweep's design variants under ``jax.vmap``
(``fdtd_solver_antennas_tpu/solvers/sweep.py``), which batches its chunk
kernel K1 with the variant as an outer grid dimension. The port runs them
through ``ops/fdtd.py::run_batched``: one ``chunk_steps_batch`` launch per
chunk for all variants on the card, its plain twin
(``chunk_steps_batch_plain``) here. The kernel itself is held to the twin
on the card (``tests/test_torch_cuda.py``). Here, against the JAX package
on the same inputs (its vmapped XLA path, ``use_pallas=False``), at rtol
2e-4, atol 1e-5·max|ref| (the JAX package's own kernel-vs-XLA tolerance):

(a) the delta coefficients: bit-equal to the port's per-variant full
    build and to the JAX package's delta coefficients;
(b) the patch sweep over ``tests/test_sweep.py``'s two geometries, per
    variant (``uf``, ``if_``, ``steps``), the variants' spectra distinct;
(c) the freeze: two variants of a small scene that stop at different
    chunks, per variant ``steps``, ``e_ratio``, ``uf`` and the final
    fields, as ``jax.vmap`` of the JAX run's ``lax.while_loop`` leaves
    them;
(d) the horn aperture sweep at a small mesh: per variant ``uf``, the
    Huygens-face sums and ``nf2ff_transform_batch``'s Dmax;
(e) the wrapper: B = 1 bit-equal to ``chunk_steps_plain``, a frozen
    variant untouched, and the validation the JAX package does.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from fdtd_solver_antennas_tpu import PatchAntennaParams as JPatch
from fdtd_solver_antennas_tpu.models.params import HornAntennaParams as JHorn
from fdtd_solver_antennas_tpu.models.scene import Scene as JScene
from fdtd_solver_antennas_tpu.ops.fdtd import FDTDConfig as JConfig
from fdtd_solver_antennas_tpu.ops.fdtd import build_simulation as jbuild
from fdtd_solver_antennas_tpu.ops.mesh import MeshBuilder as JMeshBuilder
from fdtd_solver_antennas_tpu.post.nf2ff import nf2ff_transform_batch as jnf2ff_batch
from fdtd_solver_antennas_tpu.solvers import sweep as jsweep
from fdtd_solver_antennas_tpu_torch.models.params import (
    HornAntennaParams,
    PatchAntennaParams,
)
from fdtd_solver_antennas_tpu_torch.models.scene import Scene
from fdtd_solver_antennas_tpu_torch.ops import fdtd_cuda
from fdtd_solver_antennas_tpu_torch.ops.fdtd import (
    FDTDConfig,
    build_simulation,
    run_batched,
    run_simulation,
)
from fdtd_solver_antennas_tpu_torch.ops.mesh import MeshBuilder
from fdtd_solver_antennas_tpu_torch.physics import C0
from fdtd_solver_antennas_tpu_torch.solvers import sweep

GEOMS = [(26.0, 33.0), (32.0, 41.0)]  # (L_mm, W_mm), tests/test_sweep.py
RTOL, ATOL_REL = 2e-4, 1e-5


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Test workers share the cores (pytest-xdist)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, ref, what="", rtol=RTOL, atol_rel=ATOL_REL):
    got, ref = np.asarray(got), np.asarray(ref)
    atol = atol_rel * max(float(np.abs(ref).max()), 1e-30)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol, err_msg=what)


def _np(t):
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def _patches(pkg, geoms=GEOMS, **kw):
    cls = JPatch if pkg == "jax" else PatchAntennaParams
    return [cls.from_user_units(frequency_ghz=2.45, er=4.3, h_mm=1.6,
                                L_mm=L, W_mm=W, **kw) for (L, W) in geoms]


# ---------------------------------------------------------------------------
# (a) the delta coefficients
# ---------------------------------------------------------------------------

def _coarse_grid(mb_cls, variants):
    """``tests/test_sweep.py::test_delta_coeffs_match_full_build``'s grid."""
    f0 = 2.45e9
    mesh_res = C0 / (f0 + f0 / 2) / 1e-3 / 12.0
    h = 1.6
    mb = mb_cls()
    mb.add_line("x", [-60.0, 60.0])
    mb.add_line("y", [-60.0, 60.0])
    mb.add_line("z", [-30.0, 60.0])
    mb.add_line("z", np.linspace(0.0, h, 5))
    mb.add_line("x", [-6.0])
    mb.add_line("y", [0.0])
    for v in variants:
        W, L = sweep._patch_dims_mm(v)
        mb.add_metal_edges([-W / 2, -L / 2, h], [W / 2, L / 2, h], dirs="xy")
    return mb.build(mesh_res, ratio=1.4)


def test_delta_coeffs_match_full_build_and_jax():
    geoms = [(26.0, 33.0), (29.0, 37.0), (32.0, 41.0)]
    variants = _patches("torch", geoms, loss_tangent=0.02)
    jvariants = _patches("jax", geoms, loss_tangent=0.02)
    assert sweep._shared_substrate(variants)
    grid = _coarse_grid(MeshBuilder, variants)
    jgrid = _coarse_grid(JMeshBuilder, jvariants)
    for a in "xyz":
        np.testing.assert_array_equal(grid.lines[a], jgrid.lines[a])
    f0, pf, nf = 2.45e9, np.linspace(1.5e9, 3.5e9, 21), np.array([2.45e9])
    cfg = FDTDConfig(n_steps_max=500, end_criteria=1e-4)
    base, batched = sweep._batched_coeffs_delta(
        variants, grid, -6.0, f0, f0 / 2, cfg, pf, nf, device="cpu")
    assert set(batched) == set(base.coeffs)
    _, jbatched = jsweep._batched_coeffs_delta(
        jvariants, jgrid, -6.0, f0, f0 / 2,
        JConfig(n_steps_max=500, end_criteria=1e-4, use_pallas=False), pf, nf)
    for b, v in enumerate(variants):
        full = build_simulation(
            sweep._variant_scene(v, -6.0), grid, f0=f0, fc=f0 / 2, cfg=cfg,
            device="cpu", port_freqs_hz=pf, nf_freqs_hz=nf)
        for k, want in full.coeffs.items():
            got = batched[k][b]
            assert torch.equal(got, want), f"variant {b} {k} != its full build"
            assert np.array_equal(_np(got), np.asarray(jbatched[k][b])), (
                f"variant {b} {k} != the JAX package's delta coefficients")
    # the variants' patches differ, so their coefficients do
    assert not torch.equal(batched["ca_ex"][0], batched["ca_ex"][2])


# ---------------------------------------------------------------------------
# (b) the patch sweep against the JAX package's vmapped run
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def patch_sweeps():
    prep = sweep.prepare_patch_geometry_sweep(
        _patches("torch"), n_steps_max=400, end_criteria=1e-12, device="cpu")
    assert prep.ok, prep.message
    res = sweep.run_patch_geometry_sweep(prep)
    assert res.ok, res.message
    jprep = jsweep.prepare_patch_geometry_sweep(
        _patches("jax"), n_steps_max=400, end_criteria=1e-12, use_pallas=False)
    assert jprep.ok, jprep.message
    jout, _, _ = jsweep._run_batched(jprep)
    return prep, res, jprep, jout


def test_patch_sweep_matches_jax(patch_sweeps):
    """Per variant: the step count and the port's V and I spectra."""
    prep, res, jprep, jout = patch_sweeps
    assert prep.sim.grid.shape == jprep.sim.grid.shape
    np.testing.assert_array_equal(res.steps, np.asarray(jout["steps"]))
    jspectra = jsweep._batched_port_spectra(jprep, jout)
    for b, (sp, jsp) in enumerate(zip(res.spectra, jspectra)):
        _close(sp.uf, jsp.uf, f"variant {b} uf")
        _close(sp.if_, jsp.if_, f"variant {b} if_")


def test_patch_sweep_variants_differ(patch_sweeps):
    """Every variant gets its own spectrum (the silent-broadcast guard)."""
    _prep, res, _jprep, _jout = patch_sweeps
    s0, s1 = (np.abs(sp.s11) for sp in res.spectra)
    assert not np.allclose(s0, s1, rtol=1e-3)
    assert np.isfinite(res.s11_min_db).all()
    assert res.steps_run == int(res.steps.max())


# ---------------------------------------------------------------------------
# (c) variants that stop at different chunks
# ---------------------------------------------------------------------------

# two variants of the small kernel-test scene: a low-loss and a lossier
# substrate under the same patch; at end_criteria 1e-2 and a check every 25
# steps the lossier one stops 13 chunks before the other (1,225 and 1,550
# steps), each at an energy ratio of 6-7e-3, clear of the criterion
FREEZE_VARIANTS = ((0.005, (10.0, 8.0)), (0.05, (10.0, 8.0)))


def _freeze_scene(cls, kappa, half):
    s = cls()
    s.add_material_box("sub", 4.3, kappa, [-20, -20, 0], [20, 20, 1.6], 0)
    s.add_metal_box("patch", [-half[0], -half[1], 1.6],
                    [half[0], half[1], 1.6], priority=10)
    s.add_metal_box("gnd", [-20, -20, 0], [20, 20, 0], priority=10)
    s.add_lumped_port(1, 50.0, [-6, 0, 0], [-6, 0, 1.6], direction="z")
    return s


def _freeze_grid(mb_cls):
    mb = mb_cls()
    mb.add_line("x", [-40, 40, 0.0, -6.0])
    mb.add_line("y", [-40, 40, 0.0])
    mb.add_line("z", [-20, 30])
    mb.add_line("z", np.linspace(0, 1.6, 3))
    return mb.build(5.0)


@pytest.fixture(scope="module")
def freeze_runs():
    run = dict(n_steps_max=3000, end_criteria=1e-2, check_every=25,
               probe_decimation=5)
    kw = dict(f0=2.45e9, fc=1.225e9, port_freqs_hz=np.linspace(2e9, 3e9, 11),
              nf_freqs_hz=np.array([2.45e9]))
    grid = _freeze_grid(MeshBuilder)
    sims = [build_simulation(_freeze_scene(Scene, k, h), grid,
                             cfg=FDTDConfig(**run), device="cpu", **kw)
            for k, h in FREEZE_VARIANTS]
    coeffs = {k: torch.stack([s.coeffs[k] for s in sims]) for k in sims[0].coeffs}
    out = run_batched(sims[0], coeffs)

    jgrid = _freeze_grid(JMeshBuilder)
    jsims = [jbuild(_freeze_scene(JScene, k, h), jgrid,
                    cfg=JConfig(**run, use_pallas=False), **kw)
             for k, h in FREEZE_VARIANTS]
    jprep = jsweep.SweepPrepared(
        True, "", sim=jsims[0], variants=list(FREEZE_VARIANTS),
        batched_coeffs={k: jnp.stack([s.coeffs[k] for s in jsims])
                        for k in jsims[0].coeffs},
        _vrun=jsweep._make_vmapped_run(jsims[0]))
    jout, _, _ = jsweep._run_batched(jprep)
    return sims[0], out, jout


def test_freeze_steps_match_jax(freeze_runs):
    """The variants stop at different chunks, each where the JAX package's
    vmapped while_loop stops it, with its own energy ratio."""
    sim, out, jout = freeze_runs
    steps = out["steps"]
    np.testing.assert_array_equal(steps, np.asarray(jout["steps"]))
    assert steps[0] != steps[1], steps
    assert steps[1] < sim.cfg.n_steps_max  # the lossy variant stopped early
    end = np.float32(sim.cfg.end_criteria)
    assert out["e_ratio"][1] < end
    _close(out["e_ratio"], np.asarray(jout["e_ratio"]), "e_ratio")


def test_freeze_outputs_match_jax(freeze_runs):
    """A frozen variant's DFT sums and fields are those of its stop. The
    fields after 1,225-1,550 steps, decayed below 1% of their peak
    energy, are held at the JAX package's own kernel-vs-XLA sweep bound
    (rtol 2e-3, atol 2e-4·max, ``tests/test_sweep.py``): float32
    rounding of two different schedules accumulates over the run."""
    _sim, out, jout = freeze_runs
    juf = np.asarray(jout["uf"])
    jif = np.asarray(jout["if_"])
    for b in range(len(FREEZE_VARIANTS)):
        _close(out["uf"][b], juf[b, 0] + 1j * juf[b, 1], f"variant {b} uf")
        _close(out["if_"][b], jif[b, 0] + 1j * jif[b, 1], f"variant {b} if_")
        for i, (f, jf) in enumerate(zip(out["fields"], jout["fields"])):
            jf = np.asarray(jf)[b]
            _close(_np(f[b])[tuple(slice(0, n) for n in jf.shape)], jf,
                   f"variant {b} field {i}", rtol=2e-3, atol_rel=2e-4)


# ---------------------------------------------------------------------------
# (d) the horn aperture sweep
# ---------------------------------------------------------------------------

APERTURES = [(30.0, 24.0, 30.0), (55.0, 42.0, 45.0)]
HORN = dict(frequency_ghz=12.0, throat_a_mm=19.05, throat_b_mm=9.525,
            aperture_A_mm=48.0, aperture_B_mm=36.0, length_mm=40.0)
HORN_RUN = dict(mesh_ppw=8.0, n_steps_max=300, end_criteria=1e-12,
                theta_step_deg=15.0, phi_step_deg=30.0)


@pytest.fixture(scope="module")
def horn_sweeps():
    prep = sweep.prepare_horn_aperture_sweep(
        HornAntennaParams.from_user_units(**HORN), APERTURES, device="cpu",
        **HORN_RUN)
    assert prep.ok, prep.message
    runs = []  # the run's raw outputs, kept by a spy on the batched run

    def spy(prepared, impl=None):
        runs.append(run_batched_sweep(prepared, impl))
        return runs[-1]

    run_batched_sweep, sweep._run_batched = sweep._run_batched, spy
    try:
        res = sweep.run_horn_aperture_sweep(prep)
    finally:
        sweep._run_batched = run_batched_sweep
    assert res.ok, res.message
    (out, _, _), = runs
    jprep = jsweep.prepare_horn_aperture_sweep(
        JHorn.from_user_units(**HORN), APERTURES, use_pallas=False, **HORN_RUN)
    assert jprep.ok, jprep.message
    jout, _, _ = jsweep._run_batched(jprep)
    # the JAX package's run_horn_aperture_sweep on this run's outputs
    jffs = jnf2ff_batch(
        jprep.sim.faces, [np.asarray(f) for f in jout["nf_e"]],
        [np.asarray(f) for f in jout["nf_h"]], jprep.sim.dft_dt,
        jprep.sim.nf_freqs_hz, jprep.theta, jprep.phi,
        centers_m=np.asarray(jprep.nf_centers))
    jdmax = np.array([10 * np.log10(ff.Dmax[0]) for ff in jffs])
    return prep, res, out, jdmax, jout


def test_horn_sweep_matches_jax(horn_sweeps):
    """Per variant: steps, the port spectrum and the Huygens-face sums."""
    prep, res, out, _jdmax, jout = horn_sweeps
    np.testing.assert_array_equal(out["steps"], np.asarray(jout["steps"]))
    juf = np.asarray(jout["uf"])
    for b in range(len(APERTURES)):
        _close(out["uf"][b], juf[b, 0] + 1j * juf[b, 1], f"variant {b} uf")
        for key in ("nf_e", "nf_h"):
            for i, (face, jface) in enumerate(zip(out[key], jout[key])):
                _close(face[b], np.asarray(jface)[b], f"variant {b} {key} {i}")


def test_horn_sweep_dmax_matches_jax(horn_sweeps):
    """``nf2ff_transform_batch``'s per-variant Dmax, and the variants'
    gains differ."""
    _prep, res, _out, jdmax, _jout = horn_sweeps
    _close(res.Dmax_dbi, jdmax, "Dmax dBi")
    assert abs(res.Dmax_dbi[1] - res.Dmax_dbi[0]) > 0.5


# ---------------------------------------------------------------------------
# (e) the wrapper and the validation
# ---------------------------------------------------------------------------

def _small_sim(boundary):
    run = dict(n_steps_max=60, end_criteria=1e-30, check_every=60,
               probe_decimation=4, boundary=boundary)
    return build_simulation(
        _freeze_scene(Scene, 0.005, (15.0, 12.0)), _freeze_grid(MeshBuilder),
        f0=2.45e9, fc=1.225e9, cfg=FDTDConfig(**run), device="cpu",
        port_freqs_hz=np.linspace(2e9, 3e9, 11), nf_freqs_hz=np.array([2.45e9]))


def _random_batch(sim, batch, seed):
    rng = np.random.default_rng(seed)
    st = fdtd_cuda.new_batch_state(sim.padded_shape, "cpu",
                                   sim.operands.pml is not None, batch)
    for t in (*st.e[0], *st.e[1], *st.h, *st.psi_e, *st.psi_h):
        t.copy_(torch.from_numpy(rng.standard_normal(t.shape).astype(np.float32)))
    return st


def _tensors(st):
    return (*st.e[0], *st.e[1], *st.h, *st.psi_e, *st.psi_h)


def _batch_ops(sim, batch, seed):
    """The sim's operands with ``batch`` variants of ca/cb: variant 0 the
    sim's own, the others scaled by seeded factors near 1."""
    rng = np.random.default_rng(seed)
    ops = sim.operands
    scale = torch.from_numpy(
        rng.uniform(0.9, 1.1, (batch, 1, 1, 1)).astype(np.float32))
    scale[0] = 1.0
    return fdtd_cuda.batch_operands(
        ops, [c[None] * scale for c in ops.ca], [c[None] * scale for c in ops.cb])


@pytest.mark.parametrize("boundary", ["MUR", "PEC", "PML_4"])
def test_batch_plain_b1_bit_equal_chunk_steps_plain(boundary):
    sim = _small_sim(boundary)
    ops = sim.operands
    D, rows, n_sub = 4, ops.probes.n_rows, 3
    wf = np.random.default_rng(5).uniform(-1, 1, 7 + n_sub * D).astype(np.float32)
    st = _random_batch(sim, 1, seed=11)
    st.parity = [1]
    ref = st.variant(0)
    ref = fdtd_cuda.YeeState(
        e=[tuple(t.clone() for t in ref.e[0]), tuple(t.clone() for t in ref.e[1])],
        h=tuple(t.clone() for t in ref.h), psi_e=tuple(t.clone() for t in ref.psi_e),
        psi_h=tuple(t.clone() for t in ref.psi_h), parity=1)
    bufs = torch.zeros((1, n_sub, rows))
    rbufs = torch.zeros((n_sub, rows))
    fdtd_cuda.chunk_steps_batch(_batch_ops(sim, 1, 0), st, wf, 7, n_sub, D,
                                bufs, [True])
    fdtd_cuda.chunk_steps_plain(ops, ref, wf, 7, n_sub, D, rbufs)
    assert st.parity == [ref.parity] == [1 ^ (n_sub * D) & 1]
    for a, b in zip((*st.variant(0).fields, *st.variant(0).psi_e,
                     *st.variant(0).psi_h, bufs[0]),
                    (*ref.fields, *ref.psi_e, *ref.psi_h, rbufs)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("boundary", ["MUR", "PML_4"])
def test_batch_plain_frozen_variant_untouched(boundary):
    """B = 3 with variant 1 frozen: it keeps every tensor, its samples and
    its parity; the others equal their own chunk_steps_plain."""
    sim = _small_sim(boundary)
    ops = _batch_ops(sim, 3, seed=2)
    D, rows, n_sub = 3, ops.probes.n_rows, 3
    wf = np.random.default_rng(6).uniform(-1, 1, n_sub * D).astype(np.float32)
    st = _random_batch(sim, 3, seed=12)
    before = [t.clone() for t in _tensors(st)]
    bufs = torch.full((3, n_sub, rows), 7.0)
    fdtd_cuda.chunk_steps_batch(ops, st, wf, 0, n_sub, D, bufs,
                                torch.tensor([1, 0, 1], dtype=torch.int32))
    assert st.parity == [1, 0, 1]  # 9 steps flip the active ones
    for t, t0 in zip(_tensors(st), before):
        assert torch.equal(t[1], t0[1])
    assert torch.equal(bufs[1], torch.full((n_sub, rows), 7.0))
    for b in (0, 2):
        ref = _random_batch(sim, 3, seed=12).variant(b)
        rbufs = torch.zeros((n_sub, rows))
        fdtd_cuda.chunk_steps_plain(fdtd_cuda.variant_operands(ops, b), ref,
                                    wf, 0, n_sub, D, rbufs)
        got = st.variant(b)
        for a, r in zip((*got.fields, *got.psi_e, bufs[b]),
                        (*ref.fields, *ref.psi_e, rbufs)):
            assert torch.equal(a, r)
    # the variants' own coefficients were used: 0 and 2 differ
    assert not torch.equal(st.e[1][0][0], st.e[1][0][2])


def test_run_batched_equals_single_runs():
    """B copies of one simulation's coefficients: each variant's run is the
    single run's (the DFT sums up to the batched matmul's rounding)."""
    sim = _small_sim("MUR")
    ref = run_simulation(sim, fdtd_cuda.plain)
    coeffs = {k: torch.stack([v, v]) for k, v in sim.coeffs.items()}
    out = run_batched(sim, coeffs)
    np.testing.assert_array_equal(out["steps"], [ref["steps"]] * 2)
    for b in range(2):
        for f, rf in zip(out["fields"], ref["fields"]):
            assert torch.equal(f[b], rf)
        _close(out["uf"][b], ref["uf"], "uf")
        for face, rface in zip(out["nf_e"], ref["nf_e"]):
            _close(face[b], rface, "nf_e")
    assert out["e_ratio"][0] == pytest.approx(ref["e_ratio"], rel=1e-6)


def test_batch_wrapper_validation():
    sim = _small_sim("MUR")
    ops = _batch_ops(sim, 2, seed=0)
    st = fdtd_cuda.new_batch_state(sim.padded_shape, "cpu", False, 2)
    rows = ops.probes.n_rows
    wf = np.zeros(8, np.float32)
    with pytest.raises(ValueError, match="bufs"):
        fdtd_cuda.chunk_steps_batch(ops, st, wf, 0, 2, 4, torch.zeros((2, rows)),
                                    [True, True])
    with pytest.raises(ValueError, match="active mask"):
        fdtd_cuda.chunk_steps_batch(ops, st, wf, 0, 2, 4,
                                    torch.zeros((2, 2, rows)), [True])
    with pytest.raises(ValueError, match="batched ca/cb"):
        fdtd_cuda.batch_operands(sim.operands, sim.operands.ca, sim.operands.cb)
    with pytest.raises(ValueError, match="at least one variant"):
        fdtd_cuda.new_batch_state(sim.padded_shape, "cpu", False, 0)


def test_sweep_validation_matches_jax():
    """``tests/test_sweep.py::test_sweep_validation``, message for message."""
    for prep, jprep in (
        (sweep.prepare_patch_geometry_sweep([], device="cpu"),
         jsweep.prepare_patch_geometry_sweep([])),
        (sweep.prepare_patch_geometry_sweep(
            [PatchAntennaParams.from_user_units(frequency_ghz=2.45, er=4.3, h_mm=h)
             for h in (1.6, 0.8)], device="cpu"),
         jsweep.prepare_patch_geometry_sweep(
            [JPatch.from_user_units(frequency_ghz=2.45, er=4.3, h_mm=h)
             for h in (1.6, 0.8)])),
        (sweep.prepare_horn_aperture_sweep(
            HornAntennaParams.from_user_units(**HORN), [], device="cpu"),
         jsweep.prepare_horn_aperture_sweep(JHorn.from_user_units(**HORN), [])),
    ):
        assert not prep.ok and not jprep.ok
        assert prep.message == jprep.message
    res = sweep.run_patch_geometry_sweep(sweep.SweepPrepared(False, "no"))
    assert not res.ok and res.message == "no"


def test_sweep_general_path_matches_delta_path():
    """Variants that share the substrate take the delta path; the threaded
    per-variant builds give the same coefficients and source."""
    variants = _patches("torch", [(26.0, 33.0), (29.0, 37.0)], loss_tangent=0.02)
    grid = _coarse_grid(MeshBuilder, variants)
    f0, pf, nf = 2.45e9, np.linspace(1.5e9, 3.5e9, 21), np.array([2.45e9])
    cfg = FDTDConfig(n_steps_max=500, end_criteria=1e-4)
    base, batched = sweep._batched_coeffs_delta(
        variants, grid, -6.0, f0, f0 / 2, cfg, pf, nf, device="cpu")
    sims = [build_simulation(sweep._variant_scene(v, -6.0), grid, f0=f0,
                             fc=f0 / 2, cfg=cfg, device="cpu",
                             port_freqs_hz=pf, nf_freqs_hz=nf)
            for v in variants]
    stacked = sweep._stack_coeffs(sims)
    for k in stacked:
        assert torch.equal(stacked[k], batched[k])
    for a, b in zip(base.operands.src, sims[0].operands.src):
        assert (a is None and b is None) or torch.equal(a, b)
