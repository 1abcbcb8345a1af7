"""The port's multi-antenna slice against the JAX package on the CPU.

The mixed patch+horn scene of ``tests/test_solvers.py`` (mesh quality 1,
auto margin (60, 60, 80) mm) and the 12 GHz horn of ``tests/test_horn.py``
are prepared by both packages: grid lines, ca/cb, source stamps, port
runtimes and the voxelized PEC masks must be bit-equal. A short run (one
chunk) through the port's plain twins must then match the JAX XLA path at
rtol 2e-4 and atol 1e-5·max|ref|, and so must S11 per port and the
far-field grid. The designer's bookkeeping is held to the JAX one.
"""

import dataclasses

import numpy as np
import pytest
import torch

import fdtd_solver_antennas_tpu.solvers.horn as jhorn_mod
import fdtd_solver_antennas_tpu.solvers.multi_patch_3d as jmulti_mod
from fdtd_solver_antennas_tpu.frontends.designer import MultiPatchScene as JDesigner
from fdtd_solver_antennas_tpu.models.params import HornAntennaParams as JHorn
from fdtd_solver_antennas_tpu.models.params import PatchAntennaParams as JPatch
from fdtd_solver_antennas_tpu.ops.fdtd import rebuild_run_fn
from fdtd_solver_antennas_tpu.ops.voxelize import voxelize as jvoxelize

import fdtd_solver_antennas_tpu_torch.solvers.horn as horn_mod
import fdtd_solver_antennas_tpu_torch.solvers.multi_patch_3d as multi_mod
from fdtd_solver_antennas_tpu_torch.frontends.designer import MultiPatchScene
from fdtd_solver_antennas_tpu_torch.models.params import (
    HornAntennaParams,
    PatchAntennaParams,
)
from fdtd_solver_antennas_tpu_torch.ops.voxelize import voxelize

RTOL = 2e-4
THREADS = 2  # PyTorch intra-op threads while this file runs
PATCH = dict(frequency_ghz=2.45, er=4.3, h_mm=1.6, loss_tangent=0.02)
MIXED_HORN = dict(frequency_ghz=2.45, throat_a_mm=86.0, throat_b_mm=43.0,
                  aperture_A_mm=150.0, aperture_B_mm=110.0, length_mm=60.0)
HORN_12 = dict(frequency_ghz=12.0, throat_a_mm=19.05, throat_b_mm=9.525,
               aperture_A_mm=48.0, aperture_B_mm=36.0, length_mm=40.0)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Test workers share the cores (pytest-xdist); PyTorch's default of
    one intra-op thread per core would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(n)


def _close(a, b, rtol=RTOL):
    a = a.numpy() if torch.is_tensor(a) else np.asarray(a)
    b = np.asarray(b)
    atol = 1e-5 * max(float(np.abs(b).max()), 1e-20)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


def _capture(monkeypatch, module, store):
    """Record the scene each ``build_simulation`` call of ``module`` gets."""
    real = module.build_simulation

    def spy(scene, grid, **kw):
        store["scene"] = scene
        return real(scene, grid, **kw)

    monkeypatch.setattr(module, "build_simulation", spy)


def _capture_run(sim, store):
    """Keep the raw output of ``sim.run`` (the solvers return results)."""
    real = sim.run

    def run(*a, **kw):
        store["out"] = real(*a, **kw)
        return store["out"]

    sim.run = run


def _assert_same_prepare(p, j, scenes):
    ps, js = p.sim, j.sim
    assert ps.grid.shape == js.grid.shape
    for ax in "xyz":
        np.testing.assert_array_equal(ps.grid.lines[ax], js.grid.lines[ax])
    assert ps.dt == js.dt and ps.probe_decim == js.probe_decim
    assert ps.n_source_steps == js.n_source_steps
    np.testing.assert_array_equal(ps.waveform, np.asarray(js.waveform))
    np.testing.assert_array_equal(ps.port_freqs_hz, js.port_freqs_hz)
    np.testing.assert_array_equal(ps.nf_freqs_hz, js.nf_freqs_hz)
    assert set(ps.coeffs) == set(js._coeffs_np)
    for k, v in js._coeffs_np.items():
        np.testing.assert_array_equal(ps.coeffs[k].numpy(), v, err_msg=k)
    assert len(ps.ports) == len(js.ports)
    for a, b in zip(ps.ports, js.ports):
        assert (a.axis, a.sl, a.i_gather, a.i_lengths) == \
            (b.axis, b.sl, b.i_gather, b.i_lengths)
        assert a.spec.excite == b.spec.excite
        np.testing.assert_array_equal(a.dl_m, b.dl_m)
        np.testing.assert_array_equal(a.src_col, b.src_col)
    for m, stamp in enumerate(ps.operands.src):
        want = np.zeros(ps.padded_shape, np.float32)
        for b in js.ports:
            if b.axis == m:
                want[b.sl] += b.src_col
        got = np.zeros_like(want) if stamp is None else stamp.numpy()
        np.testing.assert_array_equal(got, want)
    pv = voxelize(scenes["port"]["scene"], ps.grid)
    jv = jvoxelize(scenes["jax"]["scene"], js.grid)
    for name in ("pec_ex", "pec_ey", "pec_ez"):
        np.testing.assert_array_equal(getattr(pv, name), getattr(jv, name))
    np.testing.assert_array_equal(pv.eps_r, jv.eps_r)


def _assert_same_run(p_out, j_out, p_res, j_res):
    assert int(p_out["steps"]) == int(j_out["steps"])
    _close(p_out["e_ratio"], float(j_out["e_ratio"]))
    for fa, fb in zip(p_out["fields"], j_out["fields"], strict=True):
        _close(fa, fb)
    for key in ("uf", "if_"):
        _close(p_out[key], j_out[key])
    for key in ("nf_e", "nf_h"):
        for a, b in zip(p_out[key], j_out[key], strict=True):
            _close(a, b)
    assert p_res.ok and j_res.ok, (p_res.message, j_res.message)
    _close(p_res.s11, j_res.s11)
    _close(p_res.intensity, j_res.intensity)
    _close(p_res.Dmax, j_res.Dmax)
    assert p_res.f_res_hz == pytest.approx(j_res.f_res_hz, rel=RTOL)


def _short(prep, n_steps, check_every, jax_sim=False):
    """Cut the prepared run to ``n_steps`` (whole chunks of
    ``check_every // decimation`` probe intervals)."""
    prep.sim.cfg = dataclasses.replace(
        prep.sim.cfg, n_steps_max=n_steps, check_every=check_every)
    if jax_sim:
        rebuild_run_fn(prep.sim)


def test_horn_params_round_trip_from_jax():
    j = JHorn.from_user_units(**HORN_12)
    p = HornAntennaParams.from_dict(j.model_dump())
    assert p == HornAntennaParams.from_user_units(**HORN_12)
    assert p.to_dict() == j.model_dump()
    assert p.throat_a_mm == pytest.approx(j.throat_a_mm)
    with pytest.raises(ValueError, match="length_m"):
        HornAntennaParams.from_user_units(**{**HORN_12, "length_mm": 0.0})


def test_horn_analytics_match_jax():
    p = HornAntennaParams.from_user_units(**HORN_12)
    j = JHorn.from_user_units(**HORN_12)
    assert horn_mod.pyramidal_horn_directivity_dbi(p) == \
        jhorn_mod.pyramidal_horn_directivity_dbi(j)
    assert horn_mod.te10_guide_wavelength(10e9, 22.86e-3) == \
        jhorn_mod.te10_guide_wavelength(10e9, 22.86e-3)
    with pytest.raises(ValueError, match="below the TE10 cutoff"):
        horn_mod.te10_guide_wavelength(5e9, 22.86e-3)


def test_mixed_patch_horn_scene_matches_jax(monkeypatch):
    from fdtd_solver_antennas_tpu.solvers.multi_patch_3d import HornLike as JHornLike
    from fdtd_solver_antennas_tpu.solvers.multi_patch_3d import PatchLike as JPatchLike

    kw = dict(mesh_quality=1, phi_step_deg=30.0, theta_step_deg=15.0,
              auto_margin_mm=(60.0, 60.0, 80.0))
    scenes = {"port": {}, "jax": {}}
    _capture(monkeypatch, multi_mod, scenes["port"])
    _capture(monkeypatch, jmulti_mod, scenes["jax"])
    logs = []
    p = multi_mod.prepare_multi_patch_3d(
        [multi_mod.PatchLike("p", PatchAntennaParams.from_user_units(**PATCH))],
        horns=[multi_mod.HornLike(
            "h", HornAntennaParams.from_user_units(**MIXED_HORN),
            center_x_m=0.16, rot_z_deg=30.0)],
        device="cpu", log_cb=logs.append, **kw)
    j = jmulti_mod.prepare_multi_patch_3d(
        [JPatchLike("p", JPatch.from_user_units(**PATCH))],
        horns=[JHornLike("h", JHorn.from_user_units(**MIXED_HORN),
                         center_x_m=0.16, rot_z_deg=30.0)], **kw)
    assert p.ok and j.ok, (p.message, j.message)
    assert p.diagnostics == j.diagnostics
    assert any(m.startswith("engine path: stream kernel") for m in logs), logs
    assert p.sim.pallas_mode == "stream" and p.sim.stream_T == 4
    np.testing.assert_array_equal(p.theta, j.theta)
    np.testing.assert_array_equal(p.phi, j.phi)
    _assert_same_prepare(p, j, scenes)

    # one chunk, one probe interval of 316 steps, through the port's plain
    # twins and the XLA path (by 120 steps the wave has not yet crossed
    # the Huygens box, and the far field would compare rounding noise)
    _short(p, 300, 500)
    _short(j, 300, 500, jax_sim=True)
    p_run, j_run = {}, {}
    _capture_run(p.sim, p_run)
    _capture_run(j.sim, j_run)
    p_res = multi_mod.run_prepared_multi_patch_3d(p, frequency_hz=2.45e9, verbose=0)
    j_res = jmulti_mod.run_prepared_multi_patch_3d(j, frequency_hz=2.45e9, verbose=0)
    _assert_same_run(p_run["out"], j_run["out"], p_res, j_res)
    assert p_res.steps_run == 316
    assert len(p_res.diagnostics["s11_all_ports"]) == 2
    for a, b in zip(p_res.diagnostics["s11_all_ports"],
                    j_res.diagnostics["s11_all_ports"], strict=True):
        _close(a, b)


def test_horn_12ghz_matches_jax(monkeypatch):
    kw = dict(mesh_ppw=14.0, theta_step_deg=5.0, phi_step_deg=15.0,
              n_steps_max=300)
    scenes = {"port": {}, "jax": {}}
    _capture(monkeypatch, horn_mod, scenes["port"])
    _capture(monkeypatch, jhorn_mod, scenes["jax"])
    p = horn_mod.prepare_horn(HornAntennaParams.from_user_units(**HORN_12),
                              device="cpu", **kw)
    j = jhorn_mod.prepare_horn(JHorn.from_user_units(**HORN_12), **kw)
    assert p.ok and j.ok, (p.message, j.message)
    assert p.sim.pallas_mode == "chunk"
    np.testing.assert_array_equal(p.nf_center, j.nf_center)
    _assert_same_prepare(p, j, scenes)
    # two chunks of ten probe intervals (decimation 11): 220 steps
    _short(p, 220, 110)
    _short(j, 220, 110, jax_sim=True)
    p_run, j_run = {}, {}
    _capture_run(p.sim, p_run)
    _capture_run(j.sim, j_run)
    p_res = horn_mod.run_prepared_horn(p, frequency_hz=12e9, verbose=0)
    j_res = jhorn_mod.run_prepared_horn(j, frequency_hz=12e9, verbose=0)
    _assert_same_run(p_run["out"], j_run["out"], p_res, j_res)


def test_designer_bookkeeping_matches_jax():
    events = []
    scene, jscene = MultiPatchScene(device="cpu"), JDesigner()
    scene.set_change_callback(lambda: events.append(1))
    p1 = scene.add_patch(PatchAntennaParams.from_user_units(**PATCH))
    h1 = scene.add_horn(HornAntennaParams.from_user_units(**MIXED_HORN),
                        center_x_m=0.18, rot_z_deg=25.0)
    jscene.add_patch(JPatch.from_user_units(**PATCH))
    jscene.add_horn(JHorn.from_user_units(**MIXED_HORN),
                    center_x_m=0.18, rot_z_deg=25.0)
    assert (p1.name, h1.name) == ("Patch 1", "Horn 2")
    for a, b in zip(scene.scene_bounds_mm(), jscene.scene_bounds_mm()):
        np.testing.assert_array_equal(a, b)
    for inst, jinst in zip(scene.patches + scene.horns,
                           jscene.patches + jscene.horns):
        for a, b in zip(scene.instance_bounds_mm(inst),
                        jscene.instance_bounds_mm(jinst)):
            np.testing.assert_array_equal(a, b)
    scene.update_field(p1, "rot_z_deg", 45.0)
    assert p1.rot_z_deg == 45.0
    scene.update_fields(h1, {"center_y_m": 0.05, "rot_x_deg": 10.0})
    assert (h1.center_y_m, h1.rot_x_deg) == (0.05, 10.0)
    with pytest.raises(AttributeError):
        scene.update_field(p1, "not_a_field", 1)
    scene.remove(h1)
    assert not scene.horns and len(scene.patches) == 1
    assert len(events) == 5  # add, add, update, update, remove


def test_designer_controls_and_guards():
    assert dataclasses.asdict(MultiPatchScene().controls) == \
        dataclasses.asdict(JDesigner().controls)
    scene = MultiPatchScene(device="cpu")
    with pytest.raises(ValueError, match="no antenna"):
        scene.simulate()
    scene.add_patch(PatchAntennaParams.from_user_units(**PATCH))
    scene.locked = True
    with pytest.raises(RuntimeError, match="locked"):
        scene.simulate()
    scene.locked = False
    scene.controls.mesh_quality = 1
    scene.controls.theta_step_deg = 15.0
    scene.controls.phi_step_deg = 45.0
    prep = scene.prepare()
    assert prep.ok, prep.message
    assert str(prep.sim.device) == "cpu"
    assert not multi_mod.prepare_multi_patch_3d([], device="cpu").ok


def test_designer_defaults_to_the_card():
    """No silent fallback: without CUDA the default device fails prepare."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    scene = MultiPatchScene()
    scene.add_patch(PatchAntennaParams.from_user_units(**PATCH))
    scene.controls.mesh_quality = 1
    prep = scene.prepare()
    assert not prep.ok and "cuda" in prep.message
