"""The port's single-solver modules against the JAX package's, on the CPU.

``microstrip_3d`` (mesh quality 1, coarse angle steps), the legacy
solver (PML_8, the full-sphere 91×181 grid in radians) and the quasi-2D
slice (PML_8, 4 φ cuts) are prepared by both packages: grid lines, ca/cb,
port frequencies and θ/φ must be equal. One short chunk through the
port's plain twins and the JAX XLA path must give the same raw port DFTs
(rtol 2e-4, atol 1e-5·max|ref|), S11 and Z_in (rtol 1e-3), Dmax (rtol
1e-3) and pattern (0.05 dB), and the port's result must pass the bounds
of ``tests/test_solvers.py::_check_result``. The analytical cavity
model's summary and patterns match at rtol 1e-6.
"""

import numpy as np
import pytest
import torch

from fdtd_solver_antennas_tpu.models.params import PatchAntennaParams as JParams
from fdtd_solver_antennas_tpu.solvers import analytical as janalytical
from fdtd_solver_antennas_tpu.solvers import microstrip_3d as jm3d
from fdtd_solver_antennas_tpu.solvers import patch_2d as j2d
from fdtd_solver_antennas_tpu.solvers import patch_legacy as jlegacy

from fdtd_solver_antennas_tpu_torch.models.params import PatchAntennaParams
from fdtd_solver_antennas_tpu_torch.solvers import analytical
from fdtd_solver_antennas_tpu_torch.solvers import microstrip_3d as m3d
from fdtd_solver_antennas_tpu_torch.solvers import patch_2d
from fdtd_solver_antennas_tpu_torch.solvers import patch_legacy

CANON = dict(frequency_ghz=2.45, er=4.3, h_mm=1.6, loss_tangent=0.02)
STEPS = 300
THREADS = 2  # PyTorch intra-op threads while this file runs


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Test workers share the cores (pytest-xdist); PyTorch's default of
    one intra-op thread per core would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(n)


SOLVERS = {
    "microstrip_3d": (
        (jm3d.prepare_microstrip_patch_3d, jm3d.run_prepared_microstrip_3d),
        (m3d.prepare_microstrip_patch_3d, m3d.run_prepared_microstrip_3d),
        dict(mesh_quality=1, phi_step_deg=30.0, theta_step_deg=10.0),
        True),
    "legacy": (
        (jlegacy.prepare_patch_legacy, jlegacy.run_prepared_legacy),
        (patch_legacy.prepare_patch_legacy, patch_legacy.run_prepared_legacy),
        {}, True),
    "quasi_2d": (
        (j2d.prepare_patch_2d, j2d.run_prepared_2d),
        (patch_2d.prepare_patch_2d, patch_2d.run_prepared_2d),
        {}, False),
}


def _close(a, b, rtol=2e-4):
    a = a.numpy() if torch.is_tensor(a) else np.asarray(a)
    b = np.asarray(b)
    atol = 1e-5 * max(float(np.abs(b).max()), 1e-20)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


def _check_result(res, full_sphere=False):
    """The bounds of tests/test_solvers.py::_check_result."""
    assert res.ok, res.message
    assert res.is_dBi
    assert res.intensity is not None
    assert res.intensity.shape == (len(res.theta), len(res.phi))
    assert np.isfinite(res.intensity).all()
    assert res.s11 is not None and np.isfinite(res.s11).all()
    assert np.all(np.abs(res.s11) < 3.0)
    assert res.f_res_hz is not None
    assert isinstance(res.diagnostics["rad_eff_converged"], bool)
    if full_sphere:
        assert len(res.phi) > 10


def _run_capturing(prep, run_fn):
    captured = {}
    run = prep.sim.run

    def capture(**kw):
        captured["out"] = run(**kw)
        return captured["out"]

    prep.sim.run = capture
    res = run_fn(prep, frequency_hz=2.45e9, verbose=0)
    return res, captured["out"]


@pytest.mark.parametrize("name", list(SOLVERS))
def test_solver_matches_jax(name):
    (jprep, jrun), (tprep, trun), kw, full_sphere = SOLVERS[name]
    jp = jprep(JParams.from_user_units(**CANON), n_steps_max=STEPS, **kw)
    tp = tprep(PatchAntennaParams.from_user_units(**CANON), n_steps_max=STEPS,
               device="cpu", **kw)
    assert jp.ok and tp.ok, (jp.message, tp.message)
    js, ts = jp.sim, tp.sim
    assert not js.use_pallas
    for ax in "xyz":
        np.testing.assert_array_equal(ts.grid.lines[ax], js.grid.lines[ax])
    assert ts.dt == js.dt and ts.probe_decim == js.probe_decim
    assert ts.cfg.boundary == js.cfg.boundary
    np.testing.assert_array_equal(ts.port_freqs_hz, js.port_freqs_hz)
    np.testing.assert_array_equal(ts.nf_freqs_hz, js.nf_freqs_hz)
    np.testing.assert_array_equal(tp.theta, jp.theta)
    np.testing.assert_array_equal(tp.phi, jp.phi)
    for k, v in js._coeffs_np.items():
        np.testing.assert_array_equal(ts._coeffs_np[k], v, err_msg=k)
    assert ts.pallas_mode == "chunk", ts.pallas_mode_reason

    jres, jout = _run_capturing(jp, jrun)
    tres, tout = _run_capturing(tp, trun)
    _check_result(tres, full_sphere)
    _check_result(jres, full_sphere)
    assert tres.steps_run == jres.steps_run >= STEPS
    _close(tout["uf"], jout["uf"])
    _close(tout["if_"], jout["if_"])
    np.testing.assert_array_equal(tres.freq, jres.freq)
    np.testing.assert_allclose(tres.s11, jres.s11, rtol=1e-3)
    np.testing.assert_allclose(tres.z_in, jres.z_in, rtol=1e-3)
    assert tres.f_res_hz == jres.f_res_hz
    np.testing.assert_allclose(tres.Dmax, jres.Dmax, rtol=1e-3)
    np.testing.assert_array_equal(tres.theta, jres.theta)
    np.testing.assert_array_equal(tres.phi, jres.phi)
    np.testing.assert_allclose(tres.intensity, jres.intensity, atol=0.05)


@pytest.mark.parametrize("design", [
    dict(frequency_ghz=2.45, er=4.3, h_mm=1.6, loss_tangent=0.02),
    dict(frequency_ghz=5.8, er=2.2, h_mm=0.787, L_mm=16.0, W_mm=20.0),
])
def test_analytical_matches_jax(design):
    got = analytical.AnalyticalPatchSolver(PatchAntennaParams.from_user_units(**design))
    ref = janalytical.AnalyticalPatchSolver(JParams.from_user_units(**design))
    gs, rs = got.summary(), ref.summary()
    assert set(gs) == set(rs)
    for k in rs:
        np.testing.assert_allclose(gs[k], rs[k], rtol=1e-6, err_msg=k)
    gp, rp = got.compute_full_pattern(91, 73), ref.compute_full_pattern(91, 73)
    for name in ("theta", "phi", "directivity", "gain"):
        a, b = getattr(gp, name), getattr(rp, name)
        np.testing.assert_allclose(a, b, rtol=1e-6,
                                   atol=1e-6 * np.abs(b).max(), err_msg=name)
    for plane in ("E", "H"):
        ta, ga = got.cross_section_gain_lin(plane, num_theta=181)
        tb, gb = ref.cross_section_gain_lin(plane, num_theta=181)
        np.testing.assert_array_equal(ta, tb)
        np.testing.assert_allclose(ga, gb, rtol=1e-6, atol=1e-6 * gb.max())
