"""The port's embedded element patterns and array synthesis against the
JAX package's, on the CPU.

The port extracts the embedded patterns of ``tests/test_sparams.py``'s
two-patch scene from its own two one-hot runs (3,000 steps asked, the
runs themselves held to the JAX package's in
``tests/test_torch_sparams.py``). The JAX package's
``compute_embedded_patterns`` then post-processes the very same run
outputs (replayed to it through a stand-in for its prepared simulation),
and the two pattern sets, S matrices, syntheses, steering weights and
run summaries must agree. On the port alone, the invariants of
``tests/test_array_synth.py``: superposition against the all-ports-on
run, mirror-image elements, optimal conjugate steering, passivity. The
pure-NumPy pieces (``pick_resonance``, ``design_array``'s refusals) are
held to the JAX package's on the same inputs.
"""

import copy

import numpy as np
import pytest
import torch

from _multiport_scenes import FREQS, TORCH, two_patches
from fdtd_solver_antennas_tpu.models.params import PatchAntennaParams as JParams
from fdtd_solver_antennas_tpu.solvers import array_synth as jsynth
from fdtd_solver_antennas_tpu.solvers.sparams import SMatrixResult as JSMatrix

from fdtd_solver_antennas_tpu_torch import (
    ArrayPattern,
    EmbeddedPatternSet,
    compute_embedded_patterns,
)
from fdtd_solver_antennas_tpu_torch.models.params import PatchAntennaParams
from fdtd_solver_antennas_tpu_torch.post.nf2ff import (
    nf2ff_transform,
    select_face_freqs,
)
from fdtd_solver_antennas_tpu_torch.solvers.array_synth import (
    ArrayDesignResult,
    _sphere_quadrature,
    array_run_summary,
    design_array,
    pick_resonance,
)
from fdtd_solver_antennas_tpu_torch.solvers.sparams import (
    SMatrixResult,
    compute_s_matrix,
)

NF_FREQ = 2.45e9
THETA = np.arange(0.0, 181.0, 15.0)
PHI = np.arange(0.0, 360.0, 15.0)
THREADS = 2  # PyTorch intra-op threads while this file runs
# The same run outputs through both packages' post-processing: the NF2FF
# integrals run in float32 in both, so agreement is to float32 rounding
# of sums over the box's faces, relative to the field's peak.
SAME_RTOL, SAME_ATOL = 1e-4, 1e-5


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Test workers share the cores (pytest-xdist); PyTorch's default of
    one intra-op thread per core would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(n)


class Replay:
    """A stand-in for the JAX package's prepared simulation that returns
    recorded run outputs, in order, instead of running: the JAX
    extractor post-processes the port's runs. Its ports are copies, so
    the JAX package's re-excitation touches nothing of the port's."""

    def __init__(self, sim, outs):
        self.ports = copy.deepcopy(sim.ports)
        self.msl_ports = []
        self.port_freqs_hz = sim.port_freqs_hz
        self.nf_freqs_hz = sim.nf_freqs_hz
        self.faces = sim.faces
        self.dft_dt = sim.dft_dt
        self._src_refresh = lambda: None
        self._outs = list(outs)

    def run(self, progress_cb=None, abort_cb=None):
        return self._outs.pop(0)


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_allclose(
        a, b, rtol=SAME_RTOL,
        atol=SAME_ATOL * max(float(np.nanmax(np.abs(b))), 1e-30))


@pytest.fixture(scope="module")
def extracted():
    """(sim, the port's pattern set, the all-ports-on run, the JAX
    package's pattern set from the port's run outputs)."""
    sim = two_patches(TORCH)
    outs = []
    run = sim.run

    def recorded(**kw):
        out = run(**kw)
        outs.append(out)
        return out

    sim.run = recorded
    eps = compute_embedded_patterns(sim, theta_deg=THETA, phi_deg=PHI)
    sim.run = run
    assert eps.ok, eps.message
    assert len(outs) == 2
    jeps = jsynth.compute_embedded_patterns(
        Replay(sim, outs), theta_deg=THETA, phi_deg=PHI)
    assert jeps.ok, jeps.message
    out_all = sim.run()  # restore=True put the prepared [1, 1] drive back
    return sim, eps, out_all, jeps


def _jax_set(eps):
    """The JAX package's pattern set holding the port's arrays."""
    sm = eps.smatrix
    return jsynth.EmbeddedPatternSet(
        True, eps.message, freq_hz=eps.freq_hz, theta=eps.theta,
        phi=eps.phi, e_theta=eps.e_theta, e_phi=eps.e_phi, a_inc=eps.a_inc,
        port_centers_m=eps.port_centers_m,
        smatrix=JSMatrix(True, sm.message, freq_hz=sm.freq_hz, s=sm.s,
                         z_ref=sm.z_ref),
    )


def test_patterns_match_jax_on_the_same_runs(extracted):
    _, eps, _, jeps = extracted
    assert isinstance(eps, EmbeddedPatternSet)
    assert eps.n_ports == jeps.n_ports == 2
    np.testing.assert_array_equal(eps.freq_hz, jeps.freq_hz)
    np.testing.assert_allclose(eps.theta, jeps.theta, rtol=1e-12)
    np.testing.assert_allclose(eps.phi, jeps.phi, rtol=1e-12)
    np.testing.assert_array_equal(eps.port_centers_m, jeps.port_centers_m)
    _same(eps.a_inc, jeps.a_inc)
    _same(eps.e_theta, jeps.e_theta)
    _same(eps.e_phi, jeps.e_phi)
    np.testing.assert_allclose(eps.smatrix.s, jeps.smatrix.s, rtol=1e-12)


def test_shapes_and_shared_smatrix(extracted):
    _, eps, _, _ = extracted
    assert eps.e_theta.shape == (2, 1, len(THETA), len(PHI))
    assert np.isfinite(eps.e_theta).all() and np.isfinite(eps.e_phi).all()
    assert isinstance(eps.smatrix, SMatrixResult) and eps.smatrix.ok
    assert eps.smatrix.s.shape == (2, 2, len(FREQS))
    np.testing.assert_allclose(
        eps.port_centers_m[0], [-0.013, 0.0, 0.0008], atol=1e-12)


def test_synthesis_and_steering_match_jax(extracted):
    """``synthesize`` and ``steering_weights`` on the same pattern arrays
    give the JAX package's weights and far fields."""
    _, eps, _, _ = extracted
    jset = _jax_set(eps)
    rng = np.random.default_rng(11)
    for w in ([1.0, 1.0], [1.0, -1.0],
              rng.normal(size=2) + 1j * rng.normal(size=2)):
        got, want = eps.synthesize(w), jset.synthesize(w)
        assert isinstance(got, ArrayPattern)
        for key in ("E_theta", "E_phi", "U", "weights"):
            np.testing.assert_allclose(getattr(got, key), getattr(want, key),
                                       rtol=1e-12, atol=0)
        for key in ("P_rad", "P_inc", "freq_hz", "partial_sphere"):
            assert getattr(got, key) == pytest.approx(getattr(want, key),
                                                      rel=1e-12)
        np.testing.assert_allclose(got.directivity_dbi(),
                                   want.directivity_dbi(), rtol=1e-12)
        assert got.peak_direction_deg() == want.peak_direction_deg()
    for td, pd in ((0.0, 0.0), (25.0, 0.0), (60.0, 90.0)):
        for kind in ("conjugate", "geometric"):
            np.testing.assert_allclose(
                eps.steering_weights(td, pd, kind=kind),
                jset.steering_weights(td, pd, kind=kind),
                rtol=1e-12, atol=1e-14)


def test_sphere_quadrature_matches_jax():
    for th, ph in ((THETA, PHI), (np.arange(0.0, 181.0, 5.0),
                                  np.arange(0.0, 361.0, 5.0)),
                   (np.arange(0.0, 91.0, 10.0), np.arange(0.0, 180.0, 20.0))):
        w, part = _sphere_quadrature(np.radians(th), np.radians(ph))
        jw, jpart = jsynth._sphere_quadrature(np.radians(th), np.radians(ph))
        np.testing.assert_array_equal(w, jw)
        assert part == jpart


def test_superposition_matches_all_on_run(extracted):
    """Synthesis with the all-on run's own measured incident waves
    reproduces that run's far field (linearity)."""
    sim, eps, out_all, _ = extracted
    ff_all = nf2ff_transform(
        sim.faces,
        select_face_freqs(out_all["nf_e"], 0),
        select_face_freqs(out_all["nf_h"], 0),
        sim.dft_dt, np.array([NF_FREQ]), THETA, PHI, device="cpu")
    z = np.array([50.0, 50.0])
    a_pf = (0.5 * (out_all["uf"][:2] + z[:, None] * out_all["if_"][:2])
            / np.sqrt(z)[:, None] * sim.dft_dt)
    w = np.array([np.interp(NF_FREQ, FREQS, a_pf[j].real)
                  + 1j * np.interp(NF_FREQ, FREQS, a_pf[j].imag)
                  for j in range(2)])
    pat = eps.synthesize(w, fi=0)
    ref = np.stack([ff_all.E_theta[0], ff_all.E_phi[0]])
    syn = np.stack([pat.E_theta, pat.E_phi])
    err = np.linalg.norm(syn - ref) / np.linalg.norm(ref)
    assert err < 2e-2, f"superposition residual {err:.3e}"


def test_embedded_patterns_are_mirror_images(extracted):
    _, eps, _, _ = extracted
    nph = len(PHI)
    pmap = np.array(
        [int(round(((180.0 - p) % 360.0) / 15.0)) % nph for p in PHI])
    e1t, e1p = eps.e_theta[0, 0], eps.e_phi[0, 0]
    e2t, e2p = eps.e_theta[1, 0], eps.e_phi[1, 0]
    scale = np.linalg.norm(e1t) + np.linalg.norm(e1p)
    assert np.linalg.norm(e2t[:, pmap] - e1t) / scale < 4e-2
    assert np.linalg.norm(e2p[:, pmap] + e1p) / scale < 4e-2


def _element_peak_deg(eps):
    mag = np.abs(eps.e_theta[0, 0]) ** 2 + np.abs(eps.e_phi[0, 0]) ** 2
    ti, pi = np.unravel_index(int(np.argmax(mag)), mag.shape)
    return (float(np.degrees(eps.theta[ti])), float(np.degrees(eps.phi[pi])),
            ti, pi)


def test_conjugate_steering_is_optimal(extracted):
    _, eps, _, _ = extracted
    td, pd, ti, pi = _element_peak_deg(eps)
    w_c = eps.steering_weights(td, pd, kind="conjugate")
    np.testing.assert_allclose(np.sum(np.abs(w_c) ** 2), 2.0, rtol=1e-12)
    u_c = eps.synthesize(w_c).U[ti, pi]
    rng = np.random.default_rng(7)
    for _ in range(5):
        w = rng.normal(size=2) + 1j * rng.normal(size=2)
        w *= np.sqrt(2.0 / np.sum(np.abs(w) ** 2))
        assert u_c >= eps.synthesize(w).U[ti, pi] * (1.0 - 1e-9)
    w_g = eps.steering_weights(td, pd, kind="geometric")
    np.testing.assert_allclose(np.abs(w_g), 1.0, rtol=1e-12)
    u_g = eps.synthesize(w_g).U[ti, pi]
    assert 0.2 * u_c < u_g <= u_c * (1.0 + 1e-9)


def test_power_passivity_and_gain_ordering(extracted):
    _, eps, _, _ = extracted
    pat = eps.synthesize([1.0, 1.0])
    assert pat.P_inc == pytest.approx(1.0)
    assert not pat.partial_sphere
    assert 0.0 < pat.P_rad < pat.P_inc
    assert pat.realized_gain.max() < pat.directivity.max()
    assert np.isfinite(pat.directivity_dbi()).all()


def test_bad_inputs_rejected(extracted):
    sim, eps, _, _ = extracted
    bad = compute_embedded_patterns(sim, freq_idx=np.array([999]))
    assert not bad.ok and "freq_idx" in bad.message
    with pytest.raises(ValueError):
        eps.steering_weights(0.0, 0.0, kind="magic")
    with pytest.raises(ValueError):
        eps.synthesize([1.0, 2.0, 3.0])


def test_array_run_summary_matches_jax(extracted):
    _, eps, _, _ = extracted
    td, pd, _, _ = _element_peak_deg(eps)
    kw = dict(spacing_mm=26.0, f_synth_hz=float(eps.freq_hz[0]), fi=0,
              resonant=False)
    design = ArrayDesignResult(True, "test", patterns=eps, **kw)
    jdesign = jsynth.ArrayDesignResult(True, "test", patterns=_jax_set(eps),
                                       **kw)
    for kind in ("conjugate", "geometric"):
        summary, broadside, steered, w = array_run_summary(
            design, td, pd, kind=kind)
        jsummary, jb, js, jw = jsynth.array_run_summary(
            jdesign, td, pd, kind=kind)
        assert summary.keys() == jsummary.keys()
        for k, v in jsummary.items():
            np.testing.assert_allclose(np.asarray(summary[k], float),
                                       np.asarray(v, float), rtol=1e-12,
                                       atol=1e-12, err_msg=k)
        np.testing.assert_allclose(broadside.U, jb.U, rtol=1e-12)
        np.testing.assert_allclose(steered.U, js.U, rtol=1e-12)
        np.testing.assert_allclose(w, jw, rtol=1e-12)
    assert summary["n_ports"] == 2
    assert summary["synth_freq_ghz"] == pytest.approx(NF_FREQ / 1e9)
    np.testing.assert_allclose(design.steer(td, pd).U,
                               eps.synthesize(eps.steering_weights(td, pd)).U)
    assert design.smatrix is eps.smatrix


def test_smatrix_abort_restores_excitation(extracted):
    sim, _, _, _ = extracted
    orig = [float(p.spec.excite) for p in sim.ports]
    res = compute_s_matrix(sim, abort_cb=lambda: True)
    assert not res.ok and "abort" in res.message
    assert [float(p.spec.excite) for p in sim.ports] == orig


def _synthetic(cls, diag_db):
    diag = np.asarray(diag_db, float)
    n, nf = diag.shape
    s = np.zeros((n, n, nf), complex)
    for i in range(n):
        s[i, i] = 10.0 ** (diag[i] / 20.0)
    return cls(True, "synthetic", freq_hz=np.linspace(2e9, 3e9, nf), s=s,
               z_ref=np.full(n, 50.0))


@pytest.mark.parametrize("diag_db", [
    [[-2, -6, -9, -18, -4], [-2, -6, -9, -16, -4]],
    [[-2, -9, -4], [-2, -9, -4]],
    [[-12, -3, -30], [-12, -3, -28]],
])
def test_pick_resonance_matches_jax(diag_db):
    got = pick_resonance(_synthetic(SMatrixResult, diag_db), 9.9e9)
    want = jsynth.pick_resonance(_synthetic(JSMatrix, diag_db), 9.9e9)
    assert got == want


def test_design_array_refusals_match_jax():
    """The pitch and count guards refuse before any FDTD, as in JAX."""
    user = dict(frequency_ghz=10.0, er=2.2, h_mm=0.787, loss_tangent=0.0009)
    p, jp = PatchAntennaParams.from_user_units(**user), \
        JParams.from_user_units(**user)
    for args, kw in (((2, 1), {}), ((1, 2), dict(spacing_mm=12.0)),
                     ((0, 1), {}), ((1, 0), {})):
        got = design_array(p, *args, device="cpu", **kw)
        want = jsynth.design_array(jp, *args, **kw)
        assert not got.ok and not want.ok
        assert got.message == want.message
        assert got.spacing_mm == want.spacing_mm
        assert got.patterns is None and got.prep is None
    assert "increase the pitch" in design_array(p, 2, 1, device="cpu").message


def test_cli_array_prints_the_summary_and_writes_the_files(
        extracted, tmp_path, monkeypatch, capsys):
    """The CLI's ``array`` flow on a design over the shared extraction
    (``design_array`` stubbed, so no FDTD run): the JAX CLI's arguments
    reach ``design_array``, the JSON summary is ``array_run_summary``'s
    with the design frequency and the device, and ``array_embedded.npz``
    and ``array.s2p`` hold the patterns and the S matrix; the broadside and
    steered surfaces are drawn."""
    import json
    import types

    from fdtd_solver_antennas_tpu_torch.__main__ import main
    from fdtd_solver_antennas_tpu_torch.post.touchstone import read_touchstone
    from fdtd_solver_antennas_tpu_torch.solvers import array_synth

    sim, eps, _, _ = extracted
    design = ArrayDesignResult(
        True, "stub", patterns=eps, prep=types.SimpleNamespace(sim=sim),
        spacing_mm=26.0, f_synth_hz=NF_FREQ, fi=0, resonant=True)
    seen = {}

    def stub(params, nx, ny, spacing_mm, **kw):
        seen.update(params=params, nx=nx, ny=ny, spacing_mm=spacing_mm, **kw)
        return design

    monkeypatch.setattr(array_synth, "design_array", stub)
    main(["array", "--frequency-ghz", "2.45", "--er", "4.3", "--h-mm", "1.6",
          "--steer-theta", "30", "--device", "cpu", "--outdir", str(tmp_path)])
    assert (seen["nx"], seen["ny"], seen["spacing_mm"]) == (2, 1, None)
    assert seen["mesh_quality"] == 3 and seen["device"] == "cpu"
    assert seen["theta_step_deg"] == seen["phi_step_deg"] == 5.0
    assert seen["params"].frequency_hz == pytest.approx(2.45e9)
    text = capsys.readouterr().out
    summary = json.loads(text[text.index("{"):text.rindex("}") + 1])
    want, *_ = array_run_summary(design, 30.0, 0.0)
    assert summary.keys() == {"design_freq_ghz", *want, "device"}
    assert summary["device"] == "cpu"
    assert summary["design_freq_ghz"] == pytest.approx(2.45)
    assert summary["steering_weights"] == want["steering_weights"]
    with np.load(tmp_path / "array_embedded.npz") as z:
        assert sorted(z.files) == sorted(
            ["freq_hz", "theta", "phi", "e_theta", "e_phi", "s",
             "s_freqs_hz", "port_centers_m"])
        np.testing.assert_array_equal(z["e_theta"], eps.e_theta)
        np.testing.assert_array_equal(z["s"], eps.smatrix.s)
    f, s, z_ref = read_touchstone(tmp_path / "array.s2p")
    np.testing.assert_allclose(f, FREQS, rtol=1e-9)
    np.testing.assert_allclose(s, eps.smatrix.s, rtol=1e-6, atol=1e-9)
    assert z_ref == 50.0
    for tag in ("broadside", "steered"):  # the JAX CLI's two figures
        png = tmp_path / f"array_{tag}.png"
        assert png.stat().st_size > 0 and f"Saved: {png}" in text


def test_design_array_preparation_matches_jax(monkeypatch):
    """The CLI's 2×1 array (the canonical FR-4 patch at λ0/2, mesh
    quality 3) prepared by both packages' ``design_array``, each with its
    FDTD runs stubbed out: pitch, margin and feed, the 86×44×53 grid, the
    coefficients, port runtimes, source stamps, probe tables and Huygens
    faces are equal bit for bit."""
    import types

    from fdtd_solver_antennas_tpu.ops import fdtd as jfdtd

    from fdtd_solver_antennas_tpu_torch.ops import fdtd as tfdtd
    from fdtd_solver_antennas_tpu_torch.solvers import array_synth

    def no_runs(store):
        def stub(prep, **kw):
            store["prep"] = prep
            return types.SimpleNamespace(ok=False, message="runs stubbed")
        return stub

    user = dict(frequency_ghz=2.45, er=4.3, h_mm=1.6, loss_tangent=0.02)
    seen, jseen = {}, {}
    monkeypatch.setattr(array_synth, "compute_embedded_patterns",
                        no_runs(seen))
    monkeypatch.setattr(jsynth, "compute_embedded_patterns", no_runs(jseen))
    got = design_array(PatchAntennaParams.from_user_units(**user), 2, 1,
                       device="cpu")
    want = jsynth.design_array(JParams.from_user_units(**user), 2, 1)
    assert not got.ok and not want.ok and got.message == want.message
    assert (got.spacing_mm, got.margin_mm, got.feed_mm) == \
        (want.spacing_mm, want.margin_mm, want.feed_mm)
    ts, js = seen["prep"].sim, jseen["prep"].sim
    assert ts.grid.shape == js.grid.shape == (86, 44, 53)
    for ax in "xyz":
        np.testing.assert_array_equal(ts.grid.lines[ax], js.grid.lines[ax])
    assert ts.dt == js.dt and ts.probe_decim == js.probe_decim
    assert ts.n_source_steps == js.n_source_steps
    assert ts.cfg.n_steps_max == js.cfg.n_steps_max
    assert ts.cfg.end_criteria == js.cfg.end_criteria
    np.testing.assert_array_equal(ts.waveform, np.asarray(js.waveform))
    np.testing.assert_array_equal(ts.port_freqs_hz, js.port_freqs_hz)
    np.testing.assert_array_equal(ts.nf_freqs_hz, js.nf_freqs_hz)
    assert set(ts.coeffs) == set(js._coeffs_np)
    for k, v in js._coeffs_np.items():
        np.testing.assert_array_equal(ts.coeffs[k].numpy(), v, err_msg=k)
    assert len(ts.ports) == len(js.ports) == 2
    for a, b in zip(ts.ports, js.ports):
        assert (a.axis, a.sl, a.i_gather, a.i_lengths) == \
            (b.axis, b.sl, b.i_gather, b.i_lengths)
        assert a.spec.excite == b.spec.excite
        np.testing.assert_array_equal(a.dl_m, b.dl_m)
        np.testing.assert_array_equal(a.src_col, b.src_col)
    for m, stamp in enumerate(ts.operands.src):
        want_m = np.zeros(ts.padded_shape, np.float32)
        for b in js.ports:
            if b.axis == m:
                want_m[b.sl] += b.src_col
        got_m = np.zeros_like(want_m) if stamp is None else stamp.numpy()
        np.testing.assert_array_equal(got_m, want_m)
    tg = tfdtd.build_probe_gathers(ts)
    jg = jfdtd.build_probe_gathers(js, *js.grid.shape)
    for i, (a, b) in enumerate(zip(tg, jg, strict=True)):
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f"item {i}")
        else:
            assert a == b, i
    for tf, jf in zip(ts.faces, js.faces, strict=True):
        for f in ("axis", "m", "u0", "u1", "v0", "v1"):
            assert getattr(tf, f) == getattr(jf, f), f
        np.testing.assert_array_equal(tf.centers_m, jf.centers_m)
