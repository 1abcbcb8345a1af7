"""The port's microstrip path against the JAX package's, on the CPU.

The microstrip-fed FR-4 patch (2.45 GHz, εr 4.3, h 1.6 mm, tanδ 0.02) is
prepared by both packages with an MSL port and with a lumped port: grid
lines, ca/cb, the MSL runtime field by field (excitation plane, its
``src_col`` and excite=1 basis ``src_col_unit``, the three V and two I
probe lists, the probe planes' positions, Z_ref), the source stamps and
the probe gathers must be equal, for every feed direction. A run of one
chunk (492 steps with the MSL port, 484 with the lumped one) under PML_8
through the port's plain twins must match
the JAX XLA path on the whole output surface — fields, ψ, the port and
NF2FF DFTs (the three MSL rows included), steps and e_ratio — at rtol
2e-4 and atol 1e-5·max|ref|, and so must a JAX checkpoint carried across
and continued in both packages. The 3-probe deembedding matches on the
same seeded DFTs at rtol 1e-6, and the CLI's ``s11`` and ``fdtd --solver
microstrip`` write the JAX CLI's files.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from fdtd_solver_antennas_tpu.models.params import PatchAntennaParams as JParams
from fdtd_solver_antennas_tpu.ops import fdtd as jfdtd
from fdtd_solver_antennas_tpu.ops.fdtd_pallas import build_src_mats as jsrc_mats
from fdtd_solver_antennas_tpu.post.ports import msl_port_spectra as jmsl_spectra
from fdtd_solver_antennas_tpu.solvers import microstrip as jms

from fdtd_solver_antennas_tpu_torch.__main__ import main as cli_main
from fdtd_solver_antennas_tpu_torch.models.params import PatchAntennaParams
from fdtd_solver_antennas_tpu_torch.ops import fdtd as tfdtd
from fdtd_solver_antennas_tpu_torch.post.ports import MSLPortSpectra, msl_port_spectra
from fdtd_solver_antennas_tpu_torch.solvers import microstrip as tms

CANON = dict(frequency_ghz=2.45, er=4.3, h_mm=1.6, loss_tangent=0.02)
RTOL = 2e-4
STEPS = 300  # one chunk: 4 probe intervals (of D = 123 with the MSL port)
THREADS = 2  # PyTorch intra-op threads while this file runs


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


def _prepare(port_mode, feed="-X", boundary="PML_8", n_steps=STEPS):
    kw = dict(feed_direction=feed, port_mode=port_mode, boundary=boundary,
              n_steps_max=n_steps)
    jp = jms.prepare_microstrip_patch(JParams.from_user_units(**CANON), **kw)
    tp = tms.prepare_microstrip_patch(
        PatchAntennaParams.from_user_units(**CANON), device="cpu", **kw)
    assert jp.ok and tp.ok, (jp.message, tp.message)
    assert not jp.sim.use_pallas
    return jp, tp


def _assert_msl_runtime_equal(t, j):
    assert t.sl == j.sl and t.z_ref == j.z_ref
    assert t.v_probes == j.v_probes and t.i_probes == j.i_probes
    np.testing.assert_array_equal(t.v_pos_m, j.v_pos_m)
    np.testing.assert_array_equal(t.i_pos_m, j.i_pos_m)
    np.testing.assert_array_equal(t.src_col, j.src_col)
    np.testing.assert_array_equal(t.src_col_unit, j.src_col_unit)
    assert t.src_col.dtype == t.src_col_unit.dtype == np.float32
    assert t.N_ROWS == j.N_ROWS == 3


@pytest.mark.parametrize("port_mode", ["msl", "lumped"])
@pytest.mark.parametrize("feed", ["-X", "+X", "-Y", "+Y"])
def test_prepare_equals_jax_for_every_feed_direction(feed, port_mode):
    jp, tp = _prepare(port_mode, feed, boundary="MUR")
    js, ts = jp.sim, tp.sim
    for ax in "xyz":
        np.testing.assert_array_equal(ts.grid.lines[ax], js.grid.lines[ax])
    assert ts.dt == js.dt and ts.probe_decim == js.probe_decim
    np.testing.assert_array_equal(ts.port_freqs_hz, js.port_freqs_hz)
    np.testing.assert_array_equal(tp.theta, jp.theta)
    np.testing.assert_array_equal(tp.phi, jp.phi)
    np.testing.assert_array_equal(tp.nf_center, jp.nf_center)
    assert tp.diagnostics == jp.diagnostics
    assert set(ts._coeffs_np) == set(js._coeffs_np)
    for k, v in js._coeffs_np.items():
        np.testing.assert_array_equal(ts._coeffs_np[k], v, err_msg=k)
    assert len(ts.msl_ports) == len(js.msl_ports)
    assert len(ts.ports) == len(js.ports)
    for t, j in zip(ts.msl_ports, js.msl_ports):
        _assert_msl_runtime_equal(t, j)
    for t, j in zip(ts.ports, js.ports):
        assert (t.axis, t.sl, t.i_gather, t.i_lengths) == \
            (j.axis, j.sl, j.i_gather, j.i_lengths)
        np.testing.assert_array_equal(t.src_col, j.src_col)
        np.testing.assert_array_equal(t.src_col_unit, j.src_col_unit)
    assert tfdtd.n_probe_rows(ts) == jfdtd.n_probe_rows(js)
    assert tfdtd.n_probe_rows(ts) == (3 if port_mode == "msl" else 1)


def test_msl_stamps_and_probe_tables_equal_jax():
    """The MSL plane in the Ez stamp, the probe gathers (the empty third
    I row padded with weight 0) and the device probe table's port blocks."""
    jp, tp = _prepare("msl")
    js, ts = jp.sim, tp.sim
    shape = ts.padded_shape
    assert tuple(js.grid.shape) == shape
    want = jsrc_mats(js, *shape)
    got = tfdtd.build_src_mats(ts, *shape)
    assert set(got) == {2} and set(want) == {"z"}
    np.testing.assert_array_equal(got[2], want["z"])
    np.testing.assert_array_equal(ts.operands.src[2].numpy(), want["z"])
    assert ts.operands.src[0] is None and ts.operands.src[1] is None
    assert (got[2] != 0).sum() == ts.msl_ports[0].src_col.size

    tg = tfdtd.build_probe_gathers(ts)
    jg = jfdtd.build_probe_gathers(js, shape[0], shape[1], shape[2])
    for i, (a, b) in enumerate(zip(tg, jg, strict=True)):
        if isinstance(b, list):
            assert a == b
        else:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                          err_msg=str(i))
    pi_idx, pi_w = tg[8], tg[9]
    assert pi_idx.shape[0] == 3 and not pi_w[2].any()
    probes = ts.operands.probes
    assert probes.rows[:2] == (3, 3)
    assert probes.n_rows == 6 + ts.n_face_slots * 2


def test_msl_port_spectra_matches_jax():
    rng = np.random.default_rng(11)
    f = np.linspace(1.7e9, 3.2e9, 41)

    def c(*shape):
        return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)

    uf3, if2 = c(3, f.size), 0.02 * c(2, f.size)
    v_pos = np.array([-0.051, -0.049, -0.047])
    i_pos = np.array([-0.050, -0.048])
    got = msl_port_spectra(f, uf3, if2, 2.1e-12, v_pos, i_pos, z0_nominal=50.0)
    ref = jmsl_spectra(f, uf3, if2, 2.1e-12, v_pos, i_pos, z0_nominal=50.0)
    assert isinstance(got, MSLPortSpectra)
    for name in ("uf", "if_", "uf_inc", "uf_ref", "s11", "z_in", "z_line",
                 "beta"):
        np.testing.assert_allclose(getattr(got, name), getattr(ref, name),
                                   rtol=1e-6, err_msg=name)
    assert got.z_ref == ref.z_ref


def _run_capturing(prep, run_fn):
    captured = {}
    run = prep.sim.run

    def capture(**kw):
        captured["out"] = run(**kw)
        return captured["out"]

    prep.sim.run = capture
    res = run_fn(prep, frequency_hz=2.45e9, verbose=0)
    assert res.ok, res.message
    return res, captured["out"]


def _assert_same_surface(out, ref):
    assert int(out["steps"]) == int(ref["steps"])
    _close(out["e_ratio"], float(ref["e_ratio"]))
    for fa, fb in zip(out["fields"], ref["fields"], strict=True):
        _close(fa, fb)
    _close(out["uf"], ref["uf"])
    _close(out["if_"], ref["if_"])
    for key in ("nf_e", "nf_h"):
        for a, b in zip(out[key], ref[key], strict=True):
            _close(a, b)
    for grp in ("psi_e", "psi_h"):
        assert set(out["state"][grp]) == set(ref["state"][grp])
        for k, v in ref["state"][grp].items():
            _close(out["state"][grp][k], v)


@pytest.mark.parametrize("port_mode", ["msl", "lumped"])
def test_run_matches_jax(port_mode):
    jp, tp = _prepare(port_mode)
    jres, jout = _run_capturing(jp, jms.run_prepared_microstrip)
    tres, tout = _run_capturing(tp, tms.run_prepared_microstrip)
    chunk = tfdtd.chunk_geometry(tp.sim)[2]
    assert tres.steps_run == jres.steps_run == chunk >= STEPS
    _assert_same_surface(tout, jout)
    assert tout["uf"].shape[0] == (3 if port_mode == "msl" else 1)
    np.testing.assert_array_equal(tres.freq, jres.freq)
    np.testing.assert_allclose(tres.s11, jres.s11, rtol=1e-3)
    np.testing.assert_allclose(tres.z_in, jres.z_in, rtol=1e-3)
    np.testing.assert_allclose(tres.Dmax, jres.Dmax, rtol=1e-3)
    np.testing.assert_array_equal(tres.theta, jres.theta)
    assert tres.intensity.shape == jres.intensity.shape == (91, 2)
    spec = tres.diagnostics["port_spectra"]
    if port_mode == "msl":
        jspec = jres.diagnostics["port_spectra"]
        np.testing.assert_allclose(spec.z_line, jspec.z_line, rtol=1e-3)
        np.testing.assert_allclose(spec.beta, jspec.beta, rtol=1e-3)


def _numpy_state(state):
    return {k: (tuple(np.asarray(f) for f in v) if k == "fields" else
                {kk: np.asarray(vv) for kk, vv in v.items()}
                if isinstance(v, dict) else np.asarray(v))
            for k, v in state.items()}


def test_jax_msl_state_carries_across():
    """A JAX checkpoint of the MSL run after one chunk, continued one more
    chunk in both packages."""
    jp, tp = _prepare("msl", n_steps=2 * 492)
    js = jp.sim
    full = js.cfg
    js.cfg = dataclasses.replace(full, n_steps_max=492)
    jfdtd.rebuild_run_fn(js)
    state = _numpy_state(js.run()["state"])
    assert int(state["n"]) == 492
    js.cfg = full
    jfdtd.rebuild_run_fn(js)
    ref = js.run(resume_state=state)
    out = tp.sim.run(resume_state=state)
    assert int(out["steps"]) == 984
    _assert_same_surface(out, ref)
    back = tfdtd.state_to_numpy(out["state"])
    assert back["uf"].shape == np.asarray(ref["state"]["uf"]).shape


def test_short_feed_line_refuses_msl_in_both():
    for mod, params in ((jms, JParams), (tms, PatchAntennaParams)):
        with pytest.raises(ValueError, match="too short for the MSL"):
            mod.build_microstrip_scene(
                params.from_user_units(**CANON), mod.FeedDirection.NEG_X, 4.0,
                3.0, port_mode="msl")


@pytest.mark.parametrize("argv", [
    ["s11"],
    ["fdtd", "--solver", "microstrip", "--feed-direction", "+Y"],
])
def test_cli_writes_the_jax_clis_files(argv, tmp_path, capsys):
    cli_main([*argv, "--frequency-ghz", "2.45", "--er", "4.3", "--h-mm", "1.6",
              "--loss-tangent", "0.02", "--device", "cpu", "--steps-max",
              "200", "--outdir", str(tmp_path)])
    text = capsys.readouterr().out
    assert "engine path: chunk kernels" in text
    summary = json.loads(text[text.index("{"):text.rindex("}") + 1])
    assert set(summary) == {"f_res_ghz", "s11_min_db", "Dmax_dbi", "steps",
                            "wall_time_s", "mcells_per_s", "device"}
    assert summary["device"] == "cpu" and 200 <= summary["steps"] < 600
    with np.load(tmp_path / "s11.npz") as z:
        assert set(z.files) == {"freq_hz", "s11", "z_in"}
        assert z["s11"].shape == z["freq_hz"].shape == (201,)
        assert np.isfinite(z["s11"]).all()
    touchstone = (tmp_path / "s11.s1p").read_text()
    assert "microstrip patch" in touchstone
    # the JAX CLI draws the far field for fdtd, nothing for s11
    assert (tmp_path / "pattern_fdtd.png").exists() == (argv[0] == "fdtd")


def _band_dip(freq, s11):
    """(f, dB) of the deepest S11 in 1.6–2.3 GHz (tests/test_msl_port.py)."""
    db = 20 * np.log10(np.abs(s11) + 1e-12)
    win = (freq > 1.6e9) & (freq < 2.3e9)
    i = int(np.argmin(np.where(win, db, 0.0)))
    return float(freq[i]), float(db[i])


@pytest.mark.slow
def test_msl_run_to_the_step_cap_matches_jax():
    """The MSL-fed patch under PML_8 at the solver's own cap (30,000
    steps asked): both packages run to the cap, 30,012 steps, without
    meeting the energy criterion; steps, e_ratio, the port DFTs (the three
    MSL rows) and the deembedded dip agree at the north-star tolerance.
    Prints the gaps (seen under ``pytest -s``): the largest difference of
    ``uf``, ``if_`` and each final field over its peak, and the dips."""
    jp, tp = _prepare("msl", n_steps=30_000)
    jres, jout = _run_capturing(jp, jms.run_prepared_microstrip)
    tres, tout = _run_capturing(tp, tms.run_prepared_microstrip)

    def rel(a, b):
        a = a.numpy() if torch.is_tensor(a) else np.asarray(a)
        b = np.asarray(b)
        return float(np.abs(a - b).max() / np.abs(b).max())

    print(f"MSL patch PML_8 to the cap: JAX {jres.steps_run} steps, e_ratio "
          f"{float(jout['e_ratio']):.6e}; port {tres.steps_run} steps, "
          f"e_ratio {float(tout['e_ratio']):.6e}; max |port - JAX| / "
          f"max|JAX|: uf {rel(tout['uf'], jout['uf']):.3e}, if_ "
          f"{rel(tout['if_'], jout['if_']):.3e}, fields "
          + ", ".join(f"{rel(a, b):.3e}"
                      for a, b in zip(tout["fields"], jout["fields"]))
          + f"; dip (Hz, dB): port {_band_dip(tres.freq, tres.s11)}, JAX "
          f"{_band_dip(jres.freq, jres.s11)}")
    assert tres.steps_run == jres.steps_run == 30_012
    assert float(jout["e_ratio"]) > jp.sim.cfg.end_criteria
    _close(tout["e_ratio"], float(jout["e_ratio"]))
    _close(tout["uf"], jout["uf"])
    _close(tout["if_"], jout["if_"])
    (f, db), (jf, jdb) = _band_dip(tres.freq, tres.s11), \
        _band_dip(jres.freq, jres.s11)
    assert f == jf
    assert db == pytest.approx(jdb, rel=RTOL)
