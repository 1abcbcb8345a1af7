"""The port's main path against the JAX package's, end to end on the CPU.

``prepare_patch_fixed`` + ``run_prepared_fixed`` on the canonical
2.45 GHz FR-4 patch with a 1000-step budget in both packages: the raw
port DFTs at rtol 2e-4 / atol 1e-5·max|ref|, S11, Z_in and Dmax at rtol
1e-3, and the dBi pattern grid at atol 0.05 dB. Also: the port imports
and runs with JAX, pydantic and matplotlib blocked, the CLI writes its
outputs, and asking for CUDA without CUDA fails instead of running on
the CPU.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from fdtd_solver_antennas_tpu.models.params import PatchAntennaParams as JParams
from fdtd_solver_antennas_tpu.solvers.patch_fixed import (
    prepare_patch_fixed as jprepare,
    run_prepared_fixed as jrun,
)

from fdtd_solver_antennas_tpu_torch.models.params import PatchAntennaParams
from fdtd_solver_antennas_tpu_torch.solvers.patch_fixed import (
    prepare_patch_fixed,
    probe_fdtd,
    run_prepared_fixed,
)

ROOT = Path(__file__).resolve().parents[1]
CANON = dict(frequency_ghz=2.45, er=4.3, h_mm=1.6, loss_tangent=0.02)


def _run_capturing(prep, run_fn):
    """run_fn(prep) with the engine's raw output captured as well."""
    sim = prep.sim
    captured = {}
    run = sim.run

    def capture(**kw):
        captured["out"] = run(**kw)
        return captured["out"]

    sim.run = capture
    res = run_fn(prep, frequency_hz=2.45e9, verbose=0)
    assert res.ok, res.message
    return res, captured["out"]


@pytest.fixture(scope="module")
def both():
    jp = jprepare(JParams.from_user_units(**CANON), n_steps_max=1000)
    tp = prepare_patch_fixed(
        PatchAntennaParams.from_user_units(**CANON), n_steps_max=1000,
        device="cpu")
    assert jp.ok and tp.ok, (jp.message, tp.message)
    assert not jp.sim.use_pallas
    return _run_capturing(jp, jrun), _run_capturing(tp, run_prepared_fixed)


def _close(a, b, rtol=2e-4):
    a, b = np.asarray(a), np.asarray(b)
    atol = 1e-5 * max(float(np.abs(b).max()), 1e-20)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


def test_raw_port_dfts_match(both):
    (jres, jout), (tres, tout) = both
    assert tres.steps_run == jres.steps_run == 1335  # 3 chunks of 5 × 89
    _close(tout["uf"], jout["uf"])
    _close(tout["if_"], jout["if_"])
    for key in ("nf_e", "nf_h"):
        for a, b in zip(tout[key], jout[key], strict=True):
            _close(a, b)


def test_s11_and_impedance_match(both):
    (jres, _), (tres, _) = both
    np.testing.assert_array_equal(tres.freq, jres.freq)
    np.testing.assert_allclose(tres.s11, jres.s11, rtol=1e-3)
    np.testing.assert_allclose(tres.z_in, jres.z_in, rtol=1e-3)
    assert tres.f_res_hz == jres.f_res_hz


def test_far_field_matches(both):
    (jres, _), (tres, _) = both
    np.testing.assert_allclose(tres.Dmax, jres.Dmax, rtol=1e-3)
    assert tres.intensity.shape == jres.intensity.shape == (90, 2)
    np.testing.assert_allclose(tres.intensity, jres.intensity, atol=0.05)
    np.testing.assert_allclose(tres.radiated_power_w, jres.radiated_power_w,
                               rtol=1e-3)
    np.testing.assert_array_equal(tres.theta, jres.theta)
    assert tres.diagnostics["device"] == "cpu"


_ISOLATED = r"""
import sys
for name in ("jax", "jaxlib", "pydantic", "matplotlib"):
    sys.modules[name] = None  # any import of them now raises ImportError
import fdtd_solver_antennas_tpu_torch as port
from fdtd_solver_antennas_tpu_torch.ops import fdtd_cuda
params = port.PatchAntennaParams.from_user_units(
    frequency_ghz=2.45, er=4.3, h_mm=1.6, loss_tangent=0.02)
prep = port.prepare_patch_fixed(params, n_steps_max=890, device="cpu")
assert prep.ok, prep.message
res = port.run_prepared_fixed(prep, frequency_hz=2.45e9, verbose=0)
assert res.ok, res.message
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "pydantic", "matplotlib")
                and sys.modules[m] is not None)
print("RESULT", res.steps_run, float(res.Dmax), leaked,
      sorted(fdtd_cuda.launches.values()))
"""


def test_port_runs_with_jax_pydantic_matplotlib_blocked():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-c", _ISOLATED], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT")]
    steps, dmax, leaked, counts = line[0].split(" ", 4)[1:]
    assert int(steps) == 890  # two chunks of 5 × 89 steps
    assert float(dmax) > 1.0
    assert leaked == "[]"
    assert counts == "[0, 0, 0, 0]"  # the CPU runs the plain twins


def test_cli_fdtd_writes_summary_and_files(tmp_path, capsys):
    from fdtd_solver_antennas_tpu_torch.__main__ import main

    main(["fdtd", "--frequency-ghz", "2.45", "--er", "4.3", "--h-mm", "1.6",
          "--loss-tangent", "0.02", "--steps-max", "445", "--device", "cpu",
          "--outdir", str(tmp_path)])
    out = capsys.readouterr().out
    summary = json.loads(out[out.index("{"): out.index("}") + 1])
    assert summary["steps"] == 445 and summary["device"] == "cpu"
    data = np.load(tmp_path / "s11.npz")
    assert data["s11"].shape == data["freq_hz"].shape == (201,)
    from fdtd_solver_antennas_tpu_torch.post.touchstone import read_touchstone

    f, s, r = read_touchstone(tmp_path / "s11.s1p")
    finite = np.isfinite(data["s11"])
    np.testing.assert_allclose(f, data["freq_hz"][finite])
    np.testing.assert_allclose(s[0, 0], data["s11"][finite], rtol=1e-8)
    assert r == 50.0


def test_prepare_on_cuda_without_cuda_fails_loudly():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    prep = prepare_patch_fixed(
        PatchAntennaParams.from_user_units(**CANON), device="cuda")
    assert not prep.ok and prep.sim is None
    assert "cuda" in prep.message
    assert not probe_fdtd("cuda").ok


def test_probe_reports_the_torch_device():
    probe = probe_fdtd("cpu")
    assert probe.ok and probe.api["backend"] == ["cpu"]
    assert not probe_fdtd("mps-or-other").ok
