"""The port's CLI figures, its ``simulate`` subcommand, its export surface
and its optional packages, on the CPU.

``simulate`` prints the JAX package's design summary (rtol 1e-6) and
writes ``cuts.png`` and ``pattern_3d.png``; ``fdtd`` writes
``pattern_fdtd.png`` beside its numeric files; ``horn`` (its run stubbed)
writes ``horn_pattern.png``. In a subprocess with matplotlib, tkinter,
streamlit, plotly, JAX and pydantic blocked the package, ``viz``,
``utils`` and both frontends import, and ``simulate`` exits 0 naming the
two figures it did not draw. The port exports every name of the JAX
package's ``__all__``, and ``ensure_backend("cuda")`` never falls back to
the CPU.
"""

import json
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import fdtd_solver_antennas_tpu as jax_package
from fdtd_solver_antennas_tpu.models.params import PatchAntennaParams as JParams
from fdtd_solver_antennas_tpu.solvers.analytical import (
    AnalyticalPatchSolver as JSolver,
)

import fdtd_solver_antennas_tpu_torch as port
from fdtd_solver_antennas_tpu_torch.__main__ import main

ROOT = Path(__file__).resolve().parents[1]
THREADS = 2  # PyTorch intra-op threads while this file runs
CANON = ["--frequency-ghz", "2.45", "--er", "4.3", "--h-mm", "1.6"]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Test workers share the cores (pytest-xdist); PyTorch's default of
    one intra-op thread per core would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(n)


def _summary_lines(text):
    """{key: value} of the ``Design:`` block ``simulate`` prints."""
    out = {}
    for line in text.splitlines():
        if line.startswith("  ") and ": " in line:
            k, v = line.strip().split(": ", 1)
            out[k] = float(v)
    return out


def test_simulate_prints_jax_summary_and_writes_pngs(tmp_path, capsys):
    main(["simulate", *CANON, "--device", "cpu", "--outdir", str(tmp_path)])
    text = capsys.readouterr().out
    assert text.startswith("Design:\n")
    got = _summary_lines(text)
    want = JSolver(JParams.from_user_units(
        frequency_ghz=2.45, er=4.3, h_mm=1.6)).summary()
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k] == pytest.approx(float(v), rel=1e-6), k
    for name in ("cuts.png", "pattern_3d.png"):
        png = tmp_path / name
        assert png.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
        assert f"Saved: {png}" in text


def test_fdtd_writes_pattern_png(tmp_path, capsys):
    main(["fdtd", *CANON, "--loss-tangent", "0.02", "--steps-max", "445",
          "--device", "cpu", "--outdir", str(tmp_path)])
    text = capsys.readouterr().out
    summary = json.loads(text[text.index("{"):text.rindex("}") + 1])
    assert summary["steps"] == 445 and summary["device"] == "cpu"
    for name in ("s11.npz", "s11.s1p", "pattern_fdtd.png"):
        assert (tmp_path / name).stat().st_size > 0, name
    assert text.rstrip().endswith(f"Saved: {tmp_path / 'pattern_fdtd.png'}")


def test_horn_writes_pattern_png(tmp_path, capsys, monkeypatch):
    """The ``horn`` flow with its FDTD run stubbed: the JSON summary,
    ``s11.npz`` and ``horn_pattern.png`` at the JAX CLI's name."""
    from fdtd_solver_antennas_tpu_torch.solvers import horn

    theta = np.linspace(0, np.pi, 19)
    phi = np.linspace(0, 2 * np.pi, 37)
    th, ph = np.meshgrid(theta, phi, indexing="ij")
    intensity = 10 * np.log10(np.cos(th / 2) ** 8 + 1e-4) + 15.0
    freq = np.linspace(10e9, 14e9, 11)
    seen = {}

    def prepare(hp, device, verbose):
        seen.update(f=hp.frequency_hz, device=device)
        return types.SimpleNamespace(ok=True, message="stub")

    def run(prep, frequency_hz):
        return types.SimpleNamespace(
            ok=True, message="stub", Dmax=10 ** 1.5, radiation_efficiency=0.9,
            steps_run=100, mcells_per_s=1.0, diagnostics={"device": "cpu"},
            theta=theta, phi=phi, intensity=intensity, freq=freq,
            s11=np.full(11, 0.1 + 0j), z_in=np.full(11, 50 + 0j))

    monkeypatch.setattr(horn, "prepare_horn", prepare)
    monkeypatch.setattr(horn, "run_prepared_horn", run)
    main(["horn", "--frequency-ghz", "12", "--throat-a-mm", "19.05",
          "--throat-b-mm", "9.525", "--aperture-A-mm", "48",
          "--aperture-B-mm", "36", "--length-mm", "40", "--device", "cpu",
          "--outdir", str(tmp_path)])
    assert seen == {"f": pytest.approx(12e9), "device": "cpu"}
    text = capsys.readouterr().out
    summary = json.loads(text[text.index("{"):text.rindex("}") + 1])
    assert summary["Dmax_dbi"] == pytest.approx(15.0)
    assert (tmp_path / "s11.npz").exists()
    png = tmp_path / "horn_pattern.png"
    assert png.stat().st_size > 0 and f"Saved: {png}" in text


_BLOCKED = r"""
import sys
for name in ("jax", "jaxlib", "pydantic", "matplotlib", "mpl_toolkits",
             "tkinter", "streamlit", "plotly"):
    sys.modules[name] = None  # any import of them now raises ImportError
import fdtd_solver_antennas_tpu_torch as port
import fdtd_solver_antennas_tpu_torch.viz as viz
import fdtd_solver_antennas_tpu_torch.viz.scene3d
import fdtd_solver_antennas_tpu_torch.viz.patterns
import fdtd_solver_antennas_tpu_torch.utils as utils
import fdtd_solver_antennas_tpu_torch.utils.backend
import fdtd_solver_antennas_tpu_torch.frontends.gui_app as gui_app
import fdtd_solver_antennas_tpu_torch.frontends.webapp as webapp
import fdtd_solver_antennas_tpu_torch.launch_gui
assert len(port.__all__) >= 60 and "SceneMesh" in viz.__all__
try:
    port.plot_cross_sections
except ImportError:
    print("LAZY plotting needs matplotlib")
try:
    webapp.main(device="cpu")
except ImportError as e:
    print("WEBAPP", "streamlit is not installed" in str(e))
from fdtd_solver_antennas_tpu_torch.__main__ import main
main(["simulate", "--frequency-ghz", "2.45", "--er", "4.3", "--h-mm", "1.6",
      "--device", "cpu", "--outdir", sys.argv[1]])
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "pydantic", "matplotlib",
                                       "tkinter", "streamlit", "plotly")
                and sys.modules[m] is not None)
print("LEAKED", leaked)
"""


def test_port_runs_with_optional_packages_blocked(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED, str(tmp_path)], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    assert "LAZY plotting needs matplotlib" in lines
    assert "WEBAPP True" in lines
    assert "LEAKED []" in lines
    assert "Design:" in lines
    for name in ("cuts.png", "pattern_3d.png"):
        assert (f"Not drawn: {tmp_path / name} (matplotlib is not "
                "installed)") in lines
        assert not (tmp_path / name).exists()


def test_all_is_a_superset_of_jax():
    assert set(jax_package.__all__) <= set(port.__all__)
    for name in port.__all__:
        assert getattr(port, name) is not None, name
    from fdtd_solver_antennas_tpu_torch.viz import plotting

    assert port.plot_3d_pattern_from_grid is plotting.plot_3d_pattern_from_grid
    with pytest.raises(AttributeError):
        port.not_a_name  # noqa: B018


def test_ensure_backend_never_falls_back():
    from fdtd_solver_antennas_tpu_torch.utils.backend import ensure_backend

    assert ensure_backend("cpu") == [torch.device("cpu")]
    if torch.cuda.is_available():
        devs = ensure_backend("cuda")
        assert devs and all(d.type == "cuda" for d in devs)
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            ensure_backend("cuda", retries=2, delay_s=0.0)


def test_trace_and_summary(tmp_path):
    """``utils.tracing.trace`` writes a Chrome trace of the block;
    ``summarize_trace`` reads the newest: device events only (none on the
    CPU), and the device's idle gaps cut where a port span opens or
    closes, each piece labelled with the innermost port span open on the
    host over it (a hand-built trace)."""
    from fdtd_solver_antennas_tpu_torch.utils import (
        cell_rate, summarize_trace, timed, trace)
    from fdtd_solver_antennas_tpu_torch.utils.tracing import span

    a = torch.ones(64, 64)
    with trace(str(tmp_path)) as d:
        with span("fdtd.run"):
            for _ in range(3):
                a = torch.mm(a, a) / 64
    assert d == str(tmp_path)
    files = list(tmp_path.glob("*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)
    assert any(e.get("name") == "fdtd.run"
               and e.get("cat") == "user_annotation" for e in events)
    got = summarize_trace(str(tmp_path), top=50)
    if not torch.cuda.is_available():
        assert got.device == [] and got.gaps == []

    def x(name, cat, ts, dur):
        return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}

    hand = tmp_path / "hand"
    hand.mkdir()
    (hand / "trace.json").write_text(json.dumps({"traceEvents": [
        x("fdtd.prepare", "user_annotation", 0, 100),
        x("fdtd.prepare.voxelize", "user_annotation", 0, 60),
        x("fdtd.prepare.upload", "user_annotation", 70, 20),
        x("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 75, 10),
        x("fdtd.run", "user_annotation", 100, 100),
        x("fdtd.run.sync", "user_annotation", 150, 50),
        x("march_kernel", "kernel", 105, 40),
        x("march_kernel", "kernel", 150, 10),
        x("march_kernel", "kernel", 165, 15),
        x("fdtd.run", "gpu_user_annotation", 105, 75),  # a mirror: ignored
        x("aten::mm", "cpu_op", 0, 300),  # a host op: ignored
        x("march_kernel", "kernel", 220, 10),
        x("Memset (Device)", "gpu_memset", 180, 2),
    ]}))
    got = summarize_trace(str(hand), top=5)
    assert [(n, c) for n, _, c in got.device] == [
        ("march_kernel", 4), ("Memcpy HtoD (Pageable -> Device)", 1),
        ("Memset (Device)", 1)]
    assert [t for _, t, _ in got.device] == pytest.approx([75e-6, 10e-6, 2e-6])
    # busy [75, 85], [105, 145], [150, 160], [165, 182], [220, 230] over
    # [0, 230]; the gaps [0, 75], [85, 105], [145, 150], [160, 165] and
    # [182, 220], cut at 60, 70, 90, 100 and 200
    assert got.gaps[:3] == [("fdtd.prepare.voxelize", pytest.approx(60e-6)),
                            ("between spans", pytest.approx(20e-6)),
                            ("fdtd.run.sync", pytest.approx(18e-6))]
    assert [g[1] for g in got.gaps] == pytest.approx(
        [60e-6, 20e-6, 18e-6, 10e-6, 10e-6] + [5e-6] * 5)
    idle = got.idle_by_label()
    assert idle == pytest.approx({
        "fdtd.prepare.voxelize": 60e-6, "fdtd.prepare": 20e-6,
        "fdtd.prepare.upload": 10e-6, "fdtd.run": 10e-6,
        "fdtd.run.sync": 23e-6, "between spans": 20e-6})
    with pytest.raises(FileNotFoundError):
        summarize_trace(str(tmp_path / "empty"))
    rep = cell_rate(1000, 10, 0.5)
    assert rep.mcells_per_s == pytest.approx(0.02) and "10 steps" in str(rep)
    with timed() as box:
        pass
    assert box["wall_time_s"] >= 0


def test_launch_gui_reports_missing_card(capsys):
    from fdtd_solver_antennas_tpu_torch import launch_gui

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert launch_gui.main() == 1
    assert "CUDA device" in capsys.readouterr().out


def test_webapp_runs_as_a_script_file():
    """``streamlit run <file>`` executes the file without its package; it
    then runs the package's ``main`` (here: the clear ImportError)."""
    import runpy

    try:
        import streamlit  # noqa: F401

        pytest.skip("streamlit installed; gate not exercised")
    except ImportError:
        pass
    path = ROOT / "fdtd_solver_antennas_tpu_torch" / "frontends" / "webapp.py"
    with pytest.raises(ImportError, match="streamlit is not installed"):
        runpy.run_path(str(path), run_name="__main__")
