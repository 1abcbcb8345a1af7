"""The reference against the port's CPU path, the control, and the faults a
run must catch, at sizes the CPU holds. Each drives the harness's own
``run.main`` with the card check skipped (``device="cpu"``,
``chips_check=False``) on a copy of the benchmark with two small cells:

- ``tiny_patch.design_mur``: the designer's job on one 10 GHz patch in a
  manual 40 × 40 × 24 mm box (64 × 51 × 27 lines, about 1,800 steps to
  its −10 dB stop);
- ``patch_one_chunk.sweep2_mur``: the canonical patch's sweep, two
  variants on their union grid, capped at one chunk.

Their limits are the real cells' (``portbench/limits``). The port runs its
plain PyTorch twins here; its CUDA kernels are held to the same reference
on the card by the benchmark's own runs. ``python -m pytest
portbench/tests -q`` (about five minutes).
"""

import io
import json
import shutil
from contextlib import nullcontext, redirect_stdout
from pathlib import Path

import pytest
import torch

from portbench import check, run
from portbench.jobs import JobRecord

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "portbench"
DESIGN = "tiny_patch.design_mur"
SWEEP = "patch_one_chunk.sweep2_mur"

TINY_PATCH = {
    "name": "tiny_patch", "reduced": [],
    "patches": [{"frequency_ghz": 10.0, "er": 2.2, "h_mm": 0.8,
                 "center_m": [0.0, 0.0, 0.0], "rot_deg": [0.0, 0.0, 0.0],
                 "feed_direction": "-X"}],
    "horns": [],
    "controls": {"mesh_quality": 1, "end_criteria_db": -10.0,
                 "theta_step_deg": 30.0, "phi_step_deg": 45.0,
                 "nf_center_mode": "origin", "simbox_mode": "manual",
                 "manual_size_mm": [40.0, 40.0, 24.0],
                 "auto_margin_mm": [80.0, 80.0, 160.0],
                 "feed_line_length_mm": 4.0, "element_margin_mm": 30.0},
}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A checkout with the benchmark and the two small cells added."""
    r = tmp_path_factory.mktemp("checkout")
    shutil.copytree(BENCH, r / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    (r / "portbench/configs/tiny_patch.json").write_text(json.dumps(TINY_PATCH))
    cfg = json.loads((BENCH / "configs/patch_fr4_2g45.json").read_text())
    cfg.update(name="patch_one_chunk", n_steps_max=1)
    (r / "portbench/configs/patch_one_chunk.json").write_text(json.dumps(cfg))
    mix = json.loads((BENCH / "traffic/sweep8_mur.json").read_text())
    mix["variants"] = 2
    (r / "portbench/traffic/sweep2_mur.json").write_text(json.dumps(mix))
    for cell, real in ((DESIGN, "mixed_patch_horn.design_mur"),
                       (SWEEP, "patch_fr4_2g45.sweep8_mur")):
        shutil.copy(BENCH / "limits" / f"{real}.json",
                    r / "portbench/limits" / f"{cell}.json")
    for name in ("tiny_patch", "patch_one_chunk"):
        b["configs"].append({"name": name, "source": "x", "reduced": [],
                             "file": f"portbench/configs/{name}.json",
                             "why": "x"})
    b["workloads"] += [
        {"name": DESIGN, "config": "tiny_patch", "traffic": "design_mur",
         "chips": 1, "why": "x"},
        {"name": SWEEP, "config": "patch_one_chunk", "traffic": "sweep2_mur",
         "chips": 1, "why": "x"}]
    (r / "BENCHMARK.json").write_text(json.dumps(b))
    return r


def drive(root, workload, break_program=None, seed=2**33 + 7):
    """One run on the CPU; the JSON line it printed."""
    out = io.StringIO()
    with redirect_stdout(out):
        rc = run.main(["--workload", workload, "--seed", str(seed),
                       "--seconds", "0.5", "--trace", "0"], device="cpu",
                      chips_check=False, root=root, break_program=break_program)
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("workload", [DESIGN, SWEEP])
def test_the_port_agrees_with_the_reference(root, workload):
    line = drive(root, workload)
    assert line["correct"] is True and line["failed"] == 0
    assert set(line["metrics"]) == {"cell_rate", "setup_s"}
    assert list(line)[-1] == "checks"
    for name, row in line["checks"].items():
        assert row["value"] <= row["limit"], name


@pytest.mark.parametrize("workload", [DESIGN, SWEEP])
def test_the_control_is_not_correct(root, workload):
    """The reference in the program's place, in bfloat16."""
    b = json.loads((root / "BENCHMARK.json").read_text())
    cell = run.Cell(b, workload, root)
    kind = cell.kind_module.Kind(cell.config, cell.traffic, "cpu")
    draw = 0.02
    sound = kind.run(draw, lambda _name: nullcontext())
    ctl = kind.control(draw, sound.answer.decim, "cpu", torch.bfloat16)
    rec = JobRecord(draw=draw, answer=ctl.answer)
    got = check.compare(ctl.answer, kind.reference(rec, "cpu", torch.float32))
    ok, rows = check.verdict(got, cell.limits)
    assert not ok, rows


def _still(monkeypatch):
    """A step that returns its state unchanged."""
    from fdtd_solver_antennas_tpu_torch.ops import fdtd_stream

    def no_step(*_a, **_k):
        return None

    for name in ("chunk_steps", "chunk_steps_batch", "stream_steps",
                 "stream_steps_batch"):
        monkeypatch.setattr(fdtd_stream.kernels, name, no_step)


def _half_batch(monkeypatch):
    """Half of the batch left out: the second half of the variants never
    steps."""
    from fdtd_solver_antennas_tpu_torch.ops import fdtd_stream

    inner = fdtd_stream.kernels.chunk_steps_batch

    def half(ops, st, wf, n0, n_sub, D, bufs, active):
        act = list(active)
        act[len(act) // 2:] = [False] * (len(act) - len(act) // 2)
        return inner(ops, st, wf, n0, n_sub, D, bufs, act)

    monkeypatch.setattr(fdtd_stream.kernels, "chunk_steps_batch", half)


def _altered_answer(monkeypatch):
    """S11 altered where it is produced: 1% on one bin of every port."""
    from fdtd_solver_antennas_tpu_torch.solvers import multi_patch_3d, sweep

    def wrap(mod):
        inner = mod.port_spectra

        def altered(*a, **k):
            sp = inner(*a, **k)
            sp.s11 = sp.s11.copy()
            sp.s11[0] *= 1.01
            return sp

        monkeypatch.setattr(mod, "port_spectra", altered)

    wrap(multi_patch_3d)
    wrap(sweep)


FAULTS = [(DESIGN, _still), (DESIGN, _altered_answer), (SWEEP, _still),
          (SWEEP, _half_batch), (SWEEP, _altered_answer)]


@pytest.mark.parametrize("workload,fault", FAULTS,
                         ids=[f"{w.split('.')[0]}-{f.__name__[1:]}"
                              for w, f in FAULTS])
def test_a_broken_timed_path_is_not_correct(root, monkeypatch, workload,
                                            fault):
    """The run's set-up is sound; the fault is planted under the window
    (one card: no exchange between chips to leave out)."""
    line = drive(root, workload, break_program=lambda: fault(monkeypatch))
    assert line["correct"] is False
