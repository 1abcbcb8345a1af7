"""The CPML reference against the port's CPU path, the control, and the
CPML faults a run must catch, at sizes the CPU holds. Each drives the
harness's own ``run.main`` with the card check skipped (``device="cpu"``,
``chips_check=False``) on a copy of the benchmark with three small cells:

- ``microstrip_q1.pattern_pml8``: the Microstrip 3D job at mesh quality 1
  (50 × 47 × 40 lines) under PML_8, capped at 1,000 steps (1,476 run,
  three chunks, the wave well into the slabs);
- ``microstrip_q1_long.pattern_pml8``: the same job to its own energy
  stop (about 10,800 steps), where the profiles' grading shows in the
  energy left at the stop;
- ``patch_one_chunk.sweep2_pml8``: the canonical patch's sweep under
  PML_8, two variants on their union grid, capped at one chunk.

Their limits are the real CPML cells' (``portbench/limits``). The faults
are planted in the microstrip cells: within the sweep's one chunk the
pulse has not reached the slabs. The port runs its plain PyTorch twins
here; its CUDA kernels are held to the same reference on the card by the
benchmark's own runs. ``python -m pytest
portbench/tests/test_portbench_cpml.py -q`` (about seven minutes).
"""

import dataclasses
import io
import json
import shutil
from contextlib import nullcontext, redirect_stdout
from pathlib import Path

import pytest
import torch

from portbench import check, run, yardstick
from portbench.jobs import JobRecord

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "portbench"
MICROSTRIP = "microstrip_q1.pattern_pml8"
MICROSTRIP_LONG = "microstrip_q1_long.pattern_pml8"
SWEEP = "patch_one_chunk.sweep2_pml8"


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A checkout with the benchmark and the two small cells added."""
    r = tmp_path_factory.mktemp("checkout")
    shutil.copytree(BENCH, r / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((BENCH / "configs/microstrip3d_fr4_2g45.json").read_text())
    cfg.update(name="microstrip_q1", mesh_quality=1, n_steps_max=1000)
    (r / "portbench/configs/microstrip_q1.json").write_text(json.dumps(cfg))
    cfg.update(name="microstrip_q1_long", n_steps_max=30000)
    (r / "portbench/configs/microstrip_q1_long.json").write_text(
        json.dumps(cfg))
    cfg = json.loads((BENCH / "configs/patch_fr4_2g45.json").read_text())
    cfg.update(name="patch_one_chunk", n_steps_max=1)
    (r / "portbench/configs/patch_one_chunk.json").write_text(json.dumps(cfg))
    mix = json.loads((BENCH / "traffic/sweep8_pml8.json").read_text())
    mix["variants"] = 2
    (r / "portbench/traffic/sweep2_pml8.json").write_text(json.dumps(mix))
    for cell, real in ((MICROSTRIP, "microstrip3d_fr4_2g45.pattern_pml8"),
                       (MICROSTRIP_LONG, "microstrip3d_fr4_2g45.pattern_pml8"),
                       (SWEEP, "patch_fr4_2g45.sweep8_pml8")):
        shutil.copy(BENCH / "limits" / f"{real}.json",
                    r / "portbench/limits" / f"{cell}.json")
    for name in ("microstrip_q1", "microstrip_q1_long", "patch_one_chunk"):
        b["configs"].append({"name": name, "source": "x", "reduced": [],
                             "file": f"portbench/configs/{name}.json",
                             "why": "x"})
    b["workloads"] += [
        {"name": MICROSTRIP, "config": "microstrip_q1",
         "traffic": "pattern_pml8", "chips": 1, "why": "x"},
        {"name": MICROSTRIP_LONG, "config": "microstrip_q1_long",
         "traffic": "pattern_pml8", "chips": 1, "why": "x"},
        {"name": SWEEP, "config": "patch_one_chunk", "traffic": "sweep2_pml8",
         "chips": 1, "why": "x"}]
    for m in b["per_layer"]:
        if m["name"] == "psi_share_pct":
            m["workloads"] += [MICROSTRIP, MICROSTRIP_LONG, SWEEP]
    (r / "BENCHMARK.json").write_text(json.dumps(b))
    return r


def drive(root, workload, break_program=None, seed=2**33 + 11, trace=0):
    """One run on the CPU; the JSON line it printed."""
    out = io.StringIO()
    with redirect_stdout(out):
        rc = run.main(["--workload", workload, "--seed", str(seed),
                       "--seconds", "0.5", "--trace", str(trace)],
                      device="cpu", chips_check=False, root=root,
                      break_program=break_program)
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("workload", [MICROSTRIP, SWEEP])
def test_the_port_agrees_with_the_cpml_reference(root, workload):
    line = drive(root, workload)
    assert line["correct"] is True and line["failed"] == 0
    assert set(line["metrics"]) == {"cell_rate", "setup_s"}
    for name, row in line["checks"].items():
        assert row["value"] <= row["limit"], name


def test_a_traced_run_reads_the_psi_share_and_the_scene(root):
    """The port's ψ count over twelve ψ a cell-update: the plan's count a
    step (this grid fits the L2, so K1 steps every ψ on every padded
    cell, more than the grid's cells), at or above the yardstick's floor;
    and the microstrip prepare's scene span."""
    from fdtd_solver_antennas_tpu_torch.ops.fdtd import \
        psi_cell_updates_per_step

    line = drive(root, MICROSTRIP, trace=1)
    assert line["correct"] is True
    b = json.loads((root / "BENCHMARK.json").read_text())
    cell = run.Cell(b, MICROSTRIP, root)
    kind = cell.kind_module.Kind(cell.config, cell.traffic, "cpu")
    sim = kind.prepare(0.02).sim
    assert sim.pallas_mode == "chunk"
    floor = 100.0 * yardstick.psi_cell_updates(kind.lines, 8, 1) / (
        12.0 * kind.cells)
    share = line["metrics"]["psi_share_pct"]["value"]
    assert share == pytest.approx(
        100.0 * psi_cell_updates_per_step(sim) / (12.0 * kind.cells))
    assert share >= floor
    assert line["metrics"]["scene_ms"]["value"] > 0


@pytest.mark.parametrize("workload", [MICROSTRIP, SWEEP])
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


def _psi_zeroed(monkeypatch):
    """Every ψ set to 0 after each step's E update: no convolution."""
    from fdtd_solver_antennas_tpu_torch.ops import fdtd_cuda

    inner = fdtd_cuda.plain.e_update

    def zeroed(ops, st, s):
        inner(ops, st, s)
        for t in (*st.psi_e, *st.psi_h):
            t.zero_()

    monkeypatch.setattr(fdtd_cuda.plain, "e_update", zeroed)


def _r0_1e4(monkeypatch):
    """The profiles graded for a reflection of 1e-4 in place of 1e-8."""
    from fdtd_solver_antennas_tpu_torch.ops import fdtd

    inner = fdtd._cpml_profiles

    def graded(*a, **k):
        return inner(*a, **{**k, "r0": 1e-4})

    monkeypatch.setattr(fdtd, "_cpml_profiles", graded)


def _mur_walls(monkeypatch):
    """First-order MUR walls in the CPML's place, the Huygens box where
    the CPML would keep it."""
    from fdtd_solver_antennas_tpu_torch.solvers import microstrip, sweep

    for mod in (microstrip, sweep):
        def mur(*a, cfg, _inner=mod.build_simulation, **k):
            return _inner(*a, cfg=dataclasses.replace(cfg, boundary="MUR"),
                          nf_margin_cells=cfg.pml_cells() + 3, **k)

        monkeypatch.setattr(mod, "build_simulation", mur)


FAULTS = [(MICROSTRIP, _psi_zeroed), (MICROSTRIP, _mur_walls),
          (MICROSTRIP_LONG, _r0_1e4)]


@pytest.mark.parametrize("workload,fault", FAULTS,
                         ids=[f"{w.split('.')[0]}-{f.__name__[1:]}"
                              for w, f in FAULTS])
def test_a_broken_cpml_path_is_not_correct(root, monkeypatch, workload,
                                           fault):
    """The run's set-up is sound; the fault is planted under the window."""
    line = drive(root, workload, break_program=lambda: fault(monkeypatch))
    assert line["correct"] is False
