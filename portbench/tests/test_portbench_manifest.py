"""The benchmark's manifest, its discovery by name, its yardstick and trace
reduction, and the imports of every module under ``portbench/``. CPU only,
no JAX: ``python -m pytest portbench/tests -q``."""

import ast
import json
import math
import re
import shutil
from pathlib import Path

import pytest

from portbench import run, trace, yardstick

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "portbench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "fdtd_solver_antennas_tpu"}


def manifest():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_manifest_keys_names_and_units():
    b = manifest()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["portbench"]
    assert 1 <= b["run_seconds"] <= 51
    names = []
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith("portbench/")
        names.append(c["name"])
        for k in c["reduced"]:
            assert NAME.match(k)
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
        names.append(w["name"])
    metrics = b["end_to_end"] + b["per_layer"]
    assert {m["name"] for m in b["end_to_end"]} == {"cell_rate", "setup_s"}
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    for m in b["end_to_end"]:
        assert set(m) == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] == "cell_rate"
    assert all(NAME.match(n) for n in names)
    assert len(names) == len(set(names))
    assert len(json.dumps(b)) < 64 * 1024


@pytest.mark.parametrize("workload", [w["name"] for w in manifest()["workloads"]])
def test_every_cell_finds_its_files(workload):
    cell = run.Cell(manifest(), workload, ROOT)
    assert hasattr(cell.kind_module, "Kind")
    assert cell.config["reduced"] == []
    limits = cell.limits
    assert limits["decim_excess"] == 0.0
    assert all(v >= 0 and math.isfinite(v) for v in limits.values())
    for m in cell.end_to_end + cell.per_layer:
        mod = run.load_metric(ROOT, m["name"])
        assert mod.UNIT == m["unit"]
        assert mod.MOVES == m.get("moves")
        assert mod.LAYER == m.get("layer")


def _imports(path: Path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], 0
        elif isinstance(node, ast.ImportFrom):
            yield (node.module or "").split(".")[0], node.level


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_module_imports_jax_or_the_jax_package(path):
    """Whole top-level names: the port's name begins with the JAX
    package's, so a prefix test would be wrong both ways."""
    tops = {t for t, level in _imports(path) if level == 0}
    assert not tops & FORBIDDEN
    if "reference" in path.relative_to(BENCH).parts:
        assert "fdtd_solver_antennas_tpu_torch" not in tops
        # and no relative import climbs out of the reference
        assert all(level <= 1 for _t, level in _imports(path))


def test_forbidden_modules_compares_whole_names(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "fdtd_solver_antennas_tpu_torch_x",
                        types.ModuleType("x"))
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib.xla", types.ModuleType("x"))
    assert run.forbidden_modules() == ["jaxlib"]


def test_job_draws_cover_every_stratum_each_cycle():
    """Every seed gives the same strata, in another order, and every job
    its own draw."""
    from itertools import islice

    lo, hi, n = 0.015, 0.025, run.STRATA
    a = list(islice(run.job_draws(2**31 + 5, lo, hi), 3 * n))
    assert a == list(islice(run.job_draws(2**31 + 5, lo, hi), 3 * n))
    assert len(set(a)) == len(a) and all(lo <= x < hi for x in a)
    for c in range(3):
        cycle = a[c * n:(c + 1) * n]
        assert sorted(int((x - lo) / (hi - lo) * n) for x in cycle) == \
            list(range(n))
    b = list(islice(run.job_draws(7, lo, hi), n))
    assert [int((x - lo) / (hi - lo) * n) for x in b] != \
        [int((x - lo) / (hi - lo) * n) for x in a[:n]]


def test_yee_work_and_least_time_on_a_tiny_grid():
    cells, steps = 3 * 4 * 5, 10
    ops = yardstick.job_ops(cells * steps, 0)
    assert ops == 48 * 600
    nbytes = yardstick.job_bytes(cells, variants=2, n_stamps=1, cpml=False)
    assert nbytes == 4 * 19 * 60 * 2
    t, bound = yardstick.least_time(ops, nbytes)
    assert bound == "bytes" and t == nbytes / 3.35e12
    t, bound = yardstick.least_time(1e15, nbytes)
    assert bound == "operations" and t == 1e15 / 67e12
    # ψ: 4 of the 12 ψ for each axis, its 2·npml profile cells
    psi = yardstick.psi_cell_updates((4, 5, 6), 1, steps)
    per_step = sum(4 * 2 * 60 // (q - 1) for q in (4, 5, 6))
    assert psi == per_step * steps
    assert yardstick.psi_cell_updates((4, 5, 6), 0, steps) == 0


def test_trace_reduce_unions_clips_and_labels(tmp_path):
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "portbench.window",
         "ts": 0.0, "dur": 100.0},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "portbench.window",
         "ts": 10.0, "dur": 50.0},
        {"ph": "X", "cat": "user_annotation", "name": "portbench.prepare",
         "ts": 0.0, "dur": 30.0},
        {"ph": "X", "cat": "kernel", "name": "k", "ts": -5.0, "dur": 10.0},
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 40.0, "dur": 20.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "c", "ts": 50.0, "dur": 20.0},
        {"ph": "X", "cat": "cpu_op", "name": "op", "ts": 0.0, "dur": 100.0},
    ]
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": ev}))
    r = trace.reduce(str(p))
    assert r["window_s"] == pytest.approx(100e-6)
    assert r["busy_s"] == pytest.approx((5 + 30) * 1e-6)  # [0,5] ∪ [40,70]
    assert r["device_ops"][0] == ["k", pytest.approx(25e-6)]
    assert r["idle_gaps"] == [["prepare", pytest.approx(35e-6)],
                              ["between jobs", pytest.approx(30e-6)]]
    assert r["gaps"] == r["idle_gaps"]
    assert r["device_time"] == {"k": pytest.approx(25e-6),
                                "c": pytest.approx(20e-6)}
    assert r["device_count"] == {"k": 2, "c": 1}
    assert r["span_s"] == {"prepare": pytest.approx(30e-6)}
    assert r["span_count"] == {"prepare": 1}
    assert r["n_device"] == 3


def test_the_top_of_the_reduction_is_the_breakdown(tmp_path):
    ev = [{"ph": "X", "cat": "user_annotation", "name": "portbench.window",
           "ts": 0.0, "dur": 1000.0}]
    ev += [{"ph": "X", "cat": "kernel", "name": f"k{i}", "ts": 20.0 * i,
            "dur": float(i + 1)} for i in range(12)]
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": ev}))
    r = trace.reduce(str(p))
    assert len(r["device_time"]) == 12 and len(r["gaps"]) == 12
    assert [n for n, _ in r["device_ops"]] == [f"k{i}" for i in
                                               range(11, 1, -1)]
    assert r["idle_gaps"] == r["gaps"][:10]


def test_a_new_config_mix_metric_and_cell_are_found_by_name(tmp_path):
    """Files and entries added beside the benchmark's, nothing edited."""
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = manifest()
    cfg = json.loads((BENCH / "configs" / "patch_fr4_2g45.json").read_text())
    cfg["name"] = "patch_alt"
    (root / "portbench/configs/patch_alt.json").write_text(json.dumps(cfg))
    mix = json.loads((BENCH / "traffic" / "sweep8_mur.json").read_text())
    mix["variants"] = 3
    (root / "portbench/traffic/sweep3_mur.json").write_text(json.dumps(mix))
    (root / "portbench/limits/patch_alt.sweep3_mur.json").write_text(
        (BENCH / "limits" / "patch_fr4_2g45.sweep8_mur.json").read_text())
    new_metrics = {
        "jobs_done": ("jobs", "run loop", "len(w.jobs)"),
        "peak_mem_MiB": ("MiB", "device", "w.peak / 2**20"),
        "gather_share_pct": (
            "%", "kernels",
            "None if w.trace is None else 100 * sum(s for n, s in "
            "w.trace['device_time'].items() if 'gather' in n) "
            "/ w.trace['busy_s']"),
        "prepare_span_ms": (
            "ms", "solver prepare",
            "None if w.trace is None else 1e3 * w.trace['span_s']"
            "['prepare'] / w.trace['span_count']['prepare']"),
        "marched_launches": (
            "launches", "run loop",
            "w.counters['fdtd_cuda.launches_by_form']['marched']"),
        "grid_cells": ("cells", "kernels", "w.kind.cells"),
    }
    for name, (unit, layer, expr) in new_metrics.items():
        (root / f"portbench/metrics/{name}.py").write_text(
            f'NAME = "{name}"\nUNIT = "{unit}"\nLAYER = "{layer}"\n'
            f'MOVES = "cell_rate"\n\n\ndef read(w):\n    return {expr}\n')
    b["configs"].append({"name": "patch_alt", "source": "x",
                         "file": "portbench/configs/patch_alt.json",
                         "reduced": [], "why": "x"})
    b["workloads"].append({"name": "patch_alt.sweep3_mur",
                           "config": "patch_alt", "traffic": "sweep3_mur",
                           "chips": 1, "why": "x"})
    for name, (unit, layer, _expr) in new_metrics.items():
        b["per_layer"].append({"name": name, "unit": unit,
                               "better": "higher", "source": "host_clock",
                               "layer": layer, "moves": "cell_rate",
                               "workloads": ["patch_alt.sweep3_mur"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    cell = run.Cell(b, "patch_alt.sweep3_mur", root)
    assert cell.config["name"] == "patch_alt"
    assert cell.traffic["variants"] == 3
    assert "jobs_done" in [m["name"] for m in cell.per_layer]
    assert "jobs_done" not in [
        m["name"] for m in run.Cell(b, "mixed_patch_horn.design_mur",
                                    root).per_layer]
    kind = type("K", (), {"cells": 7, "n_stamps": 1})()
    counters = {"fdtd_cuda.launches": {"chunk_steps_batch": 5},
                "fdtd_cuda.launches_by_form": {"marched": 5, "streamed": 0}}
    red = {"busy_s": 2.0, "device_time": {"probe_gather_kernel": 0.5,
                                          "march": 1.5},
           "span_s": {"prepare": 0.3}, "span_count": {"prepare": 3}}
    w = run.Window([1, 2, 3], 1.0, 1.0, kind, False, counters,
                   peak=3 * 2**20, trace=red)
    want = {"jobs_done": 3, "peak_mem_MiB": 3.0, "gather_share_pct": 25.0,
            "prepare_span_ms": pytest.approx(100.0), "marched_launches": 5,
            "grid_cells": 7}
    for name, value in want.items():
        assert run.load_metric(root, name).read(w) == value, name
    assert w.launches == 5 and w.busy_s == 2.0
    bare = run.Window([], 1.0, 1.0, kind, False)
    assert run.load_metric(root, "gather_share_pct").read(bare) is None
    assert bare.busy_s is None and bare.launches == 0
    kind = cell.kind_module.Kind(cell.config, cell.traffic, "cpu")
    assert kind.n_var == 3 and kind.cells == 400_722  # its own union grid
