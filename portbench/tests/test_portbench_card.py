"""Each cell of ``BENCHMARK.json`` once on the card, a one-second window:
it runs, is correct and reports every metric. Marked ``cuda``; skips where
there is no card (decided in the fixture, not at import)."""

import io
import json
from contextlib import redirect_stdout
from pathlib import Path

import pytest

from portbench import run

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the cells run on the card")


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", CELLS)
def test_cell_on_the_card(card, workload, trace):
    out = io.StringIO()
    with redirect_stdout(out):
        rc = run.main(["--workload", workload, "--seed", "4294967311",
                       "--seconds", "1", "--trace", str(trace)])
    assert rc == 0
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["device"]["platform"] == "gpu"
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    want = b["per_layer"] if trace else b["end_to_end"]
    assert set(line["metrics"]) == {m["name"] for m in want}
    if trace:
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
