"""The readings the limits of ``correct`` are set from, on the card.

    python3 -m portbench.control --workload <cell> --seeds 1,2,3 --control-seeds 1,2,3

For each seed in ``--seeds``: one job of the program at the draw the
window's first job takes, and the plain reference following its stop
(``portbench/check.py``'s numbers: the lower readings). For each seed in
``--control-seeds``: the control, the reference itself in the program's
place at the next precision below float32 (bfloat16), stopping on its own
energy criterion, against the float32 reference following its stop (the
upper readings). One JSON line a reading on standard output. The
benchmark's own runs do not run this.
"""

import argparse
import json
import sys
import time
from contextlib import nullcontext
from pathlib import Path

from . import check
from .jobs import JobRecord
from .run import ROOT, Cell, cache_env, fmt, job_draws, load_json


def main(argv=None, *, device="cuda", root: Path = ROOT) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args(argv)
    cache_env(root)
    import torch

    cell = Cell(load_json(root / "BENCHMARK.json"), args.workload, root)
    kind = cell.kind_module.Kind(cell.config, cell.traffic, device)
    lo, hi = cell.traffic["loss_tangent"]
    low_dtype = torch.bfloat16  # the precision below the float32 stated

    def draw(seed):
        return next(job_draws(seed, lo, hi))

    def spans(_name):
        return nullcontext()

    def emit(rec):
        print(json.dumps(rec), flush=True)

    decim = None
    for s in [int(x) for x in args.seeds.split(",") if x]:
        t0 = time.perf_counter()
        rec = kind.run(draw(s), spans)
        if rec.failed:
            emit({"seed": s, "side": "program", "failed": rec.failed})
            continue
        decim = rec.answer.decim
        t1 = time.perf_counter()
        got = check.compare(rec.answer, kind.reference(rec, device,
                                                       torch.float32))
        emit({"seed": s, "side": "program", "draw": rec.draw,
              "steps": [int(x) for x in rec.answer.steps],
              "job_s": t1 - t0, "ref_s": time.perf_counter() - t1,
              "numbers": {k: fmt(v) for k, v in got.items()}})
    for s in [int(x) for x in args.control_seeds.split(",") if x]:
        if decim is None:  # the program's decimation, from one job
            decim = kind.run(draw(s), spans).answer.decim
        t0 = time.perf_counter()
        ctl = kind.control(draw(s), decim, device, low_dtype)
        rec = JobRecord(draw=draw(s), answer=ctl.answer)
        ref = kind.reference(rec, device, torch.float32)
        got = check.compare(ctl.answer, ref)
        emit({"seed": s, "side": "control", "dtype": "bfloat16",
              "draw": rec.draw, "steps": [int(x) for x in ctl.answer.steps],
              "s": time.perf_counter() - t0,
              "numbers": {k: fmt(v) for k, v in got.items()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
