"""Profiling/tracing helpers.

Counterpart of ``fdtd_solver_antennas_tpu/utils/tracing.py``: a
``torch.profiler`` trace of a block (host operations and, on a card, its
kernels, copies and sets through CUPTI) written as a Chrome trace, a
summary of the newest trace by event name, and a rolling Mcells/s timer.
"""

from __future__ import annotations

import contextlib
import glob
import gzip
import json
import os
import time
from collections import Counter
from pathlib import Path
from typing import Iterator, List, Tuple


@contextlib.contextmanager
def trace(log_dir: str = "fdtd_torch_trace") -> Iterator[str]:
    """Capture a ``torch.profiler`` trace of the enclosed block and write
    it to ``log_dir/trace_<ns>.json`` (Chrome trace format).

    CPU activities always; CUDA activities when a card is present (the
    block's device work is synchronized before the trace closes).

    Usage::

        with trace("mytrace"):
            sim.run()
    """
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield log_dir
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(
        str(Path(log_dir) / f"trace_{time.time_ns()}.json"))


def summarize_trace(log_dir: str, top: int = 20) -> List[Tuple[str, float, int]]:
    """Aggregate the complete (``"ph": "X"``) events of the newest trace
    under ``log_dir`` by name.

    Returns [(name, total_seconds, count)] sorted by total time — enough
    to find the hot kernel or operation without a trace viewer.
    """
    files = glob.glob(str(Path(log_dir) / "*.json")) + glob.glob(
        str(Path(log_dir) / "*.json.gz"))
    if not files:
        raise FileNotFoundError(f"no trace files under {log_dir}")
    newest = max(files, key=os.path.getmtime)
    opener = gzip.open if newest.endswith(".gz") else open
    with opener(newest, "rt") as fh:
        data = json.load(fh)
    events = data.get("traceEvents", []) if isinstance(data, dict) else data
    agg: Counter = Counter()
    cnt: Counter = Counter()
    for e in events:
        if e.get("ph") != "X":
            continue
        name = e.get("name", "?")
        agg[name] += float(e.get("dur", 0))
        cnt[name] += 1
    return [
        (name, dur / 1e6, cnt[name]) for name, dur in agg.most_common(top)
    ]


class StepTimer:
    """Rolling wall-clock → Mcells/s reporter for custom loops."""

    def __init__(self, num_cells: int):
        self.num_cells = num_cells
        self._t0 = time.perf_counter()
        self._steps = 0

    def tick(self, steps: int = 1) -> None:
        self._steps += steps

    @property
    def mcells_per_s(self) -> float:
        dt = max(time.perf_counter() - self._t0, 1e-12)
        return self.num_cells * self._steps / dt / 1e6
