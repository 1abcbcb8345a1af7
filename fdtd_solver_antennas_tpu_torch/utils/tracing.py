"""Profiling/tracing helpers.

Counterpart of ``fdtd_solver_antennas_tpu/utils/tracing.py``, and the
port's own spans:

- :func:`span` opens a named span at a layer boundary of the port
  (``fdtd.prepare``, ``fdtd.run``, ``fdtd.post.nf2ff`` and their parts).
  It records only while a ``torch.profiler`` session records this thread:
  then the span is a ``record_function`` range in that trace, on the
  device trace's clock, and a :class:`SpanRecord` kept in memory
  (:func:`records`). Otherwise it returns one shared object that does
  nothing. The profiler being on is the only switch.
- :func:`trace` captures a ``torch.profiler`` trace of a block (host
  operations and, on a card, its kernels, copies and sets) as a Chrome
  trace; :func:`summarize_trace` reads the newest one: device time by
  name and the device's idle time, each stretch of it put down to the
  innermost port span open on the host over it.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import glob
import gzip
import itertools
import json
import os
import threading
import time
from pathlib import Path
from typing import Dict, Iterator, List, NamedTuple, Optional, Tuple

import torch

# True while a profiler records this thread: a check well under a
# microsecond, where entering a record_function costs about ten even with
# no profiler
_recording = torch._C._autograd._profiler_enabled

MAX_RECORDS = 1 << 16  # the newest spans kept; older ones drop out
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN_PREFIX = "fdtd."


@dataclasses.dataclass
class SpanRecord:
    """One closed span: its name, its host-clock stamps
    (``time.perf_counter()``), the index of the span it ran in on the
    same thread (None at a root) and its counts."""

    index: int
    name: str
    t0: float
    t1: float
    parent: Optional[int]
    counts: Dict[str, int]


_records: collections.deque = collections.deque(maxlen=MAX_RECORDS)
_next_index = itertools.count()
_local = threading.local()


class _Off:
    """The span while nothing records: enters, counts and exits as no-ops."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def add(self, key: str, n: int = 1) -> None:
        pass


_OFF = _Off()


class _Span:
    __slots__ = ("name", "index", "parent", "t0", "counts", "_range")

    def __init__(self, name: str):
        self.name = name
        self.counts: Dict[str, int] = {}

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.index = next(_next_index)
        self.parent = stack[-1].index if stack else None
        stack.append(self)
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        self._range.__exit__(*exc)
        _local.stack.pop()
        _records.append(SpanRecord(self.index, self.name, self.t0, t1,
                                   self.parent, self.counts))
        return False

    def add(self, key: str, n: int = 1) -> None:
        """Add ``n`` to the span's count ``key``."""
        self.counts[key] = self.counts.get(key, 0) + n


def span(name: str):
    """A span named ``name`` around a ``with`` block; its object takes
    counts by ``add(key, n)``. Records only while a ``torch.profiler``
    records this thread (see the module's docstring)."""
    return _Span(name) if _recording() else _OFF


def traced(name: str):
    """Decorator: each call of the function runs inside ``span(name)``."""

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return call

    return wrap


def records() -> List[SpanRecord]:
    """The spans closed so far (the newest :data:`MAX_RECORDS`), in the
    order they closed."""
    return list(_records)


@contextlib.contextmanager
def trace(log_dir: str = "fdtd_torch_trace") -> Iterator[str]:
    """Capture a ``torch.profiler`` trace of the enclosed block and write
    it to ``log_dir/trace_<ns>.json`` (Chrome trace format).

    CPU activities always; CUDA activities when a card is present (the
    block's device work is synchronized before the trace closes). The
    port's spans opened inside the block land in the same trace.

    Usage::

        with trace("mytrace"):
            sim.run()
    """
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


class TraceSummary(NamedTuple):
    """:func:`summarize_trace`'s result, times in seconds.

    ``device``: the top device events (kernels, copies, sets) as
    ``(name, seconds, count)``, most time first. ``gaps``: the device's
    idle time as ``(label, seconds)``, longest first, over the span from
    the first to the last device event or port span. Each idle gap is cut
    where a port span (``fdtd.*``) opens or closes inside it, and each
    piece is labelled with the innermost port span open on the host over
    it, or ``"between spans"``."""

    device: List[Tuple[str, float, int]]
    gaps: List[Tuple[str, float]]

    def idle_by_label(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for label, s in self.gaps:
            out[label] = out.get(label, 0.0) + s
        return out


def summarize_trace(log_dir: str, top: int = 20) -> TraceSummary:
    """Device time by name and the labelled idle gaps of the newest trace
    under ``log_dir`` (see :class:`TraceSummary`). A trace with no device
    events (a CPU run) has neither."""
    files = glob.glob(str(Path(log_dir) / "*.json")) + glob.glob(
        str(Path(log_dir) / "*.json.gz"))
    if not files:
        raise FileNotFoundError(f"no trace files under {log_dir}")
    newest = max(files, key=os.path.getmtime)
    opener = gzip.open if newest.endswith(".gz") else open
    with opener(newest, "rt") as fh:
        data = json.load(fh)
    events = data.get("traceEvents", []) if isinstance(data, dict) else data
    dev: List[Tuple[float, float]] = []
    spans: List[Tuple[float, float, str]] = []
    agg: collections.Counter = collections.Counter()
    cnt: collections.Counter = collections.Counter()
    for e in events:
        if e.get("ph") != "X":
            continue
        name = e.get("name", "?")
        ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
        cat = e.get("cat")
        if cat in DEVICE_CATS:
            dev.append((ts, ts + dur))
            agg[name] += dur
            cnt[name] += 1
        elif cat == "user_annotation" and name.startswith(SPAN_PREFIX):
            spans.append((ts, ts + dur, name))
    device = [(n, d * 1e-6, cnt[n]) for n, d in agg.most_common(top)]
    if not dev:
        return TraceSummary(device, [])
    busy: List[List[float]] = []
    for a, b in sorted(dev):
        if busy and a <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], b)
        else:
            busy.append([a, b])
    lo = min([busy[0][0]] + [s[0] for s in spans])
    hi = max([busy[-1][1]] + [s[1] for s in spans])
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    gaps = []
    for a, b in zip(edges[::2], edges[1::2]):
        if b <= a:
            continue
        over = [s for s in spans if s[0] < b and s[1] > a]
        cuts = sorted({a, b} | {t for s in over for t in s[:2] if a < t < b})
        for p, q in zip(cuts, cuts[1:]):
            mid = 0.5 * (p + q)  # no span opens or closes inside (p, q)
            open_ = [s for s in over if s[0] <= mid <= s[1]]
            label = (min(open_, key=lambda s: s[1] - s[0])[2] if open_
                     else "between spans")
            gaps.append((label, (q - p) * 1e-6))
    gaps.sort(key=lambda g: -g[1])
    return TraceSummary(device, gaps)
