"""Device time from a ``torch.profiler`` trace of the window.

The harness profiles the window (CPU and CUDA activities) and exports a
Chrome trace under ``TMPDIR``. :func:`reduce` keeps device events only
(kernels, copies and sets), clips them to the window's own span (the
host's ``portbench.window`` range; the profiler also mirrors each range
on the device's timeline, from its first to its last device event, and
those mirrors are left out) and
returns their union (the device's busy time), the time and count of
device events by name, the host's benchmark spans summed by name, and
every idle gap, each labelled with the benchmark span that was open on
the host at its middle (prepare, run, post, or between jobs). The whole
reduction goes on the window's record (``run.Window.trace``), so a new
metric reads any of it without an edit of the harness.
"""

from __future__ import annotations

import json
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "portbench.window"
SPAN = "portbench."


def _union(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def reduce(path: str, top: int = 10) -> Dict:
    """The Chrome trace at ``path`` reduced, times in seconds:

    - ``busy_s``, ``window_s``, ``n_device``: the union of device events,
      the window's length, the number of device events in it;
    - ``device_time``, ``device_count``: each device event name's summed
      time and its number of events, clipped to the window;
    - ``span_s``, ``span_count``: each benchmark span's (``prepare``,
      ``run``, ``post``, …) summed host time and count;
    - ``gaps``: every idle gap, ``[label, seconds]``, longest first;
    - ``device_ops``, ``idle_gaps``: the ``top`` of each, the line's
      ``breakdown``.
    """
    with open(path) as fh:
        data = json.load(fh)
    events = data.get("traceEvents", []) if isinstance(data, dict) else data
    win = None
    spans: List[Tuple[float, float, str]] = []
    dev: List[Tuple[float, float, str]] = []
    for e in events:
        if e.get("ph") != "X":
            continue
        name = e.get("name", "")
        ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
        cat = e.get("cat")
        if cat in DEVICE_CATS:
            dev.append((ts, ts + dur, name))
        elif cat != "user_annotation":  # the host's ranges, not their
            continue                    # mirrors on the device's timeline
        elif name == WINDOW:
            win = (ts, ts + dur)
        elif name.startswith(SPAN):
            spans.append((ts, ts + dur, name[len(SPAN):]))
    if win is None:
        raise ValueError(f"no {WINDOW} span in the trace")
    w0, w1 = win
    clipped = [(max(a, w0), min(b, w1), n) for a, b, n in dev
               if b > w0 and a < w1]
    busy = _union([(a, b) for a, b, _ in clipped])
    by_name: Dict[str, float] = {}
    count: Dict[str, int] = {}
    for a, b, n in clipped:
        by_name[n] = by_name.get(n, 0.0) + (b - a)
        count[n] = count.get(n, 0) + 1
    span_s: Dict[str, float] = {}
    span_count: Dict[str, int] = {}
    for a, b, n in spans:
        span_s[n] = span_s.get(n, 0.0) + (b - a) * 1e-6
        span_count[n] = span_count.get(n, 0) + 1
    gaps = []
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for i in range(0, len(edges), 2):
        a, b = edges[i], edges[i + 1]
        if b > a:
            mid = 0.5 * (a + b)
            label = "between jobs"
            for s0, s1, n in spans:
                if s0 <= mid <= s1:
                    label = n
                    break
            gaps.append((b - a, label))
    gaps.sort(reverse=True)
    gaps = [[label, g * 1e-6] for g, label in gaps]
    ops = [[n, s * 1e-6]
           for n, s in sorted(by_name.items(), key=lambda kv: -kv[1])]
    return dict(
        busy_s=sum(b - a for a, b in busy) * 1e-6,
        window_s=(w1 - w0) * 1e-6,
        n_device=len(clipped),
        device_time={n: s for n, s in ops},
        device_count=count,
        span_s=span_s,
        span_count=span_count,
        gaps=gaps,
        device_ops=ops[:top],
        idle_gaps=gaps[:top],
    )
