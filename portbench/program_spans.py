"""The port's own spans over the window, for the per-layer metrics.

The port keeps a record of each of its spans (``fdtd.prepare``,
``fdtd.run``, ``fdtd.post.nf2ff`` and their parts) while a profiler
records, as in a ``--trace 1`` run (``fdtd_solver_antennas_tpu_torch/
utils/tracing.py``: name, host-clock stamps, parent, counts).
:func:`totals` sums the records that lie inside the window's jobs, from
the first job's start to the last job's end, by name. A port older than
these spans, whose tracing module has no ``records``, gives None (this
file also runs over such a checkout), and so does a run without a trace.
"""

from __future__ import annotations

from typing import Dict, Optional


def port_records():
    """The port's span records, or None where the port keeps none."""
    from fdtd_solver_antennas_tpu_torch.utils import tracing

    records = getattr(tracing, "records", None)
    return None if records is None else records()


def totals(w, recs=None) -> Optional[Dict[str, dict]]:
    """Each span name's ``s`` (summed seconds), ``self_s`` (summed seconds
    less the time its child spans take), ``n`` (spans) and ``counts``
    (summed counts) over the records inside ``w``'s jobs' stamps; None
    outside a traced run or where there are none. ``recs`` defaults to the
    port's records."""
    if w.trace is None or not w.jobs:
        return None
    recs = port_records() if recs is None else recs
    if not recs:
        return None
    t0, t1 = w.jobs[0].t0, w.jobs[-1].t_end
    inside = [r for r in recs if r.t0 >= t0 and r.t1 <= t1]
    if not inside:
        return None
    child_s: Dict[int, float] = {}
    for r in inside:
        if r.parent is not None:
            child_s[r.parent] = child_s.get(r.parent, 0.0) + (r.t1 - r.t0)
    out: Dict[str, dict] = {}
    for r in inside:
        d = out.setdefault(r.name, {"s": 0.0, "self_s": 0.0, "n": 0,
                                    "counts": {}})
        d["s"] += r.t1 - r.t0
        d["self_s"] += r.t1 - r.t0 - child_s.get(r.index, 0.0)
        d["n"] += 1
        for k, v in r.counts.items():
            d["counts"][k] = d["counts"].get(k, 0) + v
    return out


def self_ms_per_job(w, name: str, recs=None) -> Optional[float]:
    """Mean milliseconds a job spends in span ``name`` itself (its child
    spans left out); None where the window has no such span."""
    t = totals(w, recs)
    if t is None or name not in t:
        return None
    return 1e3 * t[name]["self_s"] / len(w.jobs)
