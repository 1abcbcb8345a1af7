"""The metrics that read the port's own spans (``portbench/program_spans.py``)
on a hand-built window and hand-built port records: records outside the
window's jobs are left out, a child span's time is its own and not its
parent's, and each metric gives None where it finds nothing. CPU only."""

from pathlib import Path

import pytest

from portbench import program_spans, run
from portbench.jobs import JobRecord

ROOT = Path(__file__).resolve().parents[2]
NEW = ("scene_ms", "voxelize_ms", "coeffs_ms", "upload_ms", "sync_wait_pct",
       "frozen_variant_pct", "nf2ff_ms")


class Rec:
    """A port span record: the fields ``utils.tracing.SpanRecord`` has."""

    def __init__(self, index, name, t0, t1, parent=None, counts=None):
        self.index, self.name, self.t0, self.t1 = index, name, t0, t1
        self.parent = parent
        self.counts = counts or {}


def window(traced=True):
    jobs = [JobRecord(draw=0.02, t0=10.0, t_end=20.0),
            JobRecord(draw=0.02, t0=20.0, t_end=30.0)]
    return run.Window(jobs, 20.0, 5.0, None, False,
                      trace={"busy_s": 15.0} if traced else None)


def job_records(i0, t, batched):
    """One job's spans from ``t``: prepare 1 s (scene 0.1, voxelize 0.4,
    coeffs 0.45 holding an upload of 0.1, one more upload of 0.02 outside
    it), run 8 s (two chunk reads of 1 and 2 s, the output's of 0.5 s),
    NF2FF 0.1 s."""
    p, c, r = i0, i0 + 4, i0 + 7
    counts = {}
    if batched:
        counts.update(live_variant_chunks=12, frozen_variant_chunks=4)
    return [
        Rec(i0 + 1, "fdtd.prepare.scene", t, t + 0.1, p),
        Rec(i0 + 2, "fdtd.prepare.voxelize", t + 0.1, t + 0.5, p),
        Rec(i0 + 3, "fdtd.prepare.upload", t + 0.8, t + 0.9, c),
        Rec(c, "fdtd.prepare.coeffs", t + 0.5, t + 0.95, p),
        Rec(i0 + 5, "fdtd.prepare.upload", t + 0.96, t + 0.98, p),
        Rec(p, "fdtd.prepare", t, t + 1.0),
        Rec(i0 + 8, "fdtd.run.sync", t + 3.0, t + 4.0, r),
        Rec(i0 + 9, "fdtd.run.sync", t + 6.0, t + 8.0, r),
        Rec(i0 + 10, "fdtd.run.sync", t + 8.5, t + 9.0, r),
        Rec(r, "fdtd.run", t + 1.0, t + 9.0, counts=counts),
        Rec(i0 + 11, "fdtd.post.nf2ff", t + 9.2, t + 9.3),
    ]


def records(batched=False):
    return (
        [Rec(0, "fdtd.prepare.scene", 5.0, 6.0)]  # before the window
        + job_records(100, 10.0, batched) + job_records(200, 20.0, batched)
        + [Rec(300, "fdtd.prepare.scene", 29.5, 31.0),  # past its end
           Rec(301, "fdtd.run", 29.6, 30.5,
               counts={"frozen_variant_chunks": 1000})])


def read(name, w, recs, monkeypatch):
    monkeypatch.setattr(program_spans, "port_records", lambda: recs)
    return run.load_metric(ROOT, name).read(w)


def test_each_metric_reads_the_records_inside_the_window(monkeypatch):
    w = window()
    got = {n: read(n, w, records(batched=True), monkeypatch) for n in NEW}
    assert got == pytest.approx({
        "scene_ms": 100.0, "voxelize_ms": 400.0,
        "coeffs_ms": 350.0,  # 450 less its upload
        "upload_ms": 120.0,  # both uploads
        "sync_wait_pct": 100.0 * 3.5 / 8.0,
        "frozen_variant_pct": 100.0 * 8 / 32,
        "nf2ff_ms": 100.0})


def test_totals_sum_names_self_times_and_counts():
    t = program_spans.totals(window(), records(batched=True))
    assert t["fdtd.prepare"]["s"] == pytest.approx(2.0)
    assert t["fdtd.prepare"]["self_s"] == pytest.approx(2 * 0.03)
    assert t["fdtd.prepare.upload"]["n"] == 4
    assert t["fdtd.run"]["counts"] == {"live_variant_chunks": 24,
                                       "frozen_variant_chunks": 8}
    assert t["fdtd.run.sync"]["n"] == 6


def test_frozen_variant_pct_only_where_the_run_counts_variants(monkeypatch):
    w = window()
    assert read("frozen_variant_pct", w, records(batched=False),
                monkeypatch) is None
    recs = job_records(100, 10.0, True)
    recs[9].counts.update(live_variant_chunks=3, frozen_variant_chunks=1)
    assert read("frozen_variant_pct", w, recs, monkeypatch) == \
        pytest.approx(100.0 * (4 + 1) / (12 + 3 + 4 + 1))


@pytest.mark.parametrize("name", NEW)
def test_none_without_records_or_outside_a_traced_run(name, monkeypatch):
    assert read(name, window(), [], monkeypatch) is None
    assert read(name, window(), None, monkeypatch) is None
    assert read(name, window(traced=False), records(True), monkeypatch) \
        is None
    outside = [Rec(0, n, 1.0, 2.0, counts={"frozen_variant_chunks": 1})
               for n in ("fdtd.prepare.scene", "fdtd.prepare.voxelize",
                         "fdtd.prepare.coeffs", "fdtd.prepare.upload",
                         "fdtd.run", "fdtd.run.sync", "fdtd.post.nf2ff")]
    assert read(name, window(), outside, monkeypatch) is None


def test_a_port_without_span_records_gives_none(monkeypatch):
    """A port older than its spans has no ``records``: the metrics then
    read nothing (the benchmark's files also run over such a checkout)."""
    from fdtd_solver_antennas_tpu_torch.utils import tracing

    monkeypatch.delattr(tracing, "records")
    assert program_spans.port_records() is None
    assert program_spans.totals(window()) is None


def test_the_port_records_what_the_metrics_read():
    """A span the port keeps under a recording profiler reaches the
    metrics' reader with its stamps and counts."""
    import time

    import torch

    from fdtd_solver_antennas_tpu_torch.utils import tracing

    t0 = time.perf_counter()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with tracing.span("fdtd.run") as s:
            s.add("live_variant_chunks", 3)
            s.add("frozen_variant_chunks", 1)
    w = run.Window([JobRecord(draw=0.0, t0=t0, t_end=time.perf_counter())],
                   1.0, 0.0, None, False, trace={"busy_s": 1.0})
    assert run.load_metric(ROOT, "frozen_variant_pct").read(w) == \
        pytest.approx(25.0)
