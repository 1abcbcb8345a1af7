"""The port's own spans (``utils/tracing.py``): off, nothing is recorded and
no ``record_function`` is entered; on (a ``torch.profiler`` recording), each
span is a record with its stamps and parent and a range of the same
nesting in the Chrome trace. A canonical prepare and run, and a batched run
whose variants freeze at different chunks, carry the layer boundaries'
spans and counts, and their outputs are bit-equal with the profiler on and
off. CPU only, no JAX."""

import dataclasses
import json
import threading

import numpy as np
import pytest
import torch

from fdtd_solver_antennas_tpu_torch import PatchAntennaParams
from fdtd_solver_antennas_tpu_torch.models.scene import Scene
from fdtd_solver_antennas_tpu_torch.ops.fdtd import (FDTDConfig,
                                                     build_simulation,
                                                     chunk_geometry,
                                                     run_batched)
from fdtd_solver_antennas_tpu_torch.ops.mesh import MeshBuilder
from fdtd_solver_antennas_tpu_torch.solvers import multi_patch_3d as mp
from fdtd_solver_antennas_tpu_torch.utils import tracing
from fdtd_solver_antennas_tpu_torch.utils.tracing import span

SPANS = {"fdtd.prepare", "fdtd.prepare.scene", "fdtd.prepare.voxelize",
         "fdtd.prepare.coeffs", "fdtd.prepare.upload", "fdtd.run",
         "fdtd.run.sync", "fdtd.post.nf2ff"}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Test workers share the cores (pytest-xdist)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def profiled():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def new_records(before):
    seen = {r.index for r in before}
    return [r for r in tracing.records() if r.index not in seen]


def root_of(r, recs):
    """The index of the root span that ``r`` runs under (its own at a
    root), by its parents in ``recs``."""
    by_index = {q.index: q for q in recs}
    while r.parent is not None:
        r = by_index[r.parent]
    return r.index


def test_off_records_nothing_and_enters_no_range(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch._C._autograd._profiler_enabled()
    before = tracing.records()
    a, b = span("fdtd.a"), span("fdtd.b")
    assert a is b  # one shared object that does nothing
    with a as s:
        s.add("live_variant_chunks", 3)
        with b:
            pass
    out = run_batched(*_freeze_batch())  # the port's spans, all off
    assert len(set(out["steps"].tolist())) == 3
    assert new_records(before) == []


def test_records_and_the_chrome_trace_nest_alike(tmp_path):
    before = tracing.records()
    with profiled() as prof:
        with span("fdtd.outer") as o:
            o.add("k", 2)
            o.add("k")
            with span("fdtd.inner"):
                with span("fdtd.leaf") as leaf:
                    leaf.add("n")
            with span("fdtd.inner2"):
                pass
        with span("fdtd.second"):
            pass
    recs = {r.name: r for r in new_records(before)}
    assert set(recs) == {"fdtd.outer", "fdtd.inner", "fdtd.leaf",
                         "fdtd.inner2", "fdtd.second"}
    outer = recs["fdtd.outer"]
    assert outer.parent is None
    assert outer.counts == {"k": 3} and recs["fdtd.leaf"].counts == {"n": 1}
    parent = {"fdtd.inner": "fdtd.outer", "fdtd.leaf": "fdtd.inner",
              "fdtd.inner2": "fdtd.outer", "fdtd.second": None}
    for name, p in parent.items():
        r = recs[name]
        assert r.t0 <= r.t1
        if p is None:
            assert r.parent is None
        else:
            assert r.parent == recs[p].index
            assert root_of(r, recs.values()) == outer.index
            assert recs[p].t0 <= r.t0 and r.t1 <= recs[p].t1
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    ev = {e["name"]: e for e in json.loads(path.read_text())["traceEvents"]
          if e.get("cat") == "user_annotation"}
    assert set(recs) <= set(ev)
    for name, p in parent.items():
        if p is not None:
            c, q = ev[name], ev[p]
            assert q["ts"] <= c["ts"]
            assert c["ts"] + c["dur"] <= q["ts"] + q["dur"]
    assert ev["fdtd.second"]["ts"] >= ev["fdtd.outer"]["ts"] + \
        ev["fdtd.outer"]["dur"]


def test_two_threads_nest_their_spans_independently(monkeypatch):
    """The spans of two threads interleave in time; each thread's nest
    stays its own. (A profiler records the thread that started it, so the
    switch is forced on here for both.)"""
    monkeypatch.setattr(tracing, "_recording", lambda: True)
    before = tracing.records()
    gate = threading.Barrier(2, timeout=30)
    errors = []

    def work(tag):
        try:
            with span(f"fdtd.{tag}.outer"):
                gate.wait()
                with span(f"fdtd.{tag}.inner"):
                    gate.wait()
                gate.wait()
        except Exception as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=work, args=(t,)) for t in "ab"]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert errors == []
    recs = {r.name: r for r in new_records(before)}
    assert len(recs) == 4
    for tag in "ab":
        outer, inner = recs[f"fdtd.{tag}.outer"], recs[f"fdtd.{tag}.inner"]
        assert outer.parent is None and inner.parent == outer.index
    assert recs["fdtd.a.outer"].index != recs["fdtd.b.outer"].index
    assert recs["fdtd.a.inner"].t0 < recs["fdtd.b.inner"].t1
    assert recs["fdtd.b.inner"].t0 < recs["fdtd.a.inner"].t1


def _canonical_prepare():
    p = mp.prepare_multi_patch_3d(
        [mp.PatchLike("p", PatchAntennaParams.from_user_units(
            frequency_ghz=2.45, er=4.3, h_mm=1.6, loss_tangent=0.02))],
        device="cpu", mesh_quality=1, phi_step_deg=30.0, theta_step_deg=15.0,
        auto_margin_mm=(40.0, 40.0, 60.0))
    assert p.ok, p.message
    p.sim.cfg = dataclasses.replace(p.sim.cfg, n_steps_max=300,
                                    check_every=100)
    return p


@pytest.fixture(scope="module")
def canonical():
    """The canonical patch prepared and run under the profiler, and run
    again with it off."""
    before = tracing.records()
    with profiled():
        prep = _canonical_prepare()
        res = mp.run_prepared_multi_patch_3d(prep, frequency_hz=2.45e9,
                                             verbose=0)
        on = prep.sim.run()
    assert res.ok, res.message
    off = prep.sim.run()
    return prep, res, on, off, new_records(before)


def test_canonical_prepare_and_run_spans(canonical):
    prep, res, _on, _off, recs = canonical
    assert {r.name for r in recs} == SPANS
    by = {}
    for r in recs:
        by.setdefault(r.name, []).append(r)
    (pre,) = by["fdtd.prepare"]
    assert pre.parent is None
    for name in ("fdtd.prepare.scene", "fdtd.prepare.voxelize",
                 "fdtd.prepare.coeffs"):
        (r,) = by[name]
        assert r.parent == pre.index
    (coeffs,) = by["fdtd.prepare.coeffs"]
    (vox,) = by["fdtd.prepare.voxelize"]
    # the scene's table, under voxelize; the probe table with the
    # spacings, stamps and walls, under coeffs
    assert [u.parent for u in by["fdtd.prepare.upload"]] == [
        vox.index, coeffs.index]
    assert all(root_of(u, recs) == pre.index
               for u in by["fdtd.prepare.upload"])
    runs = by["fdtd.run"]
    assert len(runs) == 2  # the solver's run and one more
    _d, _n_sub, chunk, _m = chunk_geometry(prep.sim)
    # the loop's chunks, from the steps each run's output reports
    n_chunks = int(res.steps_run) // chunk
    assert n_chunks * chunk == res.steps_run == -(-300 // chunk) * chunk
    for run in runs:
        assert run.parent is None and run.counts == {}
        syncs = [r for r in by["fdtd.run.sync"] if r.parent == run.index]
        assert len(syncs) == n_chunks + 1  # a chunk's read, the output's
    assert len(by["fdtd.run.sync"]) == 2 * (n_chunks + 1)
    (nf,) = by["fdtd.post.nf2ff"]
    assert nf.parent is None


def _same(a, b):
    for k in ("uf", "if_", "steps", "e_ratio"):
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))
    for k in ("nf_e", "nf_h"):
        for x, y in zip(a[k], b[k], strict=True):
            np.testing.assert_array_equal(x, y)
    for x, y in zip(a["fields"], b["fields"], strict=True):
        assert torch.equal(x, y)


def test_canonical_outputs_bit_equal_with_the_profiler_on_and_off(canonical):
    _prep, _res, on, off, _recs = canonical
    _same(on, off)


def _freeze_scene(kappa):
    s = Scene()
    s.add_material_box("sub", 4.3, kappa, [-20, -20, 0], [20, 20, 1.6], 0)
    s.add_metal_box("patch", [-10, -8, 1.6], [10, 8, 1.6], priority=10)
    s.add_metal_box("gnd", [-20, -20, 0], [20, 20, 0], priority=10)
    s.add_lumped_port(1, 50.0, [-6, 0, 0], [-6, 0, 1.6], direction="z")
    return s


def _freeze_batch():
    """Three substrates' losses on one small grid: each variant meets the
    criterion at its own chunk (350, 450 and 600 steps)."""
    mb = MeshBuilder()
    mb.add_line("x", [-40, 40, 0.0, -6.0])
    mb.add_line("y", [-40, 40, 0.0])
    mb.add_line("z", [-20, 30])
    mb.add_line("z", np.linspace(0, 1.6, 3))
    grid = mb.build(5.0)
    cfg = FDTDConfig(n_steps_max=3000, end_criteria=0.1, check_every=25,
                     probe_decimation=5)
    sims = [build_simulation(
        _freeze_scene(k), grid, f0=2.45e9, fc=4e9, cfg=cfg, device="cpu",
        port_freqs_hz=np.linspace(2e9, 3e9, 11),
        nf_freqs_hz=np.array([2.45e9])) for k in (0.005, 0.05, 0.5)]
    coeffs = {k: torch.stack([s.coeffs[k] for s in sims])
              for k in sims[0].coeffs}
    return sims[0], coeffs


def test_batched_frozen_variant_chunks_and_bit_equal_outputs():
    sim, coeffs = _freeze_batch()
    off = run_batched(sim, coeffs)
    before = tracing.records()
    with profiled():
        on = run_batched(sim, coeffs)
    _same(on, off)
    steps = on["steps"]
    _d, _n_sub, chunk, _m = chunk_geometry(sim)
    assert len(set(steps.tolist())) == 3 and not (steps % chunk).any()
    n_chunks = int(steps.max()) // chunk
    live = [int(s) // chunk for s in steps]  # the chunks each one stepped
    recs = new_records(before)
    (run,) = [r for r in recs if r.name == "fdtd.run"]
    assert run.counts == {
        "live_variant_chunks": sum(live),
        "frozen_variant_chunks": sum(n_chunks - c for c in live)}
    assert run.counts["frozen_variant_chunks"] > 0
    syncs = [r for r in recs if r.name == "fdtd.run.sync"]
    assert len(syncs) == n_chunks + 1
    assert all(s.parent == run.index for s in syncs)
