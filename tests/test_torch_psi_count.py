"""The microstrip solvers' prepare spans and the run loop's count of CPML
ψ work (``ops/fdtd.py::psi_cell_updates_per_step``), on the CPU: the
count on ``fdtd.run`` is the kernels' plan worked out by hand on a small
grid, at or above the benchmark's yardstick, and absent under MUR. The
spans record only under a ``torch.profiler``. No JAX."""

import numpy as np
import pytest
import torch

from fdtd_solver_antennas_tpu_torch import PatchAntennaParams
from fdtd_solver_antennas_tpu_torch.models.scene import Scene
from fdtd_solver_antennas_tpu_torch.ops.fdtd import (FDTDConfig,
                                                     build_simulation,
                                                     chunk_geometry,
                                                     psi_cell_updates_per_step,
                                                     run_batched)
from fdtd_solver_antennas_tpu_torch.ops.mesh import MeshBuilder
from fdtd_solver_antennas_tpu_torch.solvers.microstrip_3d import \
    prepare_microstrip_patch_3d
from fdtd_solver_antennas_tpu_torch.utils import tracing
from portbench import yardstick

NPML = 4


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Test workers share the cores (pytest-xdist)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _recorded(fn):
    """``fn()``'s result and the span records it closed, under a
    profiler."""
    seen = {r.index for r in tracing.records()}
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        out = fn()
    return out, [r for r in tracing.records() if r.index not in seen]


def test_the_microstrip_prepare_opens_the_prepare_spans():
    params = PatchAntennaParams.from_user_units(
        frequency_ghz=2.45, er=4.3, h_mm=1.6, loss_tangent=0.02)
    prep, recs = _recorded(lambda: prepare_microstrip_patch_3d(
        params, device="cpu", mesh_quality=1, boundary="PML_8"))
    assert prep.ok, prep.message
    (root,) = [r for r in recs if r.name == "fdtd.prepare"]
    assert root.parent is None
    by = {r.name: r for r in recs}
    for name in ("fdtd.prepare.scene", "fdtd.prepare.voxelize",
                 "fdtd.prepare.coeffs"):
        assert by[name].parent == root.index, name
    scene = by["fdtd.prepare.scene"]
    assert scene.t1 <= by["fdtd.prepare.voxelize"].t0


def _scene():
    s = Scene()
    s.add_material_box("sub", 4.3, 0.05, [-20, -20, 0], [20, 20, 1.6], 0)
    s.add_metal_box("patch", [-10, -8, 1.6], [10, 8, 1.6], priority=10)
    s.add_metal_box("gnd", [-20, -20, 0], [20, 20, 0], priority=10)
    s.add_lumped_port(1, 50.0, [-6, 0, 0], [-6, 0, 1.6], direction="z")
    return s


def _sim(boundary, mode):
    mb = MeshBuilder()
    mb.add_line("x", [-40, 40, 0.0, -6.0])
    mb.add_line("y", [-40, 40, 0.0])
    mb.add_line("z", [-25, 30])
    mb.add_line("z", np.linspace(0, 1.6, 3))
    grid = mb.build(5.0)
    cfg = FDTDConfig(n_steps_max=40, end_criteria=1e-9, check_every=20,
                     probe_decimation=4, boundary=boundary, pallas_mode=mode)
    return build_simulation(_scene(), grid, f0=2.45e9, fc=4e9, cfg=cfg,
                            device="cpu",
                            port_freqs_hz=np.linspace(2e9, 3e9, 5),
                            nf_freqs_hz=np.array([2.45e9]))


def _plan(sim):
    """One step's ψ cell-updates by hand: K1 steps the twelve ψ on every
    cell; the march skips each where its axis's profile is flat, which
    leaves the ``NPML`` nodes at each end of the axis for ψ_e and, for
    ψ_h, the ``NPML`` half cells at each end and the trailing slot past
    the last half cell, over the whole cross-section (two ψ_e and two ψ_h
    take their derivative along each axis)."""
    Q = sim.grid.shape
    assert tuple(sim.padded_shape) == tuple(Q)
    cells = int(np.prod(Q))
    if sim.pallas_mode == "chunk":
        return 12 * cells
    return sum(2 * (2 * NPML + 2 * NPML + 1) * cells // q for q in Q)


def _counts(recs):
    (run,) = [r for r in recs if r.name == "fdtd.run"]
    return run.counts


@pytest.mark.parametrize("mode", ["stream", "chunk"])
def test_psi_cell_updates_is_the_plan_on_a_small_grid(mode):
    sim = _sim(f"PML_{NPML}", mode)
    assert sim.pallas_mode == mode
    out, recs = _recorded(sim.run)
    steps = int(out["steps"])
    assert steps == 40
    per_step = psi_cell_updates_per_step(sim)
    assert per_step == _plan(sim)
    got = _counts(recs)["psi_cell_updates"]
    assert got == per_step * steps
    assert got >= yardstick.psi_cell_updates(sim.grid.shape, NPML, steps)


def test_psi_cell_updates_of_a_batch_counts_the_variants_stepped():
    sim = _sim(f"PML_{NPML}", "stream")
    coeffs = {k: torch.stack([v, v]) for k, v in sim.coeffs.items()}
    out, recs = _recorded(lambda: run_batched(sim, coeffs))
    _d, _n_sub, chunk, _m = chunk_geometry(sim)
    assert out["steps"].tolist() == [40, 40] and chunk == 20
    counts = _counts(recs)
    assert counts["live_variant_chunks"] == 4
    assert counts["psi_cell_updates"] == 2 * 40 * _plan(sim)


@pytest.mark.parametrize("boundary", ["MUR", "PEC"])
def test_no_psi_count_without_cpml(boundary):
    sim = _sim(boundary, "stream")
    assert psi_cell_updates_per_step(sim) == 0
    _out, recs = _recorded(sim.run)
    assert "psi_cell_updates" not in _counts(recs)
