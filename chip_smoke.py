"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each printing its own lines and its seconds; any failure raises
and the script exits non-zero without printing a result:

1. environment: torch/CUDA versions, the card, its power limit;
2. build: compile ``csrc/fdtd_chunk.cu``, ``csrc/fdtd_chunk_march.cu``,
   ``csrc/fdtd_stream.cu``,
   ``csrc/fdtd_shard.cu``, ``csrc/fdtd_steps.cu`` and ``csrc/roll_chain.cu``
   with nvcc for sm_90a and the voxelizer's core ``native/voxelize.cpp``
   with g++, all at once; print ptxas registers and memory;
3. K1 vs plain: one 500-step chunk of the small test scene and of the
   canonical patch under MUR, PEC and CPML, through the chunk kernel and
   through the plain PyTorch twins on the same card; then
   ``chunk_steps`` alone (one launch of 5 intervals of D = 89 from parity
   1) against its twin and against the per-step kernels
   (``fdtd_cuda.step_kernels``) at the canonical patch under MUR, PEC and
   PML_8 in the storage form the shape picks and, forced, the streamed
   one, and at the 161×121×160 grid (streamed), with form, blocks ×
   threads, device time per launch and per step beside the bound; then
   each per-step kernel alone against its twin at the canonical shape,
   with its time;
4. main path (canonical slice): ``prepare_patch_fixed`` +
   ``run_prepared_fixed`` on the canonical 2.45 GHz FR-4 patch, which
   resolves to chunk mode: one ``chunk_steps`` launch per termination
   chunk (counts and storage form printed), no per-step launch;
5. golden physics: the openEMS Simple_Patch_Antenna tutorial scene;
6. times: the canonical run through ``chunk_steps`` and through the
   per-step kernels in turns (new, old, old, new), each with its wall
   time, device time per launch and per step and idle share (the
   per-step route's launches counted in that run); the same for the
   PML_8 patch run; one forced-chunk 500-step chunk of the 161×121×160
   grid through both routes and the plain twins, per step;
7. K2 vs plain: ``stream_steps`` alone and one 480-step chunk in stream
   mode against the plain twins (small scene MUR/PEC/PML_4 and its
   z = 131 variant, T = 1..4), and stream mode against chunk mode; the
   route asserted (the march, under MUR, PEC and CPML);
8. main path (large-grid slice): the 4.2M-cell mixed patch+horn scene
   through ``MultiPatchScene.simulate``, which resolves to the stream
   kernel and goes through the march, with launch counts, its wall time
   and idle share (the march's device time per launch timed on the same
   grid); the prepare's seconds and its ``voxelize`` seconds (the native
   core), the NumPy twin's ``voxelize`` on the same scene and grid, timed,
   and the two bit-equal (eps_r, sigma, the three PEC masks);
   ``probe_gather`` on the scene's grouped probe table against its
   twin, bit for bit, its device time beside its bound, the plain twin's
   and a cuSPARSE SpMV's over the same entries, and the table's bytes on
   the card (at most 20 MB); then 2,000 steps kernel vs plain;
9. horn golden: the 12 GHz pyramidal horn against Balanis's 14.06 dBi;
10. times: forced chunk against forced stream at the tall grid and the
    mixed scene; the march's device time per launch and per step beside
    its bound, and K1's; the march's time per step at each T up to the
    resolved one;
11. K3 vs plain: ``shard_steps`` alone against ``shard_steps_plain`` on
    random slab states (owned rows): the canonical slab at one rank
    (m = 120) for a K = 32 and a remainder window under MUR, PEC, an
    interior rank of a 4-way split under MUR and PML_4, a straddle slab;
    the storage form the shape picks and, forced, the other one; each
    line gives the form, blocks × threads and grid barriers a step; the
    canonical launch's device time per launch and per step beside its
    bound and the first design's time;
12. main path (explicit slice): the canonical patch through
    ``build_explicit_run`` on one card (one rank), with launch counts
    (by storage form), held to the chunk-mode run of phase 4, S11 and
    Dmax from the port's post-processing;
13. times: the JAX bench's pinned explicit run (160,000 steps) beside
    chunk mode on the same scene, and K3's launch and per-step time
    beside the first design's;
14. K4 (interval slice): ``interval_steps`` alone against its plain twin
    on random states at the canonical patch (MUR and PEC, D = 89, both
    storage forms) and the 161×121×160 grid, with form, blocks ×
    threads, barriers a step, device time per launch and per step beside
    its bound, the first design's time and an empty cooperative launch of
    2·D grid barriers at the same blocks × threads; then the canonical
    patch through ``fdtd_steps.build_stepper``'s ``step_fn`` for 125
    intervals (11,125 steps) from zero fields, held to the same steps
    through K1's field kernels;
15. K5 (roofline slice): ``roll_chain`` (one block a row) against its
    twin at 56×7,040, 200 iterations, bit for bit, timed in turns, with
    its blocks, SMs used, the SM clock, its shared-memory bound over all
    the card's SMs (the table's ``bound_ms``), the same bound over the SMs
    the design holds (its own ceiling) and its FLOP bound; then the
    roofline entry point
    ``fdtd_solver_antennas_tpu_torch.examples.chunk_roofline.main()`` on
    the card, which prints its JSON line;
16. K1 batched (sweep slice): ``chunk_steps_batch`` against its plain
    twin, two chunks with one variant frozen in the second, at the small
    scene (B = 3, MUR/PEC/PML_4) and the canonical patch (B = 2,
    MUR/PML_8), in the form the shape picks and every other form the plan
    allows (streamed, resident, and under MUR and PEC the marched form of
    ``csrc/fdtd_chunk_march.cu``, whose T = 3 divides neither D = 5 nor
    D = 89); B = 1 bit-equal to ``chunk_steps`` (the marched form too);
    then the main path:
    ``bench.py``'s 8-variant canonical-patch sweep (2,000 steps) through
    ``prepare_patch_geometry_sweep`` and ``run_patch_geometry_sweep`` in
    the form the plan picks and, the plan's rule patched, in the other
    of the streamed and marched forms (each asserts one
    ``chunk_steps_batch`` launch per chunk in that form and no other
    launch; their steps, energy ratios and spectra agree; eight distinct
    spectra), its prepare time, wall time, aggregate rate and idle share,
    one launch of each form at its shapes against the twin, the streamed
    form, the marched form and K2's batched march timed on the device in
    the same call beside their bounds (the plan may pick the marched form
    only where it is the faster); the same eight variants
    as eight unbatched ``chunk_steps`` runs in turns; ``tests/test_sweep.py``'s
    two patches at 6,000 steps held to the cavity model, and its two
    12 GHz horn apertures held to their gain;
17. K2's slab stepper (explicit slice at Pz > 128):
    ``stream_shard_steps`` against ``fdtd_shard.shard_steps_plain`` on
    random slab states (owned rows): a z = 131 slab at one rank (MUR T
    and remainder windows, PEC, PML_4), PML_4 and PEC on interior ranks
    of a 4-way split, rank 0, an interior rank, the upper wall on an x
    segment's last plane and the last rank's straddle of a 4-way split
    at z = 131, and the mixed scene's one-rank slab, timed beside its
    bound and phase 8's single-card march; then the main path: phase 8's
    prepared mixed scene through ``build_explicit_run`` on one card to
    its stop and its post-processing (asserts only ``shard_march``
    launches, an energy-criterion stop, phase 8's steps, resonance,
    |S11|min and Dmax), 2,000 explicit steps against 2,000 steps of the
    single-card stream run; the tall grid under PML_8 through
    ``build_explicit_run`` (the slab march under CPML, held to the
    single-card run) and one such launch timed beside its bound, the
    single-card march on the same grid at the same T and the tile
    kernel's time that the route had before (PERF.md).
    A slab launch's bound counts the owned rows and the halos a
    neighbour fills: at one rank, the whole grid's;
18. K2 batched (the sweep slice in stream mode, K2's ``coef_ops_from``
    form): ``stream_steps_batch`` against ``stream_steps_batch_plain`` at
    the 8-variant sweep's shapes, one batched march launch under MUR and
    one under CPML (the same sweep prepared with PML_8), variant 3
    frozen and bit-unchanged, each timed beside its bound and the twin
    (PML_8: and the tile kernel's earlier time); one chunk of the PML_8
    sweep through ``run_patch_geometry_sweep`` (its launches counted);
    B = 1 bit-equal to ``stream_steps``;
    then the main path: ``bench.py``'s 8-variant sweep through
    ``prepare_patch_geometry_sweep(..., pallas_mode="stream")`` and
    ``run_patch_geometry_sweep`` (asserts only ``stream_march_batch`` and
    ``probe_gather_batch`` launches, phase 16's 2,440 steps, eight
    distinct spectra, each variant's f_res and |S11|min phase 16's within
    rtol 2e-3), the wall of a run and a rerun beside phase 16's, the idle
    share; ``probe_gather_batch`` bit-equal to its twin, timed beside its
    bound, the twin and a cuSPARSE SpMM; and the automatic route: the two
    12 GHz horn apertures at ``mesh_ppw`` 20, whose working set exceeds
    the L2, resolve to stream with no argument and run one chunk on the
    batched march;
19. main path (the CPML slice): the mixed scene with
    ``controls.boundary = "PML_8"`` through ``MultiPatchScene.simulate``
    (asserts stream mode at T = 4, ``stream_march`` launches = steps ÷ T
    and no other stepping kernel, the gathers counted, an
    energy-criterion stop, finite Dmax, intensity and both ports' S11),
    its prepare seconds, steps, wall, rate and idle share, and two warm
    reruns of the same preparation; the march on that grid against its
    twin, timed beside its bound (each ψ moved only outside its axis's
    flat profile run, where it stays 0) and the bound moving all twelve ψ
    everywhere; the march with that ψ skip off, both bit-equal to the
    twin, timed in turns; its time per step at each T up to 4 with the
    blocks an SM holds; then 2,000 steps kernel vs plain, ψ included;
20. main path (the microstrip slice): the canonical FR-4 patch fed by its
    microstrip at the solver's own mesh (λ/20), with an MSL port and with
    a lumped port, both under PML_8, through ``prepare_microstrip_patch``
    and ``run_prepared_microstrip`` to the solver's stop (its energy
    criterion, or its 30,000-step cap, which the MSL run reaches), then the CLI's
    ``s11`` (``--solver microstrip`` by default, MUR, the default
    ``--steps-max``) through ``__main__.main``, which writes ``s11.npz``
    and ``s11.s1p`` under ``outputs/smoke_s11``: each run resolves to chunk
    mode and launches ``chunk_steps`` alone (asserted); one launch at each
    scene's operands and own chunk, on a seeded state, against the plain
    twin (fields, ψ and every probe sample, the three MSL rows included),
    timed beside its bound; the physics of tests/test_msl_port.py on the
    runs that test makes (5,000 steps asked: both S11 finite, the MSL dip
    in 1.6–2.3 GHz within 2% of the lumped one and below −10 dB, the
    deembedded Re Z_L within 10% of 50 Ω over 2.0–2.9 GHz, Re β > 0
    there), the same figures of the full runs printed beside; steps, wall,
    rate, launches, idle share, f_res and |S11|min of each run;
21. the other solvers of the slice: ``microstrip_3d`` at mesh quality 5
    under PML_8 (stream mode, asserted: the CPML march and
    ``probe_gather`` alone; one march launch on its state against the
    twin, timed beside its bound), the legacy solver and the quasi-2D
    slice (chunk mode under CPML: ``chunk_steps`` alone, one launch
    against the twin), each to its energy stop, held to the bounds of
    tests/test_solvers.py (full sphere for the first two), with phase
    20's figures;
22. the multi-port slice: tests/test_sparams.py's two-patch scene through
    ``compute_s_matrix`` (K1 alone; each one-hot run against the plain
    twins; its reciprocity error under that test's 5e-3·max|S|); the 2×1
    array of the canonical FR-4 patch at the CLI's defaults through
    ``design_array`` (two one-hot runs, ``chunk_steps`` alone, one launch
    at the array's shapes against the twin and timed beside its bound;
    reciprocity error and passivity margin printed, not gated: the runs
    stop on their energy criterion), its all-ports-on run against the
    embedded patterns' superposition (residual < 2e-2,
    tests/test_array_synth.py), drives (1, 0), (0, 1) and (1, 1) of the
    same preparation at a fixed 4 chunks (linear to float32 rounding:
    K1's resident form sees each new stamp), that run stopped after two
    chunks, saved with ``save_state`` under ``outputs/smoke_checkpoint``,
    loaded and resumed to the straight run, and the CLI's ``array --nx 2
    --ny 1`` through ``__main__.main`` (``chunk_steps`` alone; writes
    ``array_embedded.npz`` and ``array.s2p`` under
    ``outputs/smoke_array``, held to ``design_array``'s); then the mixed
    scene's two-port S matrix under MUR through phase 8's prepared
    simulation (two one-hot runs on the march, ``stream_march`` and
    ``probe_gather`` alone) and one state re-excited between two march
    launches against the plain twin. Each run's steps, wall, launches and
    idle share are printed;
23. the inverse-design slice at the CLI's defaults (47×40×33, a 28×18 px
    region, 3,310 differentiable steps, run as 3,350 in 67 checkpointed
    chunks of 50): the exposed step (``ops.fdtd.ExposedStep``, PyTorch's
    operations on the card) against K1's ``chunk_steps`` over one launch
    of 500 × D = 1 steps on the overlay of a thresholded seeded density
    (fields and every step's probe samples); the S11-band and broadside
    losses with their gradients, finite, the largest-|g| pixel against
    central differences (ε = 5e-2, within 5%: tests/test_inverse.py);
    ``optimize(n_iters=3, lr=0.1)`` lowering the loss, each iteration's
    wall, forward and forward + backward µs a step and peak memory;
    ``validate(..., pattern=True)`` of the result through K1's
    ``chunk_steps`` alone (counted) and ``nf2ff_transform`` on the card,
    the base coefficients bit-equal afterwards, ρ ≡ 1 equal bit
    for bit to the metal-patch scene built fresh and run; one such launch
    against its twin, timed beside its bound; then the CLI's ``inverse
    --iters 1`` through ``__main__.main`` (``chunk_steps`` alone; writes
    ``inverse_design.npz`` under ``outputs/smoke_inverse``).

24. the parallel slice, in a one-rank NCCL process group: (a) the
    explicit path's per-step walk kernels (``h_update``, ``e_update``,
    the three ``mur_faces`` and ``e_update_mur``, the last asserted
    bit-equal) against their twins on slabs of the mixed scene (3 ranks'
    slabs, the x walls in and out of them, and the one-rank slab the main
    path runs, there timed beside the bound); (b) the canonical patch to
    its stop through the walk (``build_explicit_run(use_kernel=False)``
    inside ``run_prepared_fixed``) against K1's chunk-mode run, the
    walk's route (``Walk.fused``: no wall straddles the one rank) and
    launches asserted (a ``h_update`` and an ``e_update_mur`` a step, a
    ``probe_gather`` an interval, nothing else), its wall, µs a step and
    idle share, and the walk kernels on its slab against their twins,
    timed beside their bounds; (c) the mixed scene (Pz 152) to its stop
    through the walk, held to the explicit path's march route, its µs a
    step beside the march route's and K1 forced onto the grid;
    (d) ``shard_simulation`` of the canonical patch over the one-rank
    mesh, ``sim.run()`` equal to the unsharded run; (e) ``shard_sweep`` of
    ``bench.py``'s 8-variant sweep over the one-rank sweep mesh: its
    launches (``chunk_steps_batch`` alone, phase 16's count) and its
    results bit-equal to the unsharded sweep's.

25. the frontends slice: (a) the CLI's ``simulate`` and ``fdtd --solver
    fixed`` at phase 4's arguments through ``__main__.main`` (``fdtd``:
    ``chunk_steps`` alone, phase 4's 25 launches, its summary and
    ``s11.npz`` equal to phase 4's run), each figure saved or named as not
    drawn, and whether matplotlib is installed; (b) the desktop GUI's
    ``dispatch_prepare`` for its five solver kinds on the canonical FR-4
    patch (microstrip_3d at phase 21's quality 5 and PML_8), each runner
    on a worker thread with ``progress_cb`` and ``abort_cb`` wired as the
    GUI's worker wires them (the thread's device and stream printed):
    ``chunk_steps`` alone for four kinds, the march and ``probe_gather``
    alone for microstrip_3d, ``fixed`` equal to phase 4's run bit for bit,
    the others' equality with phases 20 and 21 printed, with steps,
    resonance, |S11|min, Dmax and ``format_port_diagnostics``' lines; (c)
    the web app's ``BackgroundRun``: the canonical run (ticks monotone, the
    result equal to phase 4's main-thread run bit for bit), ``sim.run``
    aborted after its first tick (one chunk) and its state resumed to the
    straight run, ``design_array`` of the 2×1 array equal to phase 22's S
    matrix bit for bit; (d) ``open_scene_3d_view`` of the mixed designer
    scene (its HTML's size) and ``utils.tracing.trace`` around a canonical
    run, ``summarize_trace`` naming ``chunk_steps_kernel`` with phase 4's
    25 events. Under 60 s.

26. the usage scripts (``fdtd_solver_antennas_tpu_torch/examples/``), each
    through its function on the card, its files into a temporary
    directory, its lines printed and its launches counted:
    ``checkpoint_resume`` at the JAX script's budgets (the resumed run
    against the straight one: steps equal, rtol 2e-4, and whether
    bit-equal; ``chunk_steps`` alone), ``design_sweep``'s three variants
    (``chunk_steps_batch`` alone; each dip beside phase 16's cavity
    model; one chunk in its plan's form against the twin and timed at its
    shapes, that form's row of the kernels line), ``multi_patch_array`` (``chunk_steps`` alone),
    ``mixed_patch_horn`` (the march at T = 4 and ``probe_gather`` alone,
    equal to phase 8's run bit for bit), ``stream_tune`` over T = 1..5 on
    the tall grid (T = 5 refused, every T's ``uf`` bit-equal to T = 1's),
    both inverse-design scripts at their meshes cut to one Adam iteration
    (the loss finite, ``validate`` on ``chunk_steps`` alone); then the
    canonical run from a fresh thread, bit-equal to the main thread's,
    each thread's current device the same before and after. Under 90 s;
    then the whole smoke's seconds.

The next-to-last line is the kernel table as JSON, the last line
``{"ok": true, "device": {...}}``. Needs no network and one card. It
exits non-zero when CUDA is unavailable.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

from fdtd_solver_antennas_tpu_torch.examples.scenes import (
    canonical_params, card_line, device_ms, mixed_designer, shard_sim,
    sweep_operands, sweep_variants, tall_scene)

RTOL = 2e-4  # the JAX package's own kernel-vs-XLA tolerance
ATOL_REL = 1e-5  # atol = 1e-5 · max|plain|
K1_SOURCE = "fdtd_solver_antennas_tpu_torch/csrc/fdtd_chunk.cu"
K1_REPLACES = "fdtd_solver_antennas_tpu/ops/fdtd_pallas.py:1376"
K1M_SOURCE = "fdtd_solver_antennas_tpu_torch/csrc/fdtd_chunk_march.cu"
K2_SOURCE = "fdtd_solver_antennas_tpu_torch/csrc/fdtd_stream.cu"
K2_REPLACES = "fdtd_solver_antennas_tpu/ops/fdtd_pallas.py:468"
K3_SOURCE = "fdtd_solver_antennas_tpu_torch/csrc/fdtd_shard.cu"
K3_REPLACES = "fdtd_solver_antennas_tpu/ops/fdtd_pallas.py:1953"
K4_SOURCE = "fdtd_solver_antennas_tpu_torch/csrc/fdtd_steps.cu"
K4_REPLACES = "fdtd_solver_antennas_tpu/ops/fdtd_pallas.py:64"
SWEEP_STEPS = 2000  # bench.py's geometry sweep (bench_geometry_sweep)
K5_SOURCE = "fdtd_solver_antennas_tpu_torch/csrc/roll_chain.cu"
K5_REPLACES = "examples/chunk_roofline.py:46"
# NVIDIA H100 SXM data sheet peaks (at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
JAX_MIXED_STEPS = 22_500  # the JAX package's step count for the mixed scene
PINNED_STEPS = 160_000  # bench.py's explicit-path run (bench_shard_kernel_1dev)
# The first design of K3 and K4 (5 grid barriers a step under MUR, every
# operand re-read each pass), us per launch on an NVIDIA H100 80GB HBM3 at
# 700.00 W (PERF.md): K3 at the canonical one-rank slab, K = 32; K4 at the
# canonical patch (D = 89) and the 161x121x160 grid (D = 50).
K3_FIRST_US = {"MUR": (650.2, 653.9)}
K4_FIRST_US = {("canonical", "MUR"): (1413.0, 1428.4),
               ("canonical", "PEC"): (680.3, 682.2),
               ("tall", "MUR"): (6941.0, 6944.2)}


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def close(name, got, ref) -> float:
    """Assert got ≈ ref at RTOL / ATOL_REL·max|ref|; return max |got−ref|."""
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = ref.detach().cpu().numpy() if torch.is_tensor(ref) else np.asarray(ref)
    atol = ATOL_REL * max(float(np.abs(ref).max()), 1e-20)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=atol, err_msg=name)
    return float(np.abs(got - ref).max()) if got.size else 0.0


def small_scene():
    """The small scene of the JAX package's kernel tests."""
    from fdtd_solver_antennas_tpu_torch.models.scene import Scene
    from fdtd_solver_antennas_tpu_torch.ops.mesh import MeshBuilder

    mb = MeshBuilder()
    mb.add_line("x", [-40, 40, 0.0, -6.0])
    mb.add_line("y", [-40, 40, 0.0])
    mb.add_line("z", [-20, 30])
    mb.add_line("z", np.linspace(0, 1.6, 3))
    grid = mb.build(5.0)
    scene = Scene()
    scene.add_material_box("sub", 4.3, 0.005, [-20, -20, 0], [20, 20, 1.6], 0)
    scene.add_metal_box("patch", [-15, -12, 1.6], [15, 12, 1.6], priority=10)
    scene.add_metal_box("gnd", [-20, -20, 0], [20, 20, 0], priority=10)
    scene.add_lumped_port(1, 50.0, [-6, 0, 0], [-6, 0, 1.6], direction="z")
    return scene, grid, 2.45e9, 1.225e9


def canonical_scene():
    from fdtd_solver_antennas_tpu_torch.solvers.patch_fixed import build_patch_scene

    return build_patch_scene(canonical_params())


def tall131_scene():
    """The small scene with 131 z lines (tests/test_stream_kernel.py)."""
    from fdtd_solver_antennas_tpu_torch.models.scene import Scene
    from fdtd_solver_antennas_tpu_torch.ops.mesh import MeshBuilder

    mb = MeshBuilder()
    mb.add_line("x", [-40, 40, 0.0, -6.0])
    mb.add_line("y", [-30, 30, 0.0])
    mb.add_line("z", np.linspace(-20, 30, 131))
    grid = mb.build(5.0)
    scene = Scene()
    scene.add_material_box("sub", 4.3, 0.005, [-20, -20, 0], [20, 20, 1.6], 0)
    scene.add_metal_box("patch", [-15, -12, 1.6], [15, 12, 1.6], priority=10)
    scene.add_metal_box("gnd", [-20, -20, 0], [20, 20, 0], priority=10)
    scene.add_lumped_port(1, 50.0, [-6, 0, 0], [-6, 0, 1.6], direction="z")
    return scene, grid, 2.45e9, 1.225e9


def one_chunk_sim(make_scene, boundary, n_steps=500, mode=None, T=None,
                  decim=50):
    """One chunk of ``n_steps`` steps (a multiple of ``decim``) with a
    probe sample every ``decim``; ``mode`` forces "chunk" or "stream"."""
    from fdtd_solver_antennas_tpu_torch.ops.fdtd import FDTDConfig, build_simulation

    scene, grid, f0, fc = make_scene()
    cfg = FDTDConfig(n_steps_max=n_steps, check_every=n_steps,
                     end_criteria=1e-30, boundary=boundary,
                     probe_decimation=decim, pallas_mode=mode, stream_T=T)
    return build_simulation(
        scene, grid, f0=f0, fc=fc, cfg=cfg, device="cuda",
        port_freqs_hz=np.linspace(2e9, 3e9, 51),
        nf_freqs_hz=np.array([2.45e9]))


def timed_run(sim, impl):
    from fdtd_solver_antennas_tpu_torch.ops.fdtd import run_simulation

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run_simulation(sim, impl)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def host_ms(fn, reps=50, warmup=5) -> float:
    """Wall milliseconds per call, host clock, ending in a synchronize:
    what a caller waits for, launch overhead included."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def events_ms(fn, reps=5, warmup=2) -> float:
    """Milliseconds per call between two CUDA events, no sleep kernel:
    device time where the device, not the host, is the slower side."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def compare_runs(ko, po, what="") -> float:
    """Assert two runs' output surfaces agree; return the max |err|."""
    assert ko["steps"] == po["steps"], (what, ko["steps"], po["steps"])
    err = 0.0
    for i, (a, b) in enumerate(zip(ko["fields"], po["fields"])):
        err = max(err, close(f"{what} field {i}", a, b))
    for key in ("uf", "if_"):
        err = max(err, close(f"{what} {key}", ko[key], po[key]))
    for key in ("nf_e", "nf_h"):
        for a, b in zip(ko[key], po[key]):
            err = max(err, close(f"{what} {key}", a, b))
    for grp in ("psi_e", "psi_h"):
        for k, v in po["state"][grp].items():
            err = max(err, close(f"{what} {grp} {k}", ko["state"][grp][k], v))
    return err


def phase_kernel_vs_plain():
    from fdtd_solver_antennas_tpu_torch.ops import fdtd_cuda

    worst = 0.0
    for label, make, boundaries in (
        ("small", small_scene, ("MUR", "PEC", "PML_4")),
        ("canonical", canonical_scene, ("MUR", "PEC", "PML_8")),
    ):
        for boundary in boundaries:
            sim = one_chunk_sim(make, boundary)
            assert sim.pallas_mode == "chunk", sim.pallas_mode_reason
            ko, tk = timed_run(sim, fdtd_cuda.kernels)
            po, tp = timed_run(sim, fdtd_cuda.plain)
            err = compare_runs(ko, po, f"{label} {boundary}")
            worst = max(worst, err)
            say("3", f"{label} {sim.grid.shape} {boundary}: {ko['steps']} steps "
                     f"kernel == plain (rtol {RTOL}, atol {ATOL_REL}*max|plain|), "
                     f"max |err| {err:.3e}; kernel {tk:.3f} s, plain {tp:.3f} s")
    return worst


def step_route_ms(ops, st, out):
    """Device milliseconds of one leapfrog step through the per-step
    kernels (``h_update``, ``e_update`` and, under MUR, ``mur_faces`` on
    the three axes) and of one ``probe_gather``, each timed alone on
    ``st``."""
    from fdtd_solver_antennas_tpu_torch.ops import fdtd_cuda as fc

    step = (device_ms(lambda: fc.h_update(ops, st))
            + device_ms(lambda: fc.e_update(ops, st, 0.37)))
    if ops.mur is not None:
        step += device_ms(lambda: [fc.mur_faces(ops, st, a) for a in range(3)])
    return step, device_ms(lambda: fc.probe_gather(ops, st, out))


def phase_chunk_steps(card):
    """``chunk_steps`` against its plain twin and against the per-step
    kernels (``fdtd_cuda.step_kernels``): one launch of n_sub intervals
    from parity 1 and step 7 on a seeded random state, every field, ψ and
    probe sample compared, in the form the shape picks and, at the
    canonical patch, the streamed form forced; each timed on the device
    beside its bound, the per-step route's device time for the same
    chunk beside it. Returns the rows by (grid, boundary, form)."""
    from fdtd_solver_antennas_tpu_torch.ops import fdtd_cuda

    cases = (("canonical", canonical_scene, "MUR", 89, 5, (None, "streamed")),
             ("canonical", canonical_scene, "PEC", 89, 5, (None, "streamed")),
             ("canonical", canonical_scene, "PML_8", 89, 5, (None, "streamed")),
             ("tall", tall_scene, "MUR", 50, 10, (None,)))
    rows = {}
    for label, make, boundary, decim, n_sub, forms in cases:
        sim = one_chunk_sim(make, boundary, n_sub * decim, mode="chunk",
                            decim=decim)
        ops, D = sim.operands, sim.probe_decim
        assert D == decim, (D, decim)
        base = random_state(sim, seed=83)
        base.parity = 1
        wf = torch.from_numpy(np.random.default_rng(89).uniform(
            -1.0, 1.0, 7 + n_sub * D).astype(np.float32)).to(sim.device)
        bufs = torch.zeros((n_sub, ops.probes.n_rows), device=sim.device)
        sp, bp = clone_state(base), bufs.clone()
        fdtd_cuda.chunk_steps_plain(ops, sp, wf, 7, n_sub, D, bp)
        so, bo = clone_state(base), bufs.clone()
        fdtd_cuda.step_kernels.chunk_steps(ops, so, wf, 7, n_sub, D, bo)
        torch.cuda.synchronize()
        steps = n_sub * D
        # the per-step route's device time for the same chunk, from each
        # of its kernels timed alone (a chunk's thousands of launches would
        # overflow the queue behind the sleep)
        step_ms, gather_ms = step_route_ms(ops, clone_state(so), bo[0].clone())
        old_ms = steps * step_ms + n_sub * gather_ms
        b_ms, b_by = k1_chunk_bound(ops, n_sub, D)
        a_ms = k1_chunk_bound(ops, n_sub, D, all_psi=True)[0]
        for form in forms:
            sk, bk = clone_state(base), bufs.clone()
            plan = fdtd_cuda.chunk_launch_plan(ops, sk, form)
            fdtd_cuda.chunk_steps(ops, sk, wf, 7, n_sub, D, bk, form=form)
            torch.cuda.synchronize()
            assert sk.parity == sp.parity == 1 ^ steps & 1
            got, ref = (*fields_of(sk), bk), (*fields_of(sp), bp)
            err = max(close(f"chunk_steps {i}", a, b)
                      for i, (a, b) in enumerate(zip(got, ref)))
            same = all(torch.equal(a, b) for a, b in zip(got, ref))
            same_old = all(torch.equal(a, b) for a, b in
                           zip(got, (*fields_of(so), bo)))
            ms = device_ms(lambda: fdtd_cuda.chunk_steps(
                ops, sk, wf, 7, n_sub, D, bk, form=form),
                reps=10 if label == "canonical" else 3, warmup=2)
            row = dict(max_abs_err=err, ms=ms, bound_ms=b_ms, bound_by=b_by,
                       plan=plan, old_ms=old_ms, steps=steps, same=same)
            extra = ""
            if (label, boundary, form) == ("canonical", "MUR", None):
                spare, bspare = clone_state(sp), bp.clone()
                row["plain_ms"] = events_ms(lambda: fdtd_cuda.chunk_steps_plain(
                    ops, spare, wf, 7, n_sub, D, bspare), reps=1, warmup=1)
                del spare
                extra = f", plain {row['plain_ms'] * 1e3:,.1f} us"
            rows[(label, boundary, form)] = row
            say("3", f"{label} {sim.grid.shape} {boundary}, {n_sub} intervals "
                     f"x D={D}, {plan_text(plan)}: chunk_steps == plain "
                     f"(fields, psi and probe samples; bit-equal {same}), max "
                     f"|err| {err:.3e}, == per-step kernels (bit-equal "
                     f"{same_old}); device {ms * 1e3:,.1f} us/launch "
                     f"({ms * 1e3 / steps:.2f} us/step), per-step kernels "
                     f"{old_ms * 1e3:,.1f} us for the same chunk "
                     f"({old_ms * 1e3 / steps:.2f} us/step); bound "
                     f"{b_ms * 1e3:.2f} us by {b_by} ({b_ms / ms:.4f} of it)"
                     + (f", {a_ms * 1e3:.2f} us moving all twelve psi "
                        f"everywhere" if ops.pml is not None else "")
                     + f"{extra} [{card}]")
        del base, sk, sp, so
    return rows


def random_state(sim, seed):
    """A state of ``sim``'s shape with fields and ψ from a seeded normal
    draw (numpy), on the card; each ψ 0 outside its slab, as a run leaves
    it (``fdtd_stream.psi_slabs``)."""
    from fdtd_solver_antennas_tpu_torch.ops import fdtd_cuda

    rng = np.random.default_rng(seed)
    st = fdtd_cuda.new_state(sim.padded_shape, sim.device,
                             sim.operands.pml is not None)
    for t in (*st.e[0], *st.e[1], *st.h, *st.psi_e, *st.psi_h):
        t.copy_(torch.from_numpy(
            rng.standard_normal(t.shape).astype(np.float32)))
    psi_to_slabs(sim.operands, st)
    return st


def psi_to_slabs(ops, st):
    """Zero each ψ of ``st`` (a state or a batch) outside its slab."""
    from fdtd_solver_antennas_tpu_torch.ops import fdtd_stream

    if ops.pml is not None:
        for t, keep in zip((*st.psi_e, *st.psi_h), fdtd_stream.psi_slabs(ops)):
            t.masked_fill_(~keep, 0.0)


def clone_state(st):
    from fdtd_solver_antennas_tpu_torch.ops import fdtd_cuda

    return fdtd_cuda.YeeState(
        e=[tuple(t.clone() for t in st.e[0]), tuple(t.clone() for t in st.e[1])],
        h=tuple(t.clone() for t in st.h),
        psi_e=tuple(t.clone() for t in st.psi_e),
        psi_h=tuple(t.clone() for t in st.psi_h),
        parity=st.parity,
    )


def phase_each_kernel(sim, phase="3"):
    """Each kernel against its plain twin on the same inputs at ``sim``'s
    shapes; both timed on the device and on the host clock."""
    from fdtd_solver_antennas_tpu_torch.ops import fdtd_cuda as fc

    ops = sim.operands
    rows = ops.probes.n_rows
    base = random_state(sim, seed=7)
    calls = {
        "h_update": lambda m, st, out: m.h_update(ops, st),
        "e_update": lambda m, st, out: m.e_update(ops, st, 0.37),
        "mur_faces": lambda m, st, out: m.mur_faces(ops, st, 0),
        "probe_gather": lambda m, st, out: m.probe_gather(ops, st, out),
    }
    outputs = {
        "h_update": lambda st, out: st.h,
        "e_update": lambda st, out: st.e[1],
        "mur_faces": lambda st, out: st.e[1],
        "probe_gather": lambda st, out: (out,),
    }
    result = {}
    for name, call in calls.items():
        sk, sp = clone_state(base), clone_state(base)
        out_k, out_p = (torch.zeros(rows, device=sim.device) for _ in range(2))
        if name == "mur_faces":  # all three axes, in the run's order
            for axis in range(3):
                fc.mur_faces(ops, sk, axis)
                fc.plain.mur_faces(ops, sp, axis)
        else:
            call(fc.kernels, sk, out_k)
            call(fc.plain, sp, out_p)
        torch.cuda.synchronize()
        err = max(close(f"{name} {i}", a, b) for i, (a, b) in
                  enumerate(zip(outputs[name](sk, out_k), outputs[name](sp, out_p))))
        # the plain gather runs a few dozen PyTorch ops a call, more than
        # the sleep covers for 20 calls: events alone time it
        plain_timer = events_ms if name == "probe_gather" else device_ms
        t = dict(
            ms=device_ms(lambda: call(fc.kernels, sk, out_k)),
            plain_ms=plain_timer(lambda: call(fc.plain, sp, out_p)),
            host_ms=host_ms(lambda: call(fc.kernels, sk, out_k)),
            plain_host_ms=host_ms(lambda: call(fc.plain, sp, out_p)),
        )
        result[name] = dict(max_abs_err=err, **t)
        b_ms, b_by = k1_bound(name, sim)
        say(phase, f"{name} at {sim.grid.shape}: kernel == plain, max |err| "
                   f"{err:.3e}; device {t['ms'] * 1e3:.1f} us/launch (plain "
                   f"{t['plain_ms'] * 1e3:.1f} us, bound {b_ms * 1e3:.2f} us "
                   f"by {b_by}), host clock {t['host_ms'] * 1e3:.1f} us/call "
                   f"(plain {t['plain_host_ms'] * 1e3:.1f} us)")
    return result


def phase_main_path():
    """The canonical patch through the library entry points the CLI
    calls: one ``chunk_steps`` launch per termination chunk, in the form
    the shape picks, and no per-step launch."""
    from fdtd_solver_antennas_tpu_torch.ops import fdtd_cuda
    from fdtd_solver_antennas_tpu_torch.ops.fdtd import chunk_geometry
    from fdtd_solver_antennas_tpu_torch.solvers.patch_fixed import (
        prepare_patch_fixed, run_prepared_fixed)

    params = canonical_params()
    prep = prepare_patch_fixed(params, device="cuda")
    assert prep.ok, prep.message
    assert prep.sim.pallas_mode == "chunk", prep.sim.pallas_mode_reason
    plan = fdtd_cuda.chunk_launch_plan(
        prep.sim.operands,
        fdtd_cuda.new_state(prep.sim.padded_shape, prep.sim.device, pml=False))
    fdtd_cuda.reset_launch_counts()
    res = run_prepared_fixed(prep, frequency_hz=params.frequency_hz, verbose=0)
    counts = dict(fdtd_cuda.launches)
    forms = dict(fdtd_cuda.launches_by_form)
    assert res.ok, res.message
    _D, _n_sub, chunk, _ = chunk_geometry(prep.sim)
    chunks = -(-res.steps_run // chunk)
    assert counts["chunk_steps"] == chunks > 0, counts
    assert forms == {plan.form: chunks, **{
        f: 0 for f in forms if f != plan.form}}, (forms, plan)
    for name in ("h_update", "e_update", "mur_faces", "probe_gather"):
        assert counts[name] == 0, f"main path launched {name}: {counts}"
    s11_db = 20 * np.log10(np.maximum(np.abs(res.s11), 1e-12))
    dmax_dbi = 10 * np.log10(res.Dmax)
    for arr in (res.s11, res.z_in, res.intensity):
        assert np.all(np.isfinite(arr)), "non-finite main-path output"
    assert np.isfinite(res.Dmax) and np.isfinite(res.f_res_hz)
    assert 5.0 < dmax_dbi < 8.0, f"Dmax {dmax_dbi:.2f} dBi outside 5-8"
    assert s11_db.min() < -8.0, f"|S11|min {s11_db.min():.2f} dB not < -8"
    say("4", f"canonical patch {prep.sim.grid.shape} on {prep.sim.device}: "
             f"{res.steps_run} steps in {res.wall_time_s:.3f} s, "
             f"{res.mcells_per_s:.1f} Mcell-updates/s; f_res "
             f"{res.f_res_hz / 1e9:.4f} GHz, |S11|min {s11_db.min():.2f} dB, "
             f"Dmax {dmax_dbi:.3f} dBi; launches {counts}, chunk_steps by "
             f"form {forms} ({chunk} steps a launch), {plan_text(plan)}")
    return prep, res, counts


def phase_golden():
    """The openEMS Simple_Patch_Antenna tutorial scene through the
    kernels, held to the JAX package's golden bands."""
    from fdtd_solver_antennas_tpu_torch.models.params import PatchAntennaParams
    from fdtd_solver_antennas_tpu_torch.solvers.patch_fixed import (
        prepare_patch_fixed, run_prepared_fixed)

    tut = PatchAntennaParams.from_user_units(
        frequency_ghz=2.0, er=3.38, h_mm=1.524, loss_tangent=1e-3,
        W_mm=32.0, L_mm=40.0)
    prep = prepare_patch_fixed(tut, device="cuda")
    assert prep.ok, prep.message
    res = run_prepared_fixed(prep, frequency_hz=2.0e9, verbose=0)
    assert res.ok, res.message
    rel = abs(res.f_res_hz - 2.40e9) / 2.40e9
    dip = float((20 * np.log10(np.abs(res.s11) + 1e-30)).min())
    dmax = 10 * np.log10(res.Dmax)
    assert rel < 0.015, f"tutorial f_res {res.f_res_hz / 1e9:.4f} GHz off by {rel:.2%}"
    assert dip <= -18.0, f"tutorial S11 dip {dip:.2f} dB shallower than -18"
    assert 6.2 < dmax < 7.4, f"tutorial Dmax {dmax:.2f} dBi outside 6.2-7.4"
    say("5", f"tutorial scene {prep.sim.grid.shape}: f_res "
             f"{res.f_res_hz / 1e9:.4f} GHz ({rel:.2%} from 2.40), dip "
             f"{dip:.2f} dB, Dmax {dmax:.3f} dBi, {res.steps_run} steps")


def route_runs(sim, label, card):
    """``sim`` through ``chunk_steps`` and through the per-step kernels in
    turns (new, old, old, new), both outputs compared; the launches of
    each route counted in its first run. Returns walls, counts, steps."""
    from fdtd_solver_antennas_tpu_torch.ops import fdtd_cuda

    walls = {"chunk": [], "step": []}
    counts, outs = {}, {}
    for route in ("chunk", "step", "step", "chunk"):
        impl = fdtd_cuda.kernels if route == "chunk" else fdtd_cuda.step_kernels
        fdtd_cuda.reset_launch_counts()
        out, t = timed_run(sim, impl)
        walls[route].append(t)
        counts.setdefault(route, dict(fdtd_cuda.launches))
        outs.setdefault(route, out)
    err = compare_runs(outs["chunk"], outs["step"], f"{label} chunk vs step")
    same = all(torch.equal(a, b) for a, b in
               zip(outs["chunk"]["fields"], outs["step"]["fields"]))
    steps = outs["chunk"]["steps"]
    assert counts["chunk"]["chunk_steps"] > 0 and counts["step"]["chunk_steps"] == 0
    per_step = ("h_update", "e_update", "probe_gather") + (
        ("mur_faces",) if sim.operands.mur is not None else ())
    for name in per_step:
        assert counts["step"][name] > 0, (name, counts["step"])
    say("6", f"{label} {sim.grid.shape}, {steps} steps: chunk_steps route == "
             f"per-step route (fields bit-equal {same}), max |err| {err:.3e}; "
             f"launches: chunk_steps route {counts['chunk']['chunk_steps']}, "
             f"per-step route {counts['step']} [{card}]")
    return walls, counts, steps


def idle_text(walls, busy) -> str:
    return " / ".join(f"{1 - busy / t:.3f}" for t in walls)


def phase_times(prep, res, per_kernel, k1c, card):
    """Wall time, device time and idle share of the canonical run through
    ``chunk_steps`` and through the per-step kernels in the same call,
    with the plain twins' wall; the same for the PML_8 patch run; one
    forced-chunk chunk of the tall grid through both routes and the plain
    twins, per step."""
    from fdtd_solver_antennas_tpu_torch.ops import fdtd_cuda
    from fdtd_solver_antennas_tpu_torch.solvers.patch_fixed import prepare_patch_fixed

    sim = prep.sim
    cells = sim.grid.num_cells
    _, t_plain = timed_run(sim, fdtd_cuda.plain)
    say("6", f"canonical {sim.grid.shape}, {res.steps_run} steps: plain twins "
             f"{t_plain:.3f} s = {cells * res.steps_run / t_plain / 1e6:.1f} "
             f"Mcell-updates/s [{card}]")
    for label, run_sim, key in (
            ("canonical", sim, ("canonical", "MUR", None)),
            ("PML_8 patch", None, ("canonical", "PML_8", None))):
        if run_sim is None:
            pprep = prepare_patch_fixed(canonical_params(), device="cuda",
                                        boundary="PML_8")
            assert pprep.ok, pprep.message
            run_sim = pprep.sim
            assert run_sim.pallas_mode == "chunk", run_sim.pallas_mode_reason
        walls, rc, steps = route_runs(run_sim, label, card)
        k = k1c[key]
        launches = rc["chunk"]["chunk_steps"]
        new_busy = launches * k["ms"] / 1e3
        old_busy = launches * k["old_ms"] / 1e3  # the same chunks, per step
        rate = [cells * steps / t / 1e6 for t in walls["chunk"]]
        say("6", f"{label} run, chunk_steps: {launches} launches of "
                 f"{k['steps']} steps ({plan_text(k['plan'])}), "
                 f"{walls['chunk'][0]:.3f} / {walls['chunk'][1]:.3f} s wall "
                 f"({rate[0]:.1f} / {rate[1]:.1f} Mcell-updates/s), device "
                 f"{k['ms'] * 1e3:,.1f} us/launch ({k['ms'] * 1e3 / k['steps']:.2f} "
                 f"us/step), busy {new_busy:.3f} s, idle share "
                 f"{idle_text(walls['chunk'], new_busy)} [{card}]")
        say("6", f"{label} run, per-step kernels: {walls['step'][0]:.3f} / "
                 f"{walls['step'][1]:.3f} s wall, device {k['old_ms'] * 1e3:,.1f} "
                 f"us per {k['steps']}-step chunk ({k['old_ms'] * 1e3 / k['steps']:.2f} "
                 f"us/step), busy {old_busy:.3f} s, idle share "
                 f"{idle_text(walls['step'], old_busy)} [{card}]")
        if label == "canonical":  # the per-step kernels' own device times
            busy = sum(rc["step"][n] * per_kernel[n]["ms"]
                       for n in per_kernel) / 1e3
            say("6", f"canonical run, per-step kernels by launch: busy "
                     f"{busy:.3f} s (launches x device time per launch), idle "
                     f"share {idle_text(walls['step'], busy)} [{card}]")
            step_counts = rc["step"]
    t0 = time.perf_counter()
    tall = one_chunk_sim(tall_scene, "MUR", mode="chunk")
    prep_tall = time.perf_counter() - t0
    tcells = tall.grid.num_cells
    times = {"chunk": [], "step": []}
    for route in ("chunk", "step", "step", "chunk"):
        impl = fdtd_cuda.kernels if route == "chunk" else fdtd_cuda.step_kernels
        out, t = timed_run(tall, impl)
        times[route].append(t)
    po, tp = timed_run(tall, fdtd_cuda.plain)
    close("tall uf", out["uf"], po["uf"])
    tsteps = out["steps"]
    us = {r: " / ".join(f"{t / tsteps * 1e6:.1f}" for t in ts)
          for r, ts in times.items()}
    say("6", f"tall {tall.grid.shape} ({tcells} cells, prepare {prep_tall:.1f} s), "
             f"one forced-chunk {tsteps}-step chunk: chunk_steps "
             f"{times['chunk'][0]:.3f} / {times['chunk'][1]:.3f} s ({us['chunk']} "
             f"us/step, first run / last), per-step kernels {times['step'][0]:.3f} "
             f"/ {times['step'][1]:.3f} s ({us['step']} us/step); plain "
             f"{tp:.3f} s ({tp / tsteps * 1e6:.1f} us/step) [{card}]")
    per = phase_each_kernel(tall, phase="6")
    k = k1c[("tall", "MUR", None)]
    n_samples = tsteps // tall.probe_decim
    busy = (tsteps * (per["h_update"]["ms"] + per["e_update"]["ms"]
                      + 3 * per["mur_faces"]["ms"])
            + n_samples * per["probe_gather"]["ms"]) / 1e3
    new_busy = tsteps / k["steps"] * k["ms"] / 1e3
    say("6", f"tall last runs: chunk_steps busy {new_busy:.3f} s of "
             f"{times['chunk'][1]:.3f} s wall, idle share "
             f"{1 - new_busy / times['chunk'][1]:.2f}; per-step kernels busy "
             f"{busy:.3f} s of {times['step'][1]:.3f} s wall, idle share "
             f"{1 - busy / times['step'][1]:.2f} [{card}]")
    return step_counts


def bound(nbytes: float, flops: float):
    """(least milliseconds, "bytes" | "operations"): the bytes the call
    must move over the HBM rate against its float32 operations over the
    float32 peak, whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k1_chunk_bound(ops, n_sub, D, all_psi=False):
    """Bound of one ``chunk_steps`` launch: the fields in and out once, the
    ψ of ``psi_cells`` in and out once, ca/cb, the sources and the n_sub·D
    samples in once, the index and weight of each probe table entry the
    data uses read once (the table is the same every interval, and the
    values it gathers are the fields, already counted), each interval's
    samples written once; n_sub·D steps of H and E updates (as
    ``k2_bound`` counts them) and 2 operations per used entry per
    interval."""
    n = int(np.prod(ops.shape))
    n_src = sum(s is not None for s in ops.src)
    psi = psi_cells(ops, (0, ops.shape[0]), all_psi)
    rows = ops.probes.n_rows
    used = int(torch.count_nonzero(ops.probes.w))
    nbytes = (4 * n * (6 + 6 + n_src + 6) + 8 * psi + 4 * n_sub * D
              + 8 * used + 4 * n_sub * rows)
    return bound(nbytes, n_sub * D * (48 * n + 4 * psi) + n_sub * 2 * used)


def k1_bound(name, sim):
    """Bound of one K1 launch at ``sim``'s shapes: each input read once,
    each output written once (float32); operations counted per cell."""
    ops = sim.operands
    nx, ny, nz = ops.shape
    n = nx * ny * nz
    n_src = sum(s is not None for s in ops.src)
    psi = 12 if ops.pml is not None else 0
    if name == "h_update":  # E, H in; H out (+ psi_h in and out)
        return bound(4 * n * (9 + psi), n * (21 + 2 * psi))
    if name == "e_update":  # E, H, ca, cb, src in; E out (+ psi_e)
        return bound(4 * n * (15 + n_src + psi), n * (27 + 2 * psi))
    if name == "mur_faces":  # axis 0: 2 walls x 2 components x y-z plane
        wall_cells = 4 * ny * nz
        return bound(4 * 4 * wall_cells, 3 * wall_cells)
    # probe_gather: index, weight and value of each table entry this run's
    # data needs (the table's zero-weight padding is not work), rows out
    rows = ops.probes.n_rows
    used = int(torch.count_nonzero(ops.probes.w))
    return bound(used * 12 + rows * 4, 2 * used)


def psi_cells(ops, span, all_psi=False):
    """ψ values a stream launch on rows ``span = (r0, r1)`` of ``ops`` must
    move (in and out once) and update: each ψ over the cells outside its
    axis's flat profile run, where it stays 0 and the march skips it
    (``fdtd_stream.check_psi_flat`` holds states to that); ``all_psi``:
    all twelve at every cell. 0 without CPML."""
    from fdtd_solver_antennas_tpu_torch.ops import fdtd_stream

    if ops.pml is None:
        return 0
    r0, r1 = span
    plane = int(np.prod(ops.shape[1:]))
    n = (r1 - r0) * plane
    if all_psi:
        return 12 * n
    total = 0
    for keep, ax in zip(fdtd_stream.psi_slabs(ops), 2 * fdtd_stream.PSI_AXIS):
        k = keep.flatten()
        total += (int(k[r0:r1].sum()) * plane if ax == 0
                  else int(k.sum()) * n // ops.shape[ax])
    return total


def k2_bound(ops, T, span=None, all_psi=False):
    """Bound of one stream launch on ``ops`` (a grid's, or rows ``span``
    of it): fields, coefficients and sources in once, fields out once, the
    ψ of ``psi_cells`` in and out once; T steps of H and E updates."""
    span = span or (0, ops.shape[0])
    n = (span[1] - span[0]) * int(np.prod(ops.shape[1:]))
    n_src = sum(s is not None for s in ops.src)
    psi = psi_cells(ops, span, all_psi)
    nbytes = 4 * n * (6 + 6 + n_src + 6) + 8 * psi
    return bound(nbytes, T * (48 * n + 4 * psi))


def k2_slab_bound(sh, T, all_psi=False):
    """Bound of one launch of K2's slab stepper: ``k2_bound`` over the rows
    the function must carry, the owned rows and each halo a neighbour
    fills. A halo with no neighbour lies outside the domain (its
    coefficients zero, its fields zero): at one rank the work is the
    whole grid's, and so is the bound."""
    span = (sh.W * (sh.rank == 0), sh.W + sh.n + sh.W * (sh.rank < sh.n_dev - 1))
    return k2_bound(sh.ops, T, span, all_psi)


def fields_of(st):
    return (*st.e[st.parity], *st.h, *st.psi_e, *st.psi_h)


def phase_stream_vs_plain(card):
    """K2 against its plain twin: one launch on a random state, then one
    480-step chunk in stream mode (a probe sample every 48 steps, a
    multiple of every T), kernel against plain and against chunk mode
    (K1's kernels)."""
    from fdtd_solver_antennas_tpu_torch.ops import fdtd_cuda, fdtd_stream

    worst = 0.0
    route = "stream_march"  # under MUR, PEC and CPML
    for label, make, boundaries in (
        ("small", small_scene, ("MUR", "PEC", "PML_4")),
        ("z131", tall131_scene, ("MUR",)),
    ):
        for boundary in boundaries:
            for T in (1, 2, 3, 4):
                sim = one_chunk_sim(make, boundary, 480, "stream", T, decim=48)
                assert sim.pallas_mode == "stream" and sim.stream_T == T
                base = random_state(sim, seed=11)
                sk, sp = clone_state(base), clone_state(base)
                wf = [0.37, -0.21, 0.55, 0.13][:T]
                fdtd_stream.reset_launch_counts()
                fdtd_stream.stream_steps(sim.operands, sk, wf)
                assert fdtd_stream.launches_by_kernel[route] == 1, route
                fdtd_stream.stream_steps_plain(sim.operands, sp, wf)
                torch.cuda.synchronize()
                e1 = max(close(f"stream_steps {i}", a, b) for i, (a, b) in
                         enumerate(zip(fields_of(sk), fields_of(sp))))
                fdtd_stream.reset_launch_counts()
                ko, tk = timed_run(sim, fdtd_stream.kernels)
                counts = dict(fdtd_stream.launches_by_kernel)
                assert counts[route] == 480 // T == sum(counts.values()), counts
                po, tp = timed_run(sim, fdtd_stream.plain)
                e2 = compare_runs(ko, po, f"{label} {boundary} T={T}")
                csim = one_chunk_sim(make, boundary, 480, "chunk", decim=48)
                co, tc = timed_run(csim, fdtd_cuda.kernels)
                e3 = compare_runs(ko, co, f"{label} {boundary} T={T} vs chunk")
                worst = max(worst, e1, e2, e3)
                say("7", f"{label} {sim.grid.shape} {boundary} T={T}, {route}: "
                         f"stream_steps == plain, max |err| {e1:.3e}; "
                         f"{ko['steps']}-step chunk stream kernel == plain "
                         f"{e2:.3e}, == chunk kernels {e3:.3e}; stream "
                         f"{tk:.3f} s, plain {tp:.3f} s, chunk {tc:.3f} s "
                         f"[{card}]")
    return worst


def phase_mixed_main_path(card):
    """The large-grid slice through ``MultiPatchScene.simulate``; it must
    resolve to the stream kernel and end on the energy criterion. Then
    ~2,000 steps of the same simulation, kernels against plain twins."""
    from fdtd_solver_antennas_tpu_torch.ops import fdtd_cuda, fdtd_stream

    scene = mixed_designer()
    seen = {}
    real_prepare = scene.prepare

    def prepare(**kw):  # keep the prepared simulation and its seconds
        t0 = time.perf_counter()
        seen["prep"] = real_prepare(**kw)
        seen["seconds"] = time.perf_counter() - t0
        return seen["prep"]

    scene.prepare = prepare
    logs = []
    with voxelize_recorded() as vox:
        fdtd_cuda.reset_launch_counts()
        fdtd_stream.reset_launch_counts()
        res = scene.simulate(log_cb=logs.append)
        counts = {**fdtd_cuda.launches, **fdtd_stream.launches,
                  **fdtd_stream.launches_by_kernel}
    prep = seen["prep"]
    assert prep.ok, prep.message
    assert res.ok, res.message
    sim = prep.sim
    T, decim, steps = sim.stream_T, sim.probe_decim, res.steps_run
    say("8", f"mixed scene prepared in {seen['seconds']:.1f} s on the host: "
             f"grid {sim.grid.shape} ({sim.grid.num_cells} cells); "
             f"{logs[-1]}")
    voxelize_twin_check(vox, "8", seen["seconds"])
    assert sim.pallas_mode == "stream" and T >= 2, sim.pallas_mode_reason
    assert steps % T == 0 and counts["stream_steps"] == steps // T, counts
    assert counts["stream_march"] == steps // T, counts
    assert counts["probe_gather"] == steps // decim, counts
    for name in ("h_update", "e_update", "mur_faces", "chunk_steps"):
        assert counts[name] == 0, counts
    assert np.isfinite(res.Dmax) and res.Dmax > 0
    s11s = res.diagnostics["s11_all_ports"]
    assert len(s11s) == 2 and all(np.all(np.isfinite(s)) for s in s11s)
    assert np.all(np.isfinite(res.intensity))
    e_ratio = res.diagnostics["energy_ratio"]
    assert steps < sim.cfg.n_steps_max and e_ratio < sim.cfg.end_criteria, (
        steps, sim.cfg.n_steps_max, e_ratio)
    s11_db = [float(20 * np.log10(np.abs(s).min())) for s in s11s]
    say("8", f"mixed scene on {sim.device}: stream T={T}, decim {decim}; "
             f"{steps} steps (JAX package: {JAX_MIXED_STEPS}) in "
             f"{res.wall_time_s:.3f} s, {res.mcells_per_s:.1f} "
             f"Mcell-updates/s; ended on energy ratio {e_ratio:.3e} < "
             f"{sim.cfg.end_criteria:.3e} before {sim.cfg.n_steps_max}; "
             f"Dmax {10 * np.log10(res.Dmax):.3f} dBi, |S11|min per port "
             f"{s11_db[0]:.2f} / {s11_db[1]:.2f} dB; launches {counts} [{card}]")
    k2 = stream_kernel_alone(sim, "8", card)
    k2["probe"] = probe_gather_alone(sim, "8", card)
    busy = (counts["stream_steps"] * k2["ms"]
            + counts["probe_gather"] * k2["probe"]["ms"]) / 1e3
    wall = res.wall_time_s
    say("8", f"mixed main-path run: {wall:.3f} s wall, kernels busy {busy:.3f} s "
             f"(launches x device time per launch: march {k2['ms'] * 1e3:.1f} us, "
             f"probe_gather {k2['probe']['ms'] * 1e3:.2f} us), idle share "
             f"{1 - busy / wall:.3f} [{card}]")

    # the same prepared scene run again, warm: the first run of a process
    # pays one-time set-up beside the kernels
    from fdtd_solver_antennas_tpu_torch.solvers.multi_patch_3d import (
        run_prepared_multi_patch_3d)

    f_run = max(i.params.frequency_hz for i in scene.patches + scene.horns)
    warm = []
    for _ in range(2):
        again = run_prepared_multi_patch_3d(prep, frequency_hz=f_run, verbose=0)
        assert again.ok and again.steps_run == steps, again.message
        assert np.isclose(again.Dmax, res.Dmax, rtol=1e-6), (again.Dmax, res.Dmax)
        warm.append(again.wall_time_s)
    say("8", f"mixed scene run again, warm (run_prepared_multi_patch_3d on the "
             f"same preparation): {' / '.join(f'{w:.3f}' for w in warm)} s for "
             f"{steps} steps, same Dmax [{card}]")

    cut = dataclasses.replace(
        sim, cfg=dataclasses.replace(sim.cfg, n_steps_max=2000))
    ko, tk = timed_run(cut, fdtd_stream.kernels)
    po, tp = timed_run(cut, fdtd_stream.plain)
    err = compare_runs(ko, po, "mixed 2000 steps")
    say("8", f"mixed scene, {ko['steps']} steps: stream kernel == plain "
             f"(uf, if_, nf_e, nf_h, fields), max |err| {err:.3e}; kernel "
             f"{tk:.3f} s, plain {tp:.3f} s [{card}]")
    k2["prep"], k2["f_run"] = prep, f_run
    return sim, res, counts, k2


class voxelize_recorded:
    """Within the block, ``build_simulation``'s voxelize calls (the native
    core) are timed on the host and their inputs and output kept."""

    def __enter__(self):
        from fdtd_solver_antennas_tpu_torch.ops import fdtd as engine

        self.engine, self.real, self.calls = engine, engine.voxelize, []

        def timed(scene, grid, *a, **kw):
            t0 = time.perf_counter()
            out = self.real(scene, grid, *a, **kw)
            self.calls.append((scene, grid, out, time.perf_counter() - t0))
            return out

        engine.voxelize = timed
        return self

    def __exit__(self, *exc):
        self.engine.voxelize = self.real
        return False


def voxelize_twin_check(vox, phase, prepare_s):
    """The recorded voxelization against the NumPy twin on the same scene
    and grid, bit for bit; both timed on the host."""
    from fdtd_solver_antennas_tpu_torch.ops.voxelize import voxelize

    assert vox.calls, "the prepare voxelized nothing"
    scene, grid, native, native_s = vox.calls[-1]
    t0 = time.perf_counter()
    twin = voxelize(scene, grid, native=False)
    twin_s = time.perf_counter() - t0
    for name in ("eps_r", "sigma", "pec_ex", "pec_ey", "pec_ez"):
        assert np.array_equal(getattr(native, name), getattr(twin, name)), name
    say(phase, f"voxelize on the card host: native core {native_s:.3f} s of "
               f"the {prepare_s:.1f} s prepare, NumPy twin {twin_s:.3f} s on "
               f"the same scene and grid {grid.shape}; eps_r, sigma, pec_ex, "
               f"pec_ey, pec_ez bit-equal")
    return native_s, twin_s


def k1_launch_alone(sim, phase, card, label):
    """One ``chunk_steps`` launch at ``sim``'s operands and own chunk
    (n_sub intervals of its D) on a seeded random state, against the plain
    twin: fields, ψ and every probe sample (port V/I rows, MSL rows
    included, and the faces' E/H), timed on the device beside its bound."""
    from fdtd_solver_antennas_tpu_torch.ops import fdtd_cuda
    from fdtd_solver_antennas_tpu_torch.ops.fdtd import chunk_geometry

    ops = sim.operands
    D, n_sub, _chunk, _ = chunk_geometry(sim)
    base = random_state(sim, seed=97)
    wf = torch.from_numpy(np.random.default_rng(101).uniform(
        -1.0, 1.0, 7 + n_sub * D).astype(np.float32)).to(sim.device)
    bufs = torch.zeros((n_sub, ops.probes.n_rows), device=sim.device)
    sk, bk = clone_state(base), bufs.clone()
    sp, bp = clone_state(base), bufs.clone()
    del base
    plan = fdtd_cuda.chunk_launch_plan(ops, sk)
    fdtd_cuda.chunk_steps(ops, sk, wf, 7, n_sub, D, bk)
    fdtd_cuda.chunk_steps_plain(ops, sp, wf, 7, n_sub, D, bp)
    torch.cuda.synchronize()
    got, ref = (*fields_of(sk), bk), (*fields_of(sp), bp)
    err = max(close(f"{label} chunk_steps {i}", a, b)
              for i, (a, b) in enumerate(zip(got, ref)))
    same = all(torch.equal(a, b) for a, b in zip(got, ref))
    ms = device_ms(lambda: fdtd_cuda.chunk_steps(ops, sk, wf, 7, n_sub, D, bk),
                   reps=10, warmup=2)
    plain_ms = events_ms(lambda: fdtd_cuda.chunk_steps_plain(
        ops, sp, wf, 7, n_sub, D, bp), reps=1, warmup=1)
    b_ms, b_by = k1_chunk_bound(ops, n_sub, D)
    all_psi = ""
    if ops.pml is not None:
        a_ms, a_by = k1_chunk_bound(ops, n_sub, D, all_psi=True)
        all_psi = (f" (moving all twelve psi everywhere: {a_ms * 1e3:.2f} us "
                   f"by {a_by}, {a_ms / ms:.4f})")
    rows = ops.probes.rows
    say(phase, f"{label} {sim.grid.shape}: one chunk_steps launch of {n_sub} x "
               f"D={D} steps, {plan_text(plan)}, probe rows (V, I, face E, face "
               f"H) {rows} x terms {ops.probes.k}: == plain (fields, psi, "
               f"probe samples; bit-equal {same}), max |err| {err:.3e}; device "
               f"{ms * 1e3:,.1f} us/launch ({ms * 1e3 / (n_sub * D):.2f} "
               f"us/step), bound {b_ms * 1e3:.2f} us by {b_by} ({b_ms / ms:.4f} "
               f"of it){all_psi}, plain {plain_ms * 1e3:,.1f} us [{card}]")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by)


def counted(fn):
    """``fn()`` with every launch count set to 0 just before it; returns
    (result, the counts read just after)."""
    from fdtd_solver_antennas_tpu_torch.ops import fdtd_cuda, fdtd_stream

    fdtd_cuda.reset_launch_counts()
    fdtd_stream.reset_launch_counts()
    out = fn()
    return out, {**fdtd_cuda.launches, **fdtd_stream.launches,
                 **fdtd_stream.launches_by_kernel}


def assert_only(counts, allowed, what):
    """Every kernel outside ``allowed`` launched no time, every one in it
    at least once."""
    for name, n in counts.items():
        assert (n > 0) == (name in allowed), (what, name, counts)


def run_text(res, counts, busy, card) -> str:
    s11_db = 20 * np.log10(np.maximum(np.abs(res.s11), 1e-12))
    return (f"{res.steps_run} steps in {res.wall_time_s:.3f} s, "
            f"{res.mcells_per_s:.1f} Mcell-updates/s, energy ratio "
            f"{res.diagnostics['energy_ratio']:.3e}; f_res "
            f"{res.f_res_hz / 1e9:.4f} GHz, |S11|min {s11_db.min():.2f} dB, "
            f"Dmax {10 * np.log10(res.Dmax):.3f} dBi; launches "
            f"{ {k: v for k, v in counts.items() if v} }; kernels busy "
            f"{busy:.3f} s, idle share {1 - busy / res.wall_time_s:.3f} [{card}]")


def band_dip(freq, s11):
    """(f, dB) of the deepest S11 in 1.6-2.3 GHz (tests/test_msl_port.py)."""
    db = 20 * np.log10(np.abs(s11) + 1e-12)
    win = (freq > 1.6e9) & (freq < 2.3e9)
    i = int(np.argmin(np.where(win, db, 0.0)))
    return float(freq[i]), float(db[i])


MSL_TEST_STEPS = 5000  # tests/test_msl_port.py's N_STEPS (truncated ring-down)


def phase_microstrip_main_path(card):
    """The microstrip slice at full width: the canonical FR-4 patch fed by
    its microstrip at the solver's own mesh, with an MSL port and with a
    lumped port, both under PML_8, through ``prepare_microstrip_patch`` and
    ``run_prepared_microstrip`` to the solver's stop (the energy criterion,
    or its 30,000-step cap: the MSL feed's open end keeps the energy up);
    then the CLI's own ``s11`` (``--solver microstrip`` by default, MUR,
    its default ``--steps-max``) through ``__main__.main``. Each run
    resolves to chunk mode and launches ``chunk_steps`` alone; one launch
    at each scene's operands is held to the plain twin. Physics: the
    contract of tests/test_msl_port.py on the runs that test makes (its
    5,000-step ring-down), the full runs' dip and line impedance beside."""
    import contextlib
    import io

    from fdtd_solver_antennas_tpu_torch import __main__ as cli
    from fdtd_solver_antennas_tpu_torch.ops.fdtd import chunk_geometry
    from fdtd_solver_antennas_tpu_torch.post.ports import MSLPortSpectra
    from fdtd_solver_antennas_tpu_torch.solvers.microstrip import (
        prepare_microstrip_patch, run_prepared_microstrip)

    params = canonical_params()
    f0 = params.frequency_hz
    runs, rows = {}, {}
    for mode in ("msl", "lumped"):
        t0 = time.perf_counter()
        prep = prepare_microstrip_patch(params, device="cuda", port_mode=mode,
                                        boundary="PML_8")
        prep_s = time.perf_counter() - t0
        assert prep.ok, prep.message
        sim = prep.sim
        assert sim.pallas_mode == "chunk", sim.pallas_mode_reason
        assert sim.operands.pml is not None and len(sim.msl_ports) == (
            mode == "msl")
        res, counts = counted(lambda: run_prepared_microstrip(
            prep, frequency_hz=f0, verbose=0))
        assert res.ok, res.message
        steps = res.steps_run
        energy_stop = res.diagnostics["energy_ratio"] < sim.cfg.end_criteria
        assert energy_stop or steps >= sim.cfg.n_steps_max, steps
        assert counts["chunk_steps"] == steps // chunk_geometry(sim)[2], counts
        assert_only(counts, {"chunk_steps"}, f"microstrip {mode}")
        row = k1_launch_alone(sim, "20", card, f"microstrip {mode}")
        busy = counts["chunk_steps"] * row["ms"] / 1e3
        stop = ("energy stop" if energy_stop else
                f"the {sim.cfg.n_steps_max}-step cap")
        say("20", f"microstrip {mode} port, PML_8, grid {sim.grid.shape} "
                  f"({sim.grid.num_cells} cells), prepared in {prep_s:.2f} s "
                  f"on the host; {sim.pallas_mode_reason}; ended at {stop}; "
                  f"{run_text(res, counts, busy, card)}")
        runs[mode], rows[mode] = res, dict(row, launches=counts["chunk_steps"])

    def msl_vs_lumped(runs):
        for res in runs.values():
            assert np.isfinite(np.abs(res.s11)).all()
        f_l, _ = band_dip(runs["lumped"].freq, runs["lumped"].s11)
        f_m, db_m = band_dip(runs["msl"].freq, runs["msl"].s11)
        sp = runs["msl"].diagnostics["port_spectra"]
        assert isinstance(sp, MSLPortSpectra)
        sel = (sp.freq_hz > 2.0e9) & (sp.freq_hz < 2.9e9)
        z_mean = float(np.mean(np.real(sp.z_line[sel])))
        beta_ok = bool(np.all(np.real(sp.beta[sel]) > 0))
        return f_l, f_m, db_m, z_mean, beta_ok

    short = {}
    for mode in ("msl", "lumped"):
        prep = prepare_microstrip_patch(params, device="cuda", port_mode=mode,
                                        boundary="PML_8",
                                        n_steps_max=MSL_TEST_STEPS)
        assert prep.ok, prep.message
        res, counts = counted(lambda: run_prepared_microstrip(
            prep, frequency_hz=f0, verbose=0))
        assert res.ok, res.message
        assert_only(counts, {"chunk_steps"}, f"microstrip {mode} short")
        short[mode] = res
    f_l, f_m, db_m, z_mean, beta_ok = msl_vs_lumped(short)
    assert abs(f_m - f_l) <= 0.02 * f_l, (f_m, f_l)
    assert db_m < -10.0, db_m
    assert abs(z_mean - 50.0) <= 5.0, z_mean
    assert beta_ok
    say("20", f"MSL vs lumped, tests/test_msl_port.py's runs (PML_8, "
              f"{MSL_TEST_STEPS} steps asked, {short['msl'].steps_run} / "
              f"{short['lumped'].steps_run} run): dip in 1.6-2.3 GHz "
              f"{f_m / 1e9:.4f} vs {f_l / 1e9:.4f} GHz ({abs(f_m - f_l) / f_l:.2%} "
              f"apart, within 2%), MSL dip {db_m:.2f} dB (< -10); deembedded "
              f"Re Z_L mean over 2.0-2.9 GHz {z_mean:.2f} ohm (within 10% of "
              f"50), Re beta > 0 there")
    f_l, f_m, db_m, z_mean, beta_ok = msl_vs_lumped(runs)
    say("20", f"MSL vs lumped, the full runs above ({runs['msl'].steps_run} / "
              f"{runs['lumped'].steps_run} steps): dip in 1.6-2.3 GHz "
              f"{f_m / 1e9:.4f} vs {f_l / 1e9:.4f} GHz "
              f"({abs(f_m - f_l) / f_l:.2%} apart), MSL dip {db_m:.2f} dB; "
              f"Re Z_L mean over 2.0-2.9 GHz {z_mean:.2f} ohm; Re beta > 0 "
              f"there: {beta_ok}")

    outdir = "outputs/smoke_s11"
    argv = ["s11", "--frequency-ghz", "2.45", "--er", "4.3", "--h-mm", "1.6",
            "--loss-tangent", "0.02", "--outdir", outdir]
    text = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(text):
        _none, counts = counted(lambda: cli.main(argv))
    cli_s = time.perf_counter() - t0
    text = text.getvalue()
    summary = json.loads(text[text.index("{"):text.rindex("}") + 1])
    path = next(ln for ln in text.splitlines() if ln.startswith("engine path:"))
    assert path.startswith("engine path: chunk kernels"), path
    assert summary["device"].startswith("cuda"), summary
    assert_only(counts, {"chunk_steps"}, "cli s11")
    with np.load(f"{outdir}/s11.npz") as z:
        assert set(z.files) == {"freq_hz", "s11", "z_in"}
        assert np.isfinite(z["s11"]).all()
    with open(f"{outdir}/s11.s1p") as fh:
        assert "microstrip patch" in fh.read()
    cli_prep = prepare_microstrip_patch(params, device="cuda")
    row = k1_launch_alone(cli_prep.sim, "20", card, "CLI s11 (lumped, MUR)")
    busy = counts["chunk_steps"] * row["ms"] / 1e3
    wall = summary["wall_time_s"]
    say("20", f"CLI {' '.join(argv)}: {path}; {summary['steps']} steps in "
              f"{wall:.3f} s, {summary['mcells_per_s']:.1f} Mcell-updates/s; "
              f"f_res {summary['f_res_ghz']:.4f} GHz, |S11|min "
              f"{summary['s11_min_db']:.2f} dB, Dmax {summary['Dmax_dbi']:.3f} "
              f"dBi; launches { {k: v for k, v in counts.items() if v} }; "
              f"kernels busy {busy:.3f} s, idle share {1 - busy / wall:.3f}; "
              f"the whole command {cli_s:.1f} s; wrote s11.npz and s11.s1p "
              f"[{card}]")
    return rows["msl"]


def check_result(res, full_sphere=False):
    """The bounds of tests/test_solvers.py::_check_result."""
    assert res.ok, res.message
    assert res.is_dBi and res.intensity is not None
    assert res.intensity.shape == (len(res.theta), len(res.phi))
    assert np.isfinite(res.intensity).all()
    assert res.s11 is not None and np.isfinite(res.s11).all()
    assert np.all(np.abs(res.s11) < 3.0)
    assert res.f_res_hz is not None
    assert isinstance(res.diagnostics["rad_eff_converged"], bool)
    if full_sphere:
        assert len(res.phi) > 10


def phase_solvers_main_path(card):
    """The other solvers of the slice on the card: microstrip_3d at mesh
    quality 5 under PML_8 (stream mode: the CPML march and
    ``probe_gather`` alone; one march launch on its state held to the
    twin), the legacy solver and the quasi-2D slice (chunk mode under
    CPML: ``chunk_steps`` alone; one launch held to the twin), each to its
    energy stop and held to tests/test_solvers.py's bounds."""
    from fdtd_solver_antennas_tpu_torch.solvers.microstrip_3d import (
        prepare_microstrip_patch_3d, run_prepared_microstrip_3d)
    from fdtd_solver_antennas_tpu_torch.solvers.patch_2d import (
        prepare_patch_2d, run_prepared_2d)
    from fdtd_solver_antennas_tpu_torch.solvers.patch_legacy import (
        prepare_patch_legacy, run_prepared_legacy)

    params = canonical_params()
    f0 = params.frequency_hz
    cases = (
        ("microstrip_3d q5 PML_8", lambda: prepare_microstrip_patch_3d(
            params, device="cuda", mesh_quality=5, boundary="PML_8"),
         run_prepared_microstrip_3d, True),
        ("legacy PML_8", lambda: prepare_patch_legacy(params, device="cuda"),
         run_prepared_legacy, True),
        ("quasi-2D PML_8", lambda: prepare_patch_2d(params, device="cuda"),
         run_prepared_2d, False),
    )
    out = {}
    for label, prepare, run, sphere in cases:
        t0 = time.perf_counter()
        prep = prepare()
        prep_s = time.perf_counter() - t0
        assert prep.ok, prep.message
        sim = prep.sim
        assert sim.operands.pml is not None
        res, counts = counted(lambda: run(prep, frequency_hz=f0, verbose=0))
        check_result(res, sphere)
        steps = res.steps_run
        assert res.diagnostics["energy_ratio"] < sim.cfg.end_criteria
        assert steps < sim.cfg.n_steps_max, steps
        if label.startswith("microstrip_3d"):
            T = sim.stream_T
            assert sim.pallas_mode == "stream", sim.pallas_mode_reason
            assert res.intensity.shape == (91, 73)
            assert counts["stream_march"] == steps // T, counts
            assert counts["probe_gather"] == steps // sim.probe_decim, counts
            assert_only(counts, {"stream_steps", "stream_march",
                                 "probe_gather"}, label)
            row = stream_kernel_alone(sim, "21", card)
            busy = (counts["stream_march"] * row["ms"]
                    + counts["probe_gather"] * row["probe_ms"]) / 1e3
            row = dict(row, launches=counts["stream_march"])
        else:
            assert sim.pallas_mode == "chunk", sim.pallas_mode_reason
            assert_only(counts, {"chunk_steps"}, label)
            row = k1_launch_alone(sim, "21", card, label)
            busy = counts["chunk_steps"] * row["ms"] / 1e3
            row = dict(row, launches=counts["chunk_steps"])
        say("21", f"{label}, grid {sim.grid.shape} ({sim.grid.num_cells} "
                  f"cells), prepared in {prep_s:.2f} s on the host; "
                  f"{sim.pallas_mode_reason}; pattern {res.intensity.shape}; "
                  f"{run_text(res, counts, busy, card)}")
        out[label] = dict(row, res=res)  # phase 25 runs these again
    return out


def phase_mixed_pml_main_path(card):
    """The CPML slice: the mixed scene with ``controls.boundary = "PML_8"``
    through ``MultiPatchScene.simulate``; it must resolve to stream mode at
    T = 4, step only through the march (``stream_march``: steps ÷ T
    launches, no other stepping kernel), sample through ``probe_gather``
    and end on the energy criterion with finite Dmax, intensity and both
    ports' S11; two warm reruns of the same preparation. Then the march
    alone on the same grid against its twin, its device time beside its
    bound (``k2_bound``: each ψ moved only outside its flat run) and the
    bound moving all twelve ψ everywhere, the march with its ψ skip off,
    and 2,000 steps of the same simulation, kernels against the plain
    twins (ψ included)."""
    from fdtd_solver_antennas_tpu_torch.ops import fdtd_cuda, fdtd_stream

    scene = mixed_designer()
    scene.controls.boundary = "PML_8"
    seen = {}
    real_prepare = scene.prepare

    def prepare(**kw):  # keep the prepared simulation and its seconds
        t0 = time.perf_counter()
        seen["prep"] = real_prepare(**kw)
        seen["seconds"] = time.perf_counter() - t0
        return seen["prep"]

    scene.prepare = prepare
    logs = []
    fdtd_cuda.reset_launch_counts()
    fdtd_stream.reset_launch_counts()
    res = scene.simulate(log_cb=logs.append)
    counts = {**fdtd_cuda.launches, **fdtd_stream.launches,
              **fdtd_stream.launches_by_kernel}
    prep = seen["prep"]
    assert prep.ok, prep.message
    assert res.ok, res.message
    sim = prep.sim
    T, decim, steps = sim.stream_T, sim.probe_decim, res.steps_run
    assert sim.operands.pml is not None and sim.operands.mur is None
    assert sim.pallas_mode == "stream" and T == 4, sim.pallas_mode_reason
    assert steps % T == 0 and counts["stream_steps"] == steps // T, counts
    assert counts["stream_march"] == steps // T, counts
    assert counts["probe_gather"] == steps // decim > 0, counts
    for name in ("shard_march", "stream_march_batch", "stream_shard_steps",
                 "stream_steps_batch", "h_update", "e_update", "mur_faces",
                 "chunk_steps", "chunk_steps_batch", "probe_gather_batch"):
        assert counts[name] == 0, (name, counts)
    assert np.isfinite(res.Dmax) and res.Dmax > 0
    s11s = res.diagnostics["s11_all_ports"]
    assert len(s11s) == 2 and all(np.all(np.isfinite(s)) for s in s11s)
    assert np.all(np.isfinite(res.intensity))
    e_ratio = res.diagnostics["energy_ratio"]
    assert steps < sim.cfg.n_steps_max and e_ratio < sim.cfg.end_criteria, (
        steps, sim.cfg.n_steps_max, e_ratio)
    s11_db = [float(20 * np.log10(np.abs(s).min())) for s in s11s]
    say("19", f"mixed scene under PML_8 prepared in {seen['seconds']:.1f} s on "
              f"the host: grid {sim.grid.shape} ({sim.grid.num_cells} cells); "
              f"{sim.pallas_mode_reason}")
    say("19", f"mixed scene PML_8 on {sim.device}: stream T={T}, decim {decim}; "
              f"{steps} steps in {res.wall_time_s:.3f} s, "
              f"{res.mcells_per_s:.1f} Mcell-updates/s; ended on energy ratio "
              f"{e_ratio:.3e} < {sim.cfg.end_criteria:.3e} before "
              f"{sim.cfg.n_steps_max}; Dmax {10 * np.log10(res.Dmax):.3f} dBi, "
              f"|S11|min per port {s11_db[0]:.2f} / {s11_db[1]:.2f} dB; "
              f"launches {counts} [{card}]")
    # the same preparation run again, warm, as phase 8 does: the first run
    # of a process pays one-time set-up (a library not yet built is built
    # inside its wall)
    from fdtd_solver_antennas_tpu_torch.solvers.multi_patch_3d import (
        run_prepared_multi_patch_3d)

    f_run = max(i.params.frequency_hz for i in scene.patches + scene.horns)
    warm = []
    for _ in range(2):
        again = run_prepared_multi_patch_3d(prep, frequency_hz=f_run, verbose=0)
        assert again.ok and again.steps_run == steps, again.message
        assert np.isclose(again.Dmax, res.Dmax, rtol=1e-6), (again.Dmax, res.Dmax)
        warm.append(again.wall_time_s)
    say("19", f"mixed scene PML_8 run again, warm (run_prepared_multi_patch_3d "
              f"on the same preparation): {' / '.join(f'{w:.3f}' for w in warm)} "
              f"s for {steps} steps, same Dmax [{card}]")
    k = stream_kernel_alone(sim, "19", card)
    march_skip_off(sim, card)
    # the CPML march's time per step against T on the same grid, with the
    # blocks an SM holds (its ψ slots grow with T)
    base = random_state(sim, seed=17)
    per_T = []
    for t in range(1, T + 1):
        wf = [0.37, -0.21, 0.55, 0.13][:t]
        ms = device_ms(lambda: fdtd_stream.stream_steps(sim.operands, base, wf))
        smem = fdtd_stream.march_plan(sim.operands.shape, sim.operands.grid_shape,
                                      t, False, pml=True)[4]
        per_T.append(f"T={t} {ms * 1e3:.1f} us ({ms * 1e3 / t:.1f} us/step, "
                     f"{smem} B, {fdtd_stream.blocks_per_sm(base, t)} block(s) "
                     f"an SM)")
    del base
    say("19", f"mixed PML_8 {sim.grid.shape}, CPML march by T: "
              f"{', '.join(per_T)} [{card}]")
    busy = (counts["stream_steps"] * k["ms"]
            + counts["probe_gather"] * k["probe_ms"]) / 1e3
    wall = res.wall_time_s
    say("19", f"mixed PML_8 main-path run: {wall:.3f} s wall, kernels busy "
              f"{busy:.3f} s (launches x device time per launch: march "
              f"{k['ms'] * 1e3:.1f} us, probe_gather {k['probe_ms'] * 1e3:.2f} "
              f"us), idle share {1 - busy / wall:.3f} [{card}]")
    cut = dataclasses.replace(
        sim, cfg=dataclasses.replace(sim.cfg, n_steps_max=2000))
    ko, tk = timed_run(cut, fdtd_stream.kernels)
    po, tp = timed_run(cut, fdtd_stream.plain)
    err = compare_runs(ko, po, "mixed PML_8 2000 steps")
    say("19", f"mixed scene PML_8, {ko['steps']} steps: stream kernel == plain "
              f"(uf, if_, nf_e, nf_h, fields, psi), max |err| {err:.3e}; "
              f"kernel {tk:.3f} s, plain {tp:.3f} s [{card}]")
    return dict(k, launches=counts["stream_march"])


def march_skip_off(sim, card):
    """The CPML march with its ψ skip off (every flat run empty, so each ψ
    is loaded, updated and stored at every cell) beside the march as it
    runs, on one random state: both held to the twin bit for bit, timed
    on, off, off, on."""
    from fdtd_solver_antennas_tpu_torch.ops import fdtd_stream

    ops, T = sim.operands, sim.stream_T
    wf = [0.37, -0.21, 0.55, 0.13, 0.4, -0.3, 0.2, 0.1][:T]
    base = random_state(sim, seed=19)
    on, off, ref = clone_state(base), clone_state(base), clone_state(base)
    del base
    fdtd_stream.stream_steps(ops, on, wf)  # packs the flat runs
    real = fdtd_stream.flat_runs
    fdtd_stream.flat_runs = lambda pml: (((0, 0),) * 3,) * 2
    try:
        fdtd_stream.stream_steps(ops, off, wf)  # packs empty runs
    finally:
        fdtd_stream.flat_runs = real
    fdtd_stream.stream_steps_plain(ops, ref, wf)
    torch.cuda.synchronize()
    for name, st in (("skip on", on), ("skip off", off)):
        assert all(torch.equal(a, b) for a, b in
                   zip(fields_of(st), fields_of(ref))), name
    del ref
    us = [device_ms(lambda: fdtd_stream.stream_steps(ops, st, wf)) * 1e3
          for st in (on, off, off, on)]
    say("19", f"mixed PML_8 {sim.grid.shape}, the CPML march with its psi "
              f"skip on / off / off / on: {' / '.join(f'{u:.1f}' for u in us)} "
              f"us a launch (both bit-equal to the twin); off / on "
              f"{(us[1] + us[2]) / (us[0] + us[3]):.3f} [{card}]")
    return us


def probe_csr(ops):
    """The probe table's used entries (weight != 0) as one CSR matrix of
    (probe rows, 6·cells) over the stack [Ex Ey Ez Hx Hy Hz], columns
    sorted in each row: the gather as a sparse-matrix–vector product."""
    t = ops.probes
    n = int(np.prod(ops.shape))
    dev = t.code.device
    rows, cols, vals = [], [], []
    for r0, nr, k, code, w in t.blocks():
        rows.append((torch.arange(nr, device=dev) + r0).repeat_interleave(k))
        cols.append(t.flat_index(code, n).T.reshape(-1))
        vals.append(w.T.reshape(-1))
    r, c, v = torch.cat(rows), torch.cat(cols), torch.cat(vals)
    keep = v != 0
    r, c, v = r[keep], c[keep], v[keep]
    order = torch.argsort(r * (6 * n) + c)
    r, c, v = r[order], c[order], v[order]
    crow = torch.zeros(t.n_rows + 1, dtype=torch.int64, device=dev)
    crow[1:] = torch.bincount(r, minlength=t.n_rows).cumsum(0)
    return torch.sparse_csr_tensor(crow, c, v, size=(t.n_rows, 6 * n),
                                   check_invariants=True)


def probe_gather_alone(sim, phase, card):
    """``probe_gather`` at ``sim``'s table against its twin, bit for bit,
    on a random state; its device time beside its bound, the plain twin's
    and one cuSPARSE SpMV's over the same entries (``torch.sparse_csr_tensor
    @ flat``, the stacking of the fields not timed), which must agree
    within the tolerance; the table's bytes on the card."""
    from fdtd_solver_antennas_tpu_torch.ops import fdtd_cuda

    ops = sim.operands
    t = ops.probes
    assert t.nbytes <= 20e6, f"probe table {t.nbytes} B above 20 MB"
    padded = 8 * t.n_rows * max(t.k)
    st = random_state(sim, seed=19)
    st.parity = 1
    out_k = torch.full((t.n_rows,), float("nan"), device=sim.device)
    out_p = out_k.clone()
    fdtd_cuda.probe_gather(ops, st, out_k)
    fdtd_cuda.probe_gather_plain(ops, st, out_p)
    torch.cuda.synchronize()
    same = torch.equal(out_k, out_p)
    assert same, "probe_gather is not bit-equal to its twin"
    ms = device_ms(lambda: fdtd_cuda.probe_gather(ops, st, out_k))
    plain_ms = events_ms(lambda: fdtd_cuda.probe_gather_plain(ops, st, out_p))
    A = probe_csr(ops)
    flat = torch.cat([f.reshape(-1) for f in st.fields])
    lib = A @ flat
    torch.cuda.synchronize()
    lib_err = close("probe_gather vs SpMV", out_k, lib)
    library_ms = device_ms(lambda: A @ flat)
    b_ms, b_by = k1_bound("probe_gather", sim)
    used = int(torch.count_nonzero(t.w))
    say(phase, f"probe_gather at {sim.grid.shape}: {t.n_rows:,} rows in blocks "
               f"(V, I, face E, face H) of {t.rows} rows x {t.k} terms, "
               f"{used:,} used entries; table {t.nbytes:,} B on the card (one "
               f"table padded to {max(t.k)} terms: {padded:,} B); kernel == "
               f"plain (bit-equal {same}); device {ms * 1e3:.2f} us/launch, "
               f"bound {b_ms * 1e3:.2f} us by {b_by} ({b_ms / ms:.3f} of it), "
               f"plain {plain_ms * 1e3:.1f} us, cuSPARSE SpMV (torch "
               f"sparse CSR @ flat) {library_ms * 1e3:.2f} us, == kernel "
               f"within rtol {RTOL} (max |err| {lib_err:.3e}) [{card}]")
    return dict(max_abs_err=float((out_k - out_p).abs().max()), ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=library_ms, nbytes=t.nbytes)


def phase_horn_golden():
    """The 12 GHz pyramidal horn of tests/test_horn.py on the card."""
    from fdtd_solver_antennas_tpu_torch import HornAntennaParams
    from fdtd_solver_antennas_tpu_torch.solvers.horn import (
        prepare_horn, pyramidal_horn_directivity_dbi, run_prepared_horn)

    hp = HornAntennaParams.from_user_units(
        frequency_ghz=12.0, throat_a_mm=19.05, throat_b_mm=9.525,
        aperture_A_mm=48.0, aperture_B_mm=36.0, length_mm=40.0)
    prep = prepare_horn(hp, device="cuda", mesh_ppw=14.0, theta_step_deg=5.0,
                        phi_step_deg=15.0, n_steps_max=6000)
    assert prep.ok, prep.message
    res = run_prepared_horn(prep, frequency_hz=12e9, verbose=0)
    assert res.ok, res.message
    theory = pyramidal_horn_directivity_dbi(hp)
    dmax = 10 * np.log10(res.Dmax)
    e_ratio = res.diagnostics["energy_ratio"]
    assert abs(theory - 14.06) < 0.05, theory
    assert abs(dmax - theory) < 1.5, f"horn Dmax {dmax:.2f} dBi vs {theory:.2f}"
    assert res.steps_run < 6000 and e_ratio < 1e-3, (res.steps_run, e_ratio)
    say("9", f"horn {prep.sim.grid.shape} ({prep.sim.pallas_mode} mode): Dmax "
             f"{dmax:.3f} dBi against Balanis {theory:.3f} dBi, "
             f"{res.steps_run} steps, energy ratio {e_ratio:.2e}")


def stream_kernel_alone(sim, phase, card):
    """``stream_steps`` (the march) on a random state against the twin at
    ``sim``'s shapes, both timed on the device, with ``probe_gather``."""
    from fdtd_solver_antennas_tpu_torch.ops import fdtd_cuda, fdtd_stream

    ops, T = sim.operands, sim.stream_T
    mur, pml = ops.mur is not None, ops.pml is not None
    wf = [0.37, -0.21, 0.55, 0.13, 0.4, -0.3, 0.2, 0.1][:T]
    base = random_state(sim, seed=13)
    sk, sp = clone_state(base), clone_state(base)
    del base
    fdtd_stream.stream_steps(ops, sk, wf)
    fdtd_stream.stream_steps_plain(ops, sp, wf)
    torch.cuda.synchronize()
    err = max(close(f"stream_steps {i}", a, b) for i, (a, b) in
              enumerate(zip(fields_of(sk), fields_of(sp))))
    same = all(torch.equal(a, b) for a, b in zip(fields_of(sk), fields_of(sp)))
    ms = device_ms(lambda: fdtd_stream.stream_steps(ops, sk, wf))
    # the plain twin's host blocks behind a held stream (it cannot queue
    # past the sleep kernel), so it is timed by events alone: its ~60
    # PyTorch ops per step each run longer than the host takes to issue
    plain_ms = events_ms(lambda: fdtd_stream.stream_steps_plain(ops, sp, wf))
    rows = ops.probes.n_rows
    out = torch.zeros(rows, device=sim.device)
    probe_ms = device_ms(lambda: fdtd_cuda.probe_gather(ops, sk, out))
    b_ms, b_by = k2_bound(ops, T)
    probe_b_ms, probe_b_by = k1_bound("probe_gather", sim)
    core, _o, mt, (seg, _so, segs), m_smem = fdtd_stream.march_plan(
        ops.shape, ops.grid_shape, T, mur, pml=pml)
    route = (f"march{' (CPML)' if pml else ''}: {mt[0] * mt[1] * segs} blocks "
             f"({mt[0]}x{mt[1]} tiles of {core[0]}x{core[1]}, {segs} x "
             f"segments of {seg}), {m_smem} B dynamic shared memory, "
             f"{fdtd_stream.blocks_per_sm(sk, T)} block(s) an SM")
    all_text = ""
    if pml:
        a_ms, a_by = k2_bound(ops, T, all_psi=True)
        all_text = (f"; the bound moving all twelve psi everywhere "
                    f"{a_ms * 1e3:.1f} us by {a_by} ({a_ms / ms:.3f} of it)")
    say(phase, f"stream_steps at {sim.grid.shape}, T={T}, {route}: == plain, "
               f"max |err| {err:.3e} (bit-equal {same}); device "
               f"{ms * 1e3:.1f} us/launch ({ms * 1e3 / T:.1f} us/step), bound "
               f"{b_ms * 1e3:.1f} us by {b_by} ({b_ms / ms:.3f} of it)"
               f"{all_text}; plain {plain_ms * 1e3:.1f} us; probe_gather "
               f"{probe_ms * 1e3:.1f} us (bound {probe_b_ms * 1e3:.2f} us by "
               f"{probe_b_by}) [{card}]")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, probe_ms=probe_ms)


def phase_stream_times(k2, card):
    """Forced chunk against forced stream, warm, at the tall grid and the
    mixed scene (chunk, stream, stream, chunk), per step; the march's
    device time per launch at the tall grid (the mixed scene's comes from
    phase 8) beside the bound."""
    from fdtd_solver_antennas_tpu_torch.ops import fdtd_cuda, fdtd_stream

    tall_chunk = one_chunk_sim(tall_scene, "MUR", 480, "chunk", decim=48)
    tall_stream = one_chunk_sim(tall_scene, "MUR", 480, "stream", decim=48)
    mixed = k2["sim"]
    cfg = dataclasses.replace(mixed.cfg, n_steps_max=2000)
    mixed_stream = dataclasses.replace(mixed, cfg=cfg)
    mixed_chunk = dataclasses.replace(mixed, cfg=cfg, pallas_mode="chunk",
                                      stream_T=1)
    stream_wall = {}
    for label, chunk_sim, stream_sim in (("tall", tall_chunk, tall_stream),
                                         ("mixed", mixed_chunk, mixed_stream)):
        cells = stream_sim.grid.num_cells
        times = []
        for sim, impl in ((chunk_sim, fdtd_cuda.kernels),
                          (stream_sim, fdtd_stream.kernels),
                          (stream_sim, fdtd_stream.kernels),
                          (chunk_sim, fdtd_cuda.kernels)):
            out, t = timed_run(sim, impl)
            times.append(t)
        steps = out["steps"]
        stream_wall[label] = (times[2], steps)
        rate = [cells * steps / t / 1e6 for t in times]
        us = [t / steps * 1e6 for t in times]
        say("10", f"{label} {stream_sim.grid.shape}, {steps} steps (decim "
                  f"{stream_sim.probe_decim}): K1 chunk {times[0]:.3f} / "
                  f"{times[3]:.3f} s ({us[0]:.1f} / {us[3]:.1f} us/step, "
                  f"{rate[0]:.1f} / {rate[3]:.1f} Mcell-updates/s), stream "
                  f"(march) T={stream_sim.stream_T} {times[1]:.3f} / "
                  f"{times[2]:.3f} s ({us[1]:.1f} / {us[2]:.1f} us/step, "
                  f"{rate[1]:.1f} / {rate[2]:.1f} Mcell-updates/s) [{card}]")
    tall = stream_kernel_alone(tall_stream, "10", card)
    wall, steps = stream_wall["tall"]
    busy = (steps // tall_stream.stream_T * tall["ms"]
            + steps // tall_stream.probe_decim * tall["probe_ms"]) / 1e3
    say("10", f"tall second stream run: kernels busy {busy:.3f} s of "
              f"{wall:.3f} s wall, idle share {1 - busy / wall:.2f} [{card}]")
    # the march's time per step against T on the mixed scene's state: the
    # resolver takes the deepest T the tiles allow
    base = random_state(mixed, seed=17)
    per_T = []
    for T in range(1, mixed.stream_T + 1):
        wf = [0.37, -0.21, 0.55, 0.13, 0.4][:T]
        ms = device_ms(lambda: fdtd_stream.stream_steps(mixed.operands, base, wf))
        per_T.append(f"T={T} {ms * 1e3:.1f} us ({ms * 1e3 / T:.1f} us/step)")
    del base
    say("10", f"mixed {mixed.grid.shape}, march by T: {', '.join(per_T)} [{card}]")
    say("10", f"mixed {mixed.grid.shape}: march {k2['ms'] * 1e3:.1f} us/launch "
              f"({k2['ms'] * 1e3 / mixed.stream_T:.1f} us/step, {k2['bound_ms'] / k2['ms']:.3f} "
              f"of the {k2['bound_ms'] * 1e3:.1f} us bound); tall {tall_stream.grid.shape}: "
              f"march {tall['ms'] * 1e3:.1f} us/launch ({tall['bound_ms'] / tall['ms']:.3f} "
              f"of the {tall['bound_ms'] * 1e3:.1f} us bound) [{card}]")
    return tall


def straddle_scene():
    """13 x lines: at 4 ranks (Px = 16, n = 4) the top MUR wall, row 12,
    is the first row of the last block (tests/test_torch_shard.py)."""
    from fdtd_solver_antennas_tpu_torch.models.scene import Scene
    from fdtd_solver_antennas_tpu_torch.ops.mesh import MeshBuilder

    mb = MeshBuilder()
    mb.add_line("x", np.linspace(0, 12, 13))
    mb.add_line("y", np.linspace(0, 15, 16))
    mb.add_line("z", np.linspace(0, 19, 20))
    grid = mb.build(1.0)
    scene = Scene()
    scene.add_material_box("sub", 4.3, 0.005, [3, 4, 8], [9, 11, 10], 0)
    scene.add_metal_box("patch", [4, 6, 10], [8, 10, 10], priority=10)
    scene.add_metal_box("gnd", [3, 4, 8], [9, 11, 8], priority=10)
    scene.add_lumped_port(1, 50.0, [6, 8, 8], [6, 8, 10], direction="z")
    return scene, grid, 2.45e9, 1.225e9


def k3_bound(sh, k):
    """Bound of one ``shard_steps`` launch of k steps on slab ``sh``: the
    fields (and ψ) in and out once, ca/cb and the sources in once; k
    steps of H and E updates over the slab's cells, as ``k2_bound``
    counts them."""
    ops = sh.ops
    n = int(np.prod(ops.shape))
    n_src = sum(s is not None for s in ops.src)
    psi = 12 if ops.pml is not None else 0
    nbytes = 4 * n * (6 + 6 + n_src + 6 + 2 * psi)
    return bound(nbytes, k * n * (48 + 4 * psi))


def first_text(us) -> str:
    return "not measured" if us is None else f"{us[0]:,.1f}-{us[1]:,.1f} us/launch"


def plan_text(plan) -> str:
    """A persistent stepper's launch: form, blocks × threads, barriers."""
    from fdtd_solver_antennas_tpu_torch.ops import persist

    if plan.form == "marched":
        seg, _so, segs = plan.segments
        return (f"marched form ({plan.blocks} blocks x {plan.threads} threads, "
                f"{plan.blocks_per_sm} an SM, {plan.smem_bytes:,} B shared; "
                f"T={plan.T}, {plan.tiles[0]}x{plan.tiles[1]} tiles of "
                f"{plan.core[0]}x{plan.core[1]}, {segs} x segments of {seg}, "
                f"{plan.items_per_variant} items a variant), one barrier "
                f"among a variant's blocks a round of T steps")
    cells = (f", {plan.cells_per_thread} cells a thread, {plan.smem_bytes:,} B "
             "shared" if plan.form == "resident" else "")
    return (f"{plan.form} form ({plan.blocks} blocks x {plan.threads} threads"
            f"{cells}), {persist.BARRIERS_PER_STEP} grid barriers a step")


def phase_shard_vs_plain(card):
    """K3 against its twin: one launch on a seeded random slab state per
    case, owned rows compared, in the form the shape picks and, at the
    canonical slab, in both forms; the canonical one-rank launch timed in
    each form beside the bound and the first design's time."""
    from fdtd_solver_antennas_tpu_torch.ops import fdtd_shard

    cases = (  # (label, scene, boundary, n_dev, rank, decim, window, forms)
        ("canonical", canonical_scene, "MUR", 1, 0, 89, "K", (None, "streamed")),
        ("canonical", canonical_scene, "MUR", 1, 0, 89, "rem", (None,)),
        ("canonical", canonical_scene, "PEC", 1, 0, 89, "K", (None, "streamed")),
        ("canonical", canonical_scene, "MUR", 4, 2, 89, "K", (None,)),
        ("canonical", canonical_scene, "PML_4", 4, 1, 89, "rem", (None, "streamed")),
        ("straddle", straddle_scene, "MUR", 4, 3, 4, "K", (None, "streamed")),
    )
    worst = 0.0
    timed = None
    for label, make, boundary, n_dev, rank, decim, window, forms in cases:
        sim = shard_sim(make, boundary, n_dev, decim)
        sh = fdtd_shard.build_shard_stepper(sim, n_dev, rank)
        k = sh.K if window == "K" else sh.rem
        rng = np.random.default_rng(19 + rank)
        base = sh.new_state()
        for t in (*base.e[0], *base.e[1], *base.h, *base.psi_e, *base.psi_h):
            t.copy_(torch.from_numpy(rng.standard_normal(t.shape).astype(np.float32)))
        wf = list(rng.uniform(-1.0, 1.0, k))
        sp = clone_state(base)
        fdtd_shard.shard_steps_plain(sh.ops, sp, wf)
        for form in forms:
            sk = clone_state(base)
            plan = fdtd_shard.launch_plan(sh.ops, sk, form)
            fdtd_shard.shard_steps(sh.ops, sk, wf, form=form)
            torch.cuda.synchronize()
            assert sk.parity == sp.parity
            err = max(close(f"shard_steps {i}", a[sh.owned], b[sh.owned])
                      for i, (a, b) in enumerate(zip(fields_of(sk), fields_of(sp))))
            same = all(torch.equal(a[sh.owned], b[sh.owned])
                       for a, b in zip(fields_of(sk), fields_of(sp)))
            worst = max(worst, err)
            extra = ""
            if label == "canonical" and n_dev == 1 and window == "K":
                ms = device_ms(lambda: fdtd_shard.shard_steps(sh.ops, sk, wf, form=form),
                               reps=10)
                b_ms, b_by = k3_bound(sh, k)
                extra = (f"; device {ms * 1e3:.1f} us/launch ({ms * 1e3 / k:.2f} "
                         f"us/step), first design "
                         f"{first_text(K3_FIRST_US.get(boundary))}; bound "
                         f"{b_ms * 1e3:.2f} us by {b_by} ({b_ms / ms:.3f} of it)")
                if boundary == "MUR" and form is None:
                    spare = clone_state(sp)  # sp stays the reference
                    plain_ms = events_ms(
                        lambda: fdtd_shard.shard_steps_plain(sh.ops, spare, wf),
                        reps=2, warmup=1)
                    del spare
                    timed = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                 bound_by=b_by, m=sh.m, k=k, plan=plan)
                    extra += f", plain {plain_ms * 1e3:.1f} us"
            say("11", f"{label} {sim.grid.shape} {boundary}, {n_dev} rank(s), rank "
                      f"{rank}: slab {sh.ops.shape}, K={sh.K} W={sh.W} rem={sh.rem}, "
                      f"window {k}, {plan_text(plan)}: shard_steps == plain on "
                      f"owned rows (bit-equal {same}), max |err| {err:.3e}{extra} "
                      f"[{card}]")
    return dict(max_abs_err=worst, **timed)


def phase_explicit_main_path(chunk_res, card):
    """The explicit slice: the canonical patch through
    ``build_explicit_run`` on one card, as bench.py drives the JAX
    package's explicit path, with S11 and Dmax from the port's post."""
    from fdtd_solver_antennas_tpu_torch.ops import fdtd_cuda, fdtd_shard, fdtd_stream
    from fdtd_solver_antennas_tpu_torch.parallel import build_explicit_run
    from fdtd_solver_antennas_tpu_torch.solvers.patch_fixed import (
        prepare_patch_fixed, run_prepared_fixed)

    params = canonical_params()
    prep = prepare_patch_fixed(params, device="cuda")
    assert prep.ok, prep.message
    run = build_explicit_run(prep.sim)
    sh = run.stepper
    outs = []

    def explicit():
        outs.append(run())
        return outs[-1]

    fdtd_cuda.reset_launch_counts()
    fdtd_stream.reset_launch_counts()
    fdtd_shard.reset_launch_counts()
    res = run_prepared_fixed(prep, frequency_hz=params.frequency_hz, verbose=0,
                             run=explicit)
    counts = {**fdtd_cuda.launches, **fdtd_stream.launches,
              **fdtd_shard.launches}
    forms = dict(fdtd_shard.launches_by_form)
    assert res.ok, res.message
    out = outs[0]
    D = prep.sim.probe_decim
    plan = fdtd_shard.launch_plan(sh.ops, sh.new_state())
    assert forms == {plan.form: counts["shard_steps"], **{
        f: 0 for f in forms if f != plan.form}}, (forms, plan)
    intervals = out["steps"] // D
    per_interval = -(-D // sh.K)
    assert out["steps"] % D == 0, (out["steps"], D)
    assert counts["shard_steps"] == intervals * per_interval, counts
    assert counts["probe_gather"] == intervals, counts
    for name in ("h_update", "e_update", "mur_faces", "stream_steps",
                 "chunk_steps"):
        assert counts[name] == 0, counts
    assert out["steps"] == chunk_res.steps_run, (out["steps"], chunk_res.steps_run)
    ref = prep.sim.run()
    err = compare_runs(out, ref, "explicit vs chunk")
    same = all(torch.equal(a, b) for a, b in zip(out["fields"], ref["fields"]))
    s11_db = 20 * np.log10(np.maximum(np.abs(res.s11), 1e-12))
    dmax_dbi = 10 * np.log10(res.Dmax)
    assert np.all(np.isfinite(res.intensity)) and np.isfinite(res.Dmax)
    assert 5.0 < dmax_dbi < 8.0, f"Dmax {dmax_dbi:.2f} dBi outside 5-8"
    assert s11_db.min() < -8.0, f"|S11|min {s11_db.min():.2f} dB not < -8"
    say("12", f"canonical patch {prep.sim.grid.shape} through build_explicit_run "
              f"on {prep.sim.device}, one rank: slab {sh.ops.shape}, K={sh.K}, "
              f"D={D} ({per_interval} launches per interval); {out['steps']} "
              f"steps (chunk mode {chunk_res.steps_run}) in {res.wall_time_s:.3f} s, "
              f"{res.mcells_per_s:.1f} Mcell-updates/s; == chunk mode (uf, if_, "
              f"nf_e, nf_h, fields; fields bit-equal {same}), max |err| "
              f"{err:.3e}; f_res {res.f_res_hz / 1e9:.4f} GHz, |S11|min "
              f"{s11_db.min():.2f} dB, Dmax {dmax_dbi:.3f} dBi; launches "
              f"{counts}, shard_steps by form {forms}, {plan_text(plan)} "
              f"[{card}]")
    return res, counts


def phase_explicit_times(k3, explicit_res, explicit_counts, card):
    """The JAX bench's pinned explicit run: 160,000 steps on one card,
    explicit path and chunk mode on the same scene (explicit, chunk,
    chunk, explicit)."""
    from fdtd_solver_antennas_tpu_torch.parallel import build_explicit_run
    from fdtd_solver_antennas_tpu_torch.solvers.patch_fixed import prepare_patch_fixed

    prep = prepare_patch_fixed(canonical_params(), device="cuda",
                               n_steps_max=PINNED_STEPS, end_criteria=1e-30)
    assert prep.ok, prep.message
    sim = prep.sim
    run = build_explicit_run(sim)
    cells = sim.grid.num_cells
    times = {}
    for label, fn in (("explicit", run), ("chunk", sim.run),
                      ("chunk", sim.run), ("explicit", run)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.setdefault(label, []).append(time.perf_counter() - t0)
        steps = int(out["steps"])
        assert PINNED_STEPS <= steps <= 161_000, steps
        assert np.all(np.isfinite(out["uf"]))
    for label, ts in times.items():
        rates = [cells * steps / t / 1e6 for t in ts]
        say("13", f"pinned canonical run {sim.grid.shape}, {steps} steps, "
                  f"{label}: {ts[0]:.3f} / {ts[1]:.3f} s = {rates[0]:.1f} / "
                  f"{rates[1]:.1f} Mcell-updates/s, "
                  f"{min(ts) / steps * 1e6:.2f} us/step [{card}]")
    # busy time: steps x the device time per step of a full K-step launch
    # (a remainder launch carries fewer steps, so launches x the K-step
    # time would overcount it)
    per_step = k3["ms"] / k3["k"] / 1e3
    first = K3_FIRST_US["MUR"]
    say("13", f"shard_steps in these runs: {plan_text(k3['plan'])}; "
              f"{k3['ms'] * 1e3:.1f} us per {k3['k']}-step launch, "
              f"{per_step * 1e6:.2f} us/step (first design "
              f"{first[0]:,.1f}-{first[1]:,.1f} us/launch, "
              f"{first[0] / k3['k']:.2f}-{first[1] / k3['k']:.2f} us/step), bound "
              f"{k3['bound_ms'] * 1e3:.2f} us/launch [{card}]")
    wall = min(times["explicit"])
    launches = steps // sim.probe_decim * -(-sim.probe_decim // run.kernel_window)
    busy = steps * per_step
    say("13", f"pinned explicit run: {launches} shard_steps launches, {steps} "
              f"steps x {per_step * 1e6:.2f} us = {busy:.3f} s busy of "
              f"{wall:.3f} s wall, idle share {1 - busy / wall:.2f} [{card}]")
    busy = explicit_res.steps_run * per_step
    say("13", f"explicit main-path run (phase 12): {explicit_counts['shard_steps']} "
              f"launches, shard_steps busy {busy:.3f} s of "
              f"{explicit_res.wall_time_s:.3f} s wall, idle share "
              f"{1 - busy / explicit_res.wall_time_s:.2f} [{card}]")


def k4_bound(ops, d):
    """Bound of one ``interval_steps`` launch of d steps: the fields in
    and out once, ca/cb, the sources and the d samples in once; d steps
    of H and E updates, as ``k2_bound`` counts them."""
    n = int(np.prod(ops.shape))
    n_src = sum(s is not None for s in ops.src)
    return bound(4 * n * (6 + 6 + n_src + 6) + 4 * d, d * n * 48)


def phase_steps_vs_plain(card):
    """K4 against its twin: one launch of D steps on a seeded random state
    per case, every field compared, in the form the shape picks and, at
    the canonical patch, in both forms; each timed on the device beside
    the bound, the first design's time and an empty cooperative launch of
    2·D grid barriers at the same block count (the design's floor)."""
    from fdtd_solver_antennas_tpu_torch.ops import fdtd_steps

    cases = (("canonical", canonical_scene, "MUR", 89, (None, "streamed")),
             ("canonical", canonical_scene, "PEC", 89, (None, "streamed")),
             ("tall", tall_scene, "MUR", 50, (None,)))
    worst, timed = 0.0, None
    for label, make, boundary, decim, forms in cases:
        sim = one_chunk_sim(make, boundary, 10 * decim, mode="chunk",
                            decim=decim)
        ops, D = sim.operands, sim.probe_decim
        assert D == decim, (D, decim)
        base = random_state(sim, seed=47)
        wf = torch.from_numpy(np.random.default_rng(53).uniform(
            -1.0, 1.0, D).astype(np.float32)).to(sim.device)
        wf_list = wf.tolist()
        sp = clone_state(base)
        fdtd_steps.interval_steps_plain(ops, sp, wf_list)
        b_ms, b_by = k4_bound(ops, D)
        for form in forms:
            sk = clone_state(base)
            plan = fdtd_steps.launch_plan(ops, sk, form)
            fdtd_steps.interval_steps(ops, sk, wf, form=form)
            torch.cuda.synchronize()
            assert sk.parity == sp.parity
            err = max(close(f"interval_steps {i}", a, b) for i, (a, b) in
                      enumerate(zip(fields_of(sk), fields_of(sp))))
            same = all(torch.equal(a, b)
                       for a, b in zip(fields_of(sk), fields_of(sp)))
            worst = max(worst, err)
            ms = device_ms(lambda: fdtd_steps.interval_steps(ops, sk, wf, form=form),
                           reps=10)
            barrier_ms = device_ms(
                lambda: fdtd_steps.grid_barriers(plan, 2 * D), reps=10)
            extra = ""
            if timed is None:  # the canonical MUR case goes in the kernel table
                spare = clone_state(sp)  # sp stays the reference
                plain_ms = events_ms(
                    lambda: fdtd_steps.interval_steps_plain(ops, spare, wf_list),
                    reps=2, warmup=1)
                del spare
                timed = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                             bound_by=b_by, plan=plan, barrier_ms=barrier_ms)
                extra = f", plain {plain_ms * 1e3:.1f} us"
            first = K4_FIRST_US[(label, boundary)] if form is None else None
            say("14", f"{label} {sim.grid.shape} {boundary}, D={D}, "
                      f"{plan_text(plan)}: interval_steps == plain (bit-equal "
                      f"{same}), max |err| {err:.3e}; device {ms * 1e3:.1f} "
                      f"us/launch ({ms * 1e3 / D:.2f} us/step), first design "
                      f"{first_text(first)}; bound {b_ms * 1e3:.2f} us by {b_by} "
                      f"({b_ms / ms:.4f} of it); {2 * D} grid barriers alone "
                      f"on {plan.blocks} blocks {barrier_ms * 1e3:.1f} us "
                      f"({barrier_ms * 1e3 / D:.2f} us/step, "
                      f"{barrier_ms / ms:.2f} of the launch){extra} [{card}]")
        del base, sk, sp
    return dict(max_abs_err=worst, **timed)


def phase_steps_main_path(k4, card):
    """The interval slice: the canonical patch through ``build_stepper``'s
    ``step_fn``, 125 intervals of D = 89 steps from zero fields, held to the
    same 11,125 steps through K1's field kernels (no probes); the run's
    idle share from phase 14's device time per launch."""
    from fdtd_solver_antennas_tpu_torch.ops import fdtd_cuda, fdtd_steps

    intervals = 125
    sim = one_chunk_sim(canonical_scene, "MUR", intervals * 89, decim=89)
    D, shape, dev = sim.probe_decim, sim.padded_shape, sim.device
    steps = intervals * D
    step_fn, to_flat, from_flat = fdtd_steps.build_stepper(sim, *sim._aux[:3])
    wf = torch.from_numpy(np.asarray(sim.waveform[:steps], np.float32)).to(dev)
    fields = tuple(to_flat(torch.zeros(shape, device=dev)) for _ in range(6))
    first = fields
    fdtd_steps.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(intervals):
        fields = step_fn(fields, wf[i * D:(i + 1) * D])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fdtd_steps.launches["interval_steps"]
    assert launches == intervals, fdtd_steps.launches
    forms = dict(fdtd_steps.launches_by_form)
    assert forms[k4["plan"].form] == intervals, (forms, k4["plan"])
    # step_fn returns new tensors and leaves its inputs alone
    assert all(f is not g for f, g in zip(fields, first))
    assert all(int(torch.count_nonzero(f)) == 0 for f in first)
    fields = tuple(from_flat(f) for f in fields)

    st = fdtd_cuda.new_state(shape, dev, pml=False)
    samples = wf.tolist()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for s in samples:
        fdtd_cuda.leapfrog_step(fdtd_cuda.kernels, sim.operands, st, s)
    torch.cuda.synchronize()
    k1_wall = time.perf_counter() - t0
    err = max(close(f"step_fn vs K1 field {i}", a, b)
              for i, (a, b) in enumerate(zip(fields, st.fields)))
    same = all(torch.equal(a, b) for a, b in zip(fields, st.fields))
    peak = max(float(f.abs().max()) for f in fields)
    assert np.isfinite(peak) and peak > 0, peak
    cells = sim.grid.num_cells
    say("14", f"canonical patch {sim.grid.shape} through build_stepper: "
              f"{launches} interval_steps launches, {steps} steps from zero "
              f"fields in {wall:.3f} s ({cells * steps / wall / 1e6:.1f} "
              f"Mcell-updates/s); K1's field kernels, same steps, no probes: "
              f"{k1_wall:.3f} s; fields == K1 (bit-equal {same}), max |err| "
              f"{err:.3e}, max |field| {peak:.3e} [{card}]")
    busy = launches * k4["ms"] / 1e3
    say("14", f"interval run: {launches} launches ({forms}, "
              f"{plan_text(k4['plan'])}) x {k4['ms'] * 1e3:.1f} us = "
              f"{busy:.3f} s busy of {wall:.3f} s wall, idle share "
              f"{1 - busy / wall:.3f} [{card}]")
    return launches


def sm_clock_hz() -> float:
    """The card's highest SM clock, as nvidia-smi reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


SMEM_BYTES_PER_CLK = 128  # shared memory per SM per clock (Hopper)


def k5_bounds(R, C, iters, sms, clock_hz):
    """Bounds of one ``roll_chain`` launch: (shared-memory ms, FLOP ms).
    Shared memory: each element-shift stores and loads 4 B, R·C·4·iters
    of them, at 128 B a clock on each of ``sms`` SMs. Operations: 2 adds
    and 2 multiplies per element per iteration at the float32 peak (the
    array in and out once over HBM is smaller than either)."""
    smem = 2 * 4 * R * C * 4 * iters / (SMEM_BYTES_PER_CLK * clock_hz * sms)
    return smem * 1e3, 4 * R * C * iters / FP32_FLOPS * 1e3


def phase_roll_chain(card):
    """K5 against its twin at the roofline's default shape, bit for bit,
    timed on the device in turns beside its bounds; then the roofline
    entry point on the card, its launches counted. ``bound_ms`` is the
    shared-memory bound over all the card's SMs; the same bound over the
    SMs that one block a row holds is printed beside it as the design's
    own ceiling."""
    from fdtd_solver_antennas_tpu_torch.examples import chunk_roofline
    from fdtd_solver_antennas_tpu_torch.ops import roll_chain as rc

    R, C, iters = 56, 55 * 128, 200
    a = torch.from_numpy(np.random.default_rng(59).uniform(
        0.5, 1.5, (R, C)).astype(np.float32)).to("cuda")
    ref = rc.roll_chain_plain(a, iters)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock = sm_clock_hz()
    say("15", f"SM clock (nvidia-smi clocks.max.sm) {clock / 1e6:.0f} MHz, "
              f"{sms} SMs, shared memory {SMEM_BYTES_PER_CLK} B/clock/SM [{card}]")
    out = rc.roll_chain(a, iters)
    torch.cuda.synchronize()
    same = torch.equal(out, ref)
    assert same, "roll_chain is not bit-equal to its twin"
    plan = rc.plan(a.shape)
    used = min(plan["blocks"], sms)
    smem_ms, flop_ms = k5_bounds(R, C, iters, sms, clock)
    design_ms = k5_bounds(R, C, iters, used, clock)[0]
    times = [device_ms(lambda: rc.roll_chain(a, iters)) for _ in range(3)]
    plain_ms = events_ms(lambda: rc.roll_chain_plain(a, iters), reps=2, warmup=1)
    row = dict(max_abs_err=close("roll_chain", out, ref), ms=min(times),
               plain_ms=plain_ms, bound_ms=smem_ms, bound_by="bytes")
    shifts = rc.SHIFTS_PER_ITER * R * C * iters
    say("15", f"roll_chain {R}x{C}, {iters} iterations, one block a row "
              f"({plan['blocks']} blocks x {plan['threads']} threads, "
              f"{plan['per_thread']} float4 a thread, {plan['smem_bytes']:,} B "
              f"shared): kernel == plain (bit-equal {same}), max |err| "
              f"{row['max_abs_err']:.3e}; device "
              f"{' / '.join(f'{t * 1e3:.1f}' for t in times)} us/launch, "
              f"{shifts / row['ms'] / 1e6:.1f} G element-shifts/s on {used} of "
              f"{sms} SMs; shared-memory bound {smem_ms * 1e3:.1f} us on all "
              f"{sms} SMs ({smem_ms / row['ms']:.3f} of it), "
              f"{design_ms * 1e3:.1f} us on the {used} SMs the design holds "
              f"({design_ms / row['ms']:.3f} of it); FLOP bound "
              f"{flop_ms * 1e3:.2f} us; plain {plain_ms * 1e3:.1f} us [{card}]")
    print(card, flush=True)
    rc.reset_launch_counts()
    res = chunk_roofline.main([])
    launches = rc.launches["roll_chain"]
    assert launches > 0 and res["calibration"]["device"] == torch.cuda.get_device_name(0)
    assert np.isfinite(res["bound_gcells_per_s"]) and res["bound_gcells_per_s"] > 0
    cal = res["calibration"]
    say("15", f"roofline ({cal['ctas_per_row']} CTA a row): shift rate "
              f"{res['roll_rate_gelems_per_s']:.1f} Gelem/s on {cal['sms_used']} "
              f"of {cal['sm_count']} SMs ({cal['blocks']} blocks, {cal['iters']} "
              f"iterations, {cal['wall_s'] * 1e6:.1f} us, empty launch "
              f"{cal['floor_s'] * 1e6:.1f} us); bound for a kernel taking "
              f"{res['rolls_per_padded_elem']} neighbour reads per cell-step "
              f"from shared memory: {res['bound_gcells_per_s']:.2f} Gcell/s "
              f"on those SMs, {res['bound_gcells_per_s'] * sms / cal['sms_used']:.2f} "
              f"Gcell/s scaled to all {sms}; {launches} roll_chain launches "
              f"[{card}]")
    return dict(row, launches=launches)


def k1_batch_bound(ops, batch, n_sub, D):
    """Bound of one ``chunk_steps_batch`` launch with every variant
    stepping: per variant its fields in and out once, its ψ as
    ``psi_cells`` counts them in and out once and its ca/cb in once; the
    shared source stamps, samples and probe table (code and weight) in
    once; each variant's samples written once per interval (the values
    the table gathers are the fields, already counted); per variant the
    operations ``k1_chunk_bound`` counts."""
    n = int(np.prod(ops.shape))
    n_src = sum(s is not None for s in ops.src)
    psi = psi_cells(ops, (0, ops.shape[0]))
    rows = ops.probes.n_rows
    used = int(torch.count_nonzero(ops.probes.w))
    nbytes = (batch * (4 * n * (6 + 6 + 6) + 8 * psi) + 4 * n * n_src
              + 4 * n_sub * D + 8 * used + batch * n_sub * 4 * rows)
    flops = batch * (n_sub * D * (48 * n + 4 * psi) + n_sub * 2 * used)
    return bound(nbytes, flops)


def batch_tensors(st):
    return (*st.e[0], *st.e[1], *st.h, *st.psi_e, *st.psi_h)


def batch_inputs(sim, batch, seed, n_sub, n0=7):
    """Batched operands of ``sim`` (variant b's ca/cb scaled by a seeded
    factor near 1, variant 0 the sim's own), a seeded random batch state at
    parity 1, a random waveform for two chunks from ``n0`` and staging
    buffers, on the card."""
    from fdtd_solver_antennas_tpu_torch.ops import fdtd_cuda

    rng = np.random.default_rng(seed)
    ops = sim.operands
    scale = torch.from_numpy(rng.uniform(0.9, 1.1, (batch, 1, 1, 1)).astype(
        np.float32)).to(sim.device)
    scale[0] = 1.0
    bops = fdtd_cuda.batch_operands(ops, [c[None] * scale for c in ops.ca],
                                    [c[None] * scale for c in ops.cb])
    st = fdtd_cuda.new_batch_state(sim.padded_shape, sim.device,
                                   ops.pml is not None, batch)
    for t in batch_tensors(st):
        t.copy_(torch.from_numpy(rng.standard_normal(t.shape).astype(np.float32)))
    st.parity = [1] * batch
    wf = torch.from_numpy(rng.uniform(
        -1.0, 1.0, n0 + 2 * n_sub * sim.probe_decim).astype(np.float32)).to(sim.device)
    bufs = torch.zeros((batch, n_sub, ops.probes.n_rows), device=sim.device)
    return bops, st, wf, bufs


def clone_batch(st):
    """A copy of a batch state: both E buffers, both H and ψ sets, and
    each variant's parity and set."""
    from fdtd_solver_antennas_tpu_torch.ops import fdtd_cuda

    def c(ts):
        return tuple(t.clone() for t in ts)

    return fdtd_cuda.YeeBatch(
        e=[c(st.e[0]), c(st.e[1])], h=c(st.h), psi_e=c(st.psi_e),
        psi_h=c(st.psi_h), parity=list(st.parity), h1=c(st.h1),
        psi_e1=c(st.psi_e1), psi_h1=c(st.psi_h1), hset=list(st.hset))


def batch_forms(ops, st):
    """The forms to compare: the one the plan picks (None), then each other
    form the plan allows (a refused resident form is not launched)."""
    from fdtd_solver_antennas_tpu_torch.ops import fdtd_cuda

    picked = fdtd_cuda.chunk_launch_plan(ops, st).form
    forms = [None]
    for form in ("resident", "streamed", "marched"):
        if form == picked:
            continue
        try:
            fdtd_cuda.chunk_launch_plan(ops, st, form)
        except ValueError:
            continue
        forms.append(form)
    return forms


def batch_current(st, bufs):
    """Each variant's current fields (its own E buffer and H set) and the
    staging buffers: what a form's chunk leaves for the run loop."""
    return (*st.fields(), bufs)


def batch_frozen(st, v):
    """Copies of variant v's slice of every tensor of a batch state."""
    return [t[v].clone() for t in (*batch_tensors(st), *st.h1)]


def phase_batch_vs_plain(card):
    """``chunk_steps_batch`` against ``chunk_steps_batch_plain``: two chunks
    from parity 1 on a seeded random batch, every variant stepping in the
    first and variant 1 frozen in the second; every field, ψ and sample
    compared (the marched form: each variant's current fields, which it
    leaves in the set its last round wrote), the frozen variant untouched;
    in the form the plan picks and each other form it allows (the marched
    form's T = 3 divides neither D here: each interval ends in a shorter
    round). Then B = 1 against
    ``chunk_steps`` at the canonical patch, bit for bit (the marched form:
    its current fields and samples). Returns the worst max |err| and the
    marched form's."""
    from fdtd_solver_antennas_tpu_torch.ops import fdtd_cuda

    worst = marched_worst = 0.0
    for label, make, boundary, batch, decim, n_sub in (
            ("small", small_scene, "MUR", 3, 5, 3),
            ("small", small_scene, "PEC", 3, 5, 3),
            ("small", small_scene, "PML_4", 3, 5, 3),
            ("canonical", canonical_scene, "MUR", 2, 89, 1),
            ("canonical", canonical_scene, "PML_8", 2, 89, 1)):
        sim = one_chunk_sim(make, boundary, n_sub * decim, mode="chunk",
                            decim=decim)
        D = sim.probe_decim
        ops, base, wf, bufs = batch_inputs(sim, batch, seed=107, n_sub=n_sub)
        for form in batch_forms(ops, base):
            a, bufs_a = clone_batch(base), bufs.clone()
            b, bufs_b = clone_batch(base), bufs.clone()
            plan = fdtd_cuda.chunk_launch_plan(ops, a, form)
            marched = plan.form == "marched"
            err, same = 0.0, True
            for i, mask in enumerate(([True] * batch,
                                      [v != 1 for v in range(batch)])):
                if i == 1:
                    frozen = batch_frozen(a, 1)
                    frozen_bufs = bufs_a[1].clone()
                n0 = 7 + i * n_sub * D
                fdtd_cuda.chunk_steps_batch(ops, a, wf, n0, n_sub, D, bufs_a,
                                            mask, form=form)
                fdtd_cuda.chunk_steps_batch_plain(ops, b, wf, n0, n_sub, D,
                                                  bufs_b, mask)
                torch.cuda.synchronize()
                if marched:
                    got, ref = batch_current(a, bufs_a), batch_current(b, bufs_b)
                else:
                    assert a.parity == b.parity, (a.parity, b.parity)
                    got = (*batch_tensors(a), bufs_a)
                    ref = (*batch_tensors(b), bufs_b)
                err = max(err, *(close(f"chunk_steps_batch {label} {boundary} "
                                       f"chunk {i}", x, y)
                                 for x, y in zip(got, ref)))
                same = same and all(torch.equal(x, y) for x, y in zip(got, ref))
            untouched = (all(torch.equal(t[1], t0) for t, t0 in
                             zip((*batch_tensors(a), *a.h1), frozen))
                         and torch.equal(bufs_a[1], frozen_bufs))
            assert untouched, "chunk_steps_batch wrote a frozen variant"
            worst = max(worst, err)
            if marched:
                marched_worst = max(marched_worst, err)
            rounds = (f" ({D // plan.T} rounds of T={plan.T} and one of "
                      f"{D % plan.T} an interval)" if marched else "")
            say("16", f"{label} {sim.grid.shape} {boundary}, B={batch}, {n_sub} "
                      f"intervals x D={D}{rounds}, {plan_text(plan)}: chunk_steps_batch "
                      f"== plain over two chunks, variant 1 frozen in the "
                      f"second (untouched {untouched}; bit-equal {same}), max "
                      f"|err| {err:.3e} [{card}]")
        if label == "canonical":
            forms = [None] + (["marched"] if boundary == "MUR" else [])
            for form in forms:
                one, st1, wf1, bufs1 = batch_inputs(sim, 1, seed=109,
                                                    n_sub=n_sub)
                v0 = st1.variant(0)
                ref = fdtd_cuda.YeeState(
                    e=[tuple(t.clone() for t in v0.e[p]) for p in range(2)],
                    h=tuple(t.clone() for t in v0.h),
                    psi_e=tuple(t.clone() for t in v0.psi_e),
                    psi_h=tuple(t.clone() for t in v0.psi_h), parity=1)
                rbufs = bufs1[0].clone()
                plan1 = fdtd_cuda.chunk_launch_plan(one, st1, form)
                fdtd_cuda.chunk_steps_batch(one, st1, wf1, 7, n_sub, D, bufs1,
                                            [True], form=form)
                fdtd_cuda.chunk_steps(sim.operands, ref, wf1, 7, n_sub, D, rbufs)
                torch.cuda.synchronize()
                got = st1.variant(0)
                same = (torch.equal(bufs1[0], rbufs)
                        and (form == "marched" or got.parity == ref.parity)
                        and all(torch.equal(x, y) for x, y in zip(
                            (*got.fields, *got.psi_e, *got.psi_h),
                            (*ref.fields, *ref.psi_e, *ref.psi_h))))
                assert same, (f"B = 1 differs from chunk_steps at {label} "
                              f"{boundary} ({plan1.form})")
                say("16", f"{label} {boundary}, B=1, {plan_text(plan1)}: "
                          f"chunk_steps_batch bit-equal to chunk_steps [{card}]")
    return worst, marched_worst


def phase_sweep_main_path(marched_err, card):
    """``bench.py``'s 8-variant sweep through the entry points a user
    calls: prepare, then a run in the form the plan picks whose launches
    are counted (one ``chunk_steps_batch`` per chunk, nothing else) and a
    rerun, eight distinct spectra; the same sweep in the other of the
    streamed and marched forms (``fdtd_cuda.marches``, the plan's rule,
    patched for that run), counted alike, its steps, energy ratios and
    spectra equal to the first run's at the tolerance; one launch of each
    form at its shapes against the twin, and the streamed form, the
    marched form and K2's batched march timed on the device in this call
    beside their bounds; the plan may pick the marched form only where it
    is the faster; the same variants as eight unbatched ``chunk_steps``
    runs, in turns with the batched run. Returns the kernels line's row
    of the form the plan picks (launches from the counted run) and the
    sweep's result and walls."""
    from fdtd_solver_antennas_tpu_torch.ops import fdtd_cuda, fdtd_stream
    from fdtd_solver_antennas_tpu_torch.ops.fdtd import chunk_geometry
    from fdtd_solver_antennas_tpu_torch.solvers.sweep import (
        prepare_patch_geometry_sweep, run_patch_geometry_sweep)

    variants = sweep_variants()
    B = len(variants)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prep = prepare_patch_geometry_sweep(variants, n_steps_max=SWEEP_STEPS,
                                        end_criteria=1e-4, device="cuda")
    torch.cuda.synchronize()
    prep_s = time.perf_counter() - t0
    assert prep.ok, prep.message
    sim = prep.sim
    cells = sim.grid.num_cells
    D, n_sub, chunk, _ = chunk_geometry(sim)
    bops = sweep_operands(prep)

    def fresh():
        return fdtd_cuda.new_batch_state(sim.padded_shape, sim.device, False, B)

    plan = fdtd_cuda.chunk_launch_plan(bops, fresh())
    plans = {f: fdtd_cuda.chunk_launch_plan(bops, fresh(), f)
             for f in ("streamed", "marched")}
    say("16", f"sweep prepared: {B} variants on the union grid {sim.grid.shape} "
              f"({cells:,} cells, {B * cells:,} cell-updates a step), D={D}, "
              f"{n_sub} intervals a chunk, in {prep_s:.2f} s; the plan picks "
              f"{plan_text(plan)}; the marched form's plan: "
              f"{plan_text(plans['marched'])} [{card}]")

    def counted_run(form):
        """One run with the plan's rule patched to pick ``form``; its
        result, launches by wrapper and by form."""
        saved = fdtd_cuda.marches
        fdtd_cuda.marches = lambda ops, batch: form == "marched"
        try:
            assert fdtd_cuda.chunk_launch_plan(bops, fresh()).form == form
            fdtd_cuda.reset_launch_counts()
            fdtd_stream.reset_launch_counts()
            out = run_patch_geometry_sweep(prep)
            counts = {**fdtd_cuda.launches, **fdtd_stream.launches}
            forms = dict(fdtd_cuda.launches_by_form)
        finally:
            fdtd_cuda.marches = saved
        assert out.ok, out.message
        chunks = -(-out.steps_run // chunk)
        assert counts["chunk_steps_batch"] == chunks > 0, counts
        assert all(v == 0 for k, v in counts.items()
                   if k != "chunk_steps_batch"), counts
        assert forms[form] == chunks and sum(forms.values()) == chunks, forms
        return out, counts, forms

    fdtd_cuda.reset_launch_counts()
    fdtd_stream.reset_launch_counts()
    res = run_patch_geometry_sweep(prep)
    counts = {**fdtd_cuda.launches, **fdtd_stream.launches}
    forms = dict(fdtd_cuda.launches_by_form)
    assert res.ok, res.message
    assert counts["chunk_steps_batch"] == -(-res.steps_run // chunk) > 0, counts
    assert all(v == 0 for k, v in counts.items()
               if k != "chunk_steps_batch"), counts
    assert forms[plan.form] == counts["chunk_steps_batch"] == sum(
        forms.values()), forms
    chunks = counts["chunk_steps_batch"]
    assert (res.steps == res.steps_run).all(), res.steps
    uf = np.stack([sp.uf for sp in res.spectra]) / sim.dft_dt  # raw DFT sums
    assert np.isfinite(uf).all(), "non-finite port DFTs"
    for i in range(1, B):
        assert not np.allclose(uf[0], uf[i], rtol=1e-3), (
            f"variant {i} spectrum identical to variant 0: geometry broadcast")
    res2 = run_patch_geometry_sweep(prep)
    assert res2.ok, res2.message
    np.testing.assert_array_equal(
        np.stack([sp.uf for sp in res2.spectra]) / sim.dft_dt, uf)

    # the same sweep in the other form, held to the first run
    other = "streamed" if plan.form == "marched" else "marched"
    res_o, counts_o, forms_o = counted_run(other)
    np.testing.assert_array_equal(res_o.steps, res.steps)
    close(f"sweep e_ratio, {other} against {plan.form}", res_o.e_ratio,
          res.e_ratio)
    for v in range(B):
        for q in ("uf", "if_"):
            close(f"sweep variant {v} {q}, {other} against {plan.form}",
                  getattr(res_o.spectra[v], q), getattr(res.spectra[v], q))
    say("16", f"sweep main path in the {other} form: launches "
              f"{counts_o['chunk_steps_batch']} chunk_steps_batch by form "
              f"{forms_o}, nothing else, {res_o.wall_time_s:.3f} s; steps, "
              f"e_ratio and every variant's uf and if_ == the {plan.form} "
              f"run's at rtol {RTOL}, atol {ATOL_REL}*max [{card}]")

    # one launch of each form at the main path's shapes against the twin
    _ops, base, wf, bufs = batch_inputs(sim, B, seed=113, n_sub=n_sub)
    b, bufs_b = clone_batch(base), bufs.clone()
    ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    ev0.record()
    fdtd_cuda.chunk_steps_batch_plain(bops, b, wf, 7, n_sub, D, bufs_b,
                                      [True] * B)
    ev1.record()
    ev1.synchronize()
    plain_ms = ev0.elapsed_time(ev1)
    ref = batch_current(b, bufs_b)
    del b, bufs_b
    check = {}
    for form in ("streamed", "marched"):
        a, bufs_a = clone_batch(base), bufs.clone()
        fdtd_cuda.chunk_steps_batch(bops, a, wf, 7, n_sub, D, bufs_a,
                                    [True] * B, form=form)
        got = batch_current(a, bufs_a)
        check[form] = (
            max(close(f"chunk_steps_batch {form} sweep {i}", x, y)
                for i, (x, y) in enumerate(zip(got, ref))),
            all(torch.equal(x, y) for x, y in zip(got, ref)))
        del a, bufs_a, got
    del ref
    steps = n_sub * D
    b_ms, b_by = k1_batch_bound(bops, B, n_sub, D)
    times = {}
    a, bufs_a = clone_batch(base), bufs.clone()
    times["streamed"] = [device_ms(lambda: fdtd_cuda.chunk_steps_batch(
        bops, a, wf, 7, n_sub, D, bufs_a, [True] * B, form="streamed"),
        reps=3, warmup=1) for _ in range(2)]
    times["marched"] = [device_ms(lambda: fdtd_cuda.chunk_steps_batch(
        bops, a, wf, 7, n_sub, D, bufs_a, [True] * B, form="marched"),
        reps=3, warmup=1) for _ in range(2)]
    del a, bufs_a, base
    # K2's batched march (stream mode's kernel) on the same grid at T = 4
    T2 = 4
    st2 = stream_batch_state(sim, B, 117)
    wf2 = [0.37, -0.21, 0.55, 0.13][:T2]
    k2_ms = [device_ms(lambda: fdtd_stream.stream_steps_batch(
        bops, st2, wf2, [True] * B), reps=10, warmup=2) for _ in range(2)]
    del st2
    k2b_ms, k2b_by = k2_batch_bound(bops, T2, B)
    mT = plans["marched"].T
    march_bytes_ms = n_sub * plans["marched"].rounds(D) * k2_batch_bound(
        bops, mT, B)[0]

    def us(ts):
        return " / ".join(f"{t * 1e3:,.1f}" for t in ts)

    for form in ("streamed", "marched"):
        err, same = check[form]
        ms = min(times[form])
        extra = "" if form == "streamed" else (
            f"; the march's bytes, {n_sub} x {plans['marched'].rounds(D)} "
            f"rounds of T={mT} each moving its fields, ca/cb and stamps "
            f"once: {march_bytes_ms * 1e3:,.1f} us ({march_bytes_ms / ms:.3f} "
            f"of it)")
        say("16", f"chunk_steps_batch {form} at the sweep's shapes (B={B}, "
                  f"{n_sub} x D={D}), {plan_text(plans[form])}: == plain "
                  f"(bit-equal {same}), max |err| {err:.3e}; device "
                  f"{us(times[form])} us/launch ({ms * 1e3 / steps:.2f} us a "
                  f"step of {B} variants, {ms * 1e3 / steps / B:.2f} us a "
                  f"variant-step); plain {plain_ms * 1e3:,.1f} us; bound "
                  f"{b_ms * 1e3:.2f} us by {b_by} ({b_ms / ms:.4f} of it)"
                  f"{extra} [{card}]")
    say("16", f"K2's batched march (stream_steps_batch) on the same grid, "
              f"T={T2}: {us(k2_ms)} us/launch ({min(k2_ms) * 1e3 / T2:.2f} us "
              f"a step of {B} variants), bound {k2b_ms * 1e3:.1f} us by "
              f"{k2b_by} ({k2b_ms / min(k2_ms):.3f} of it) [{card}]")
    faster = min(times["marched"]) < min(times["streamed"])
    say("16", f"the marched form is {'faster' if faster else 'slower'} than "
              f"the streamed form in this call "
              f"({min(times['marched']) / min(times['streamed']):.2f}x its "
              f"time); the plan picks the {plan.form} form [{card}]")
    assert plan.form != "marched" or faster, (
        "the plan picks the marched form where it is the slower")

    # the batched run against eight unbatched chunk_steps runs, in turns
    walls = {"batched": [res.wall_time_s, res2.wall_time_s], "unbatched": []}
    sims = [dataclasses.replace(sim, operands=fdtd_cuda.variant_operands(bops, v))
            for v in range(B)]
    single_counts = None
    for turn in range(2):
        fdtd_cuda.reset_launch_counts()
        total = 0.0
        for v, sim_v in enumerate(sims):
            out, t = timed_run(sim_v, fdtd_cuda.kernels)
            total += t
            if turn == 0:
                assert out["steps"] == res.steps_run, (out["steps"], res.steps_run)
                close(f"unbatched variant {v} uf", out["uf"][0],
                      res.spectra[v].uf / sim.dft_dt)
        single_counts = single_counts or dict(fdtd_cuda.launches)
        walls["unbatched"].append(total)
        res3 = run_patch_geometry_sweep(prep)
        assert res3.ok, res3.message
        walls["batched"].append(res3.wall_time_s)
    assert single_counts["chunk_steps"] == B * chunks, single_counts
    ms = min(times[plan.form])
    busy = chunks * ms / 1e3
    rate = [cells * res.steps_run * B / t / 1e6 for t in walls["batched"]]
    say("16", f"sweep main path: {B} variants x {res.steps_run} steps "
              f"({SWEEP_STEPS} asked) in "
              f"{' / '.join(f'{t:.3f}' for t in walls['batched'])} s (the "
              f"counted run, then reruns), aggregate "
              f"{' / '.join(f'{r:.1f}' for r in rate)} Mcell-updates/s; "
              f"launches {counts['chunk_steps_batch']} chunk_steps_batch by "
              f"form {forms}, busy {busy:.3f} s (launches x device time), idle "
              f"share {idle_text(walls['batched'], busy)}; eight distinct "
              f"spectra, f_res {np.round(res.f_res_hz / 1e9, 4).tolist()} GHz, "
              f"|S11|min {np.round(res.s11_min_db, 2).tolist()} dB [{card}]")
    say("16", f"the same {B} variants as {B} unbatched chunk_steps runs "
              f"({single_counts['chunk_steps']} launches, uf == the batched "
              f"run's): {' / '.join(f'{t:.3f}' for t in walls['unbatched'])} s "
              f"against the batched {walls['batched'][2]:.3f} / "
              f"{walls['batched'][3]:.3f} s in the same turns "
              f"({walls['unbatched'][0] / walls['batched'][2]:.2f}x / "
              f"{walls['unbatched'][1] / walls['batched'][3]:.2f}x) [{card}]")
    err = check[plan.form][0]
    if plan.form == "marched":
        err = max(err, marched_err)
    return dict(launches=counts["chunk_steps_batch"], max_abs_err=err,
                ms=min(times[plan.form]), plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, form=plan.form, res=res,
                walls=walls["batched"])


def sweep_chunk_row(prep, card, tag):
    """One ``chunk_steps_batch`` chunk of a prepared sweep in the form its
    plan picks, from a seeded random state of its own batched operands,
    against the twin (each variant's current fields and samples), then
    timed on the device beside its bound and the twin's time: the kernels
    line's numbers for that form at the sweep's shapes."""
    from fdtd_solver_antennas_tpu_torch.ops import fdtd_cuda
    from fdtd_solver_antennas_tpu_torch.ops.fdtd import chunk_geometry

    sim = prep.sim
    bops = sweep_operands(prep)
    B = int(bops.ca[0].shape[0])
    D, n_sub, _, _ = chunk_geometry(sim)
    _ops, base, wf, bufs = batch_inputs(sim, B, seed=131, n_sub=n_sub)
    plan = fdtd_cuda.chunk_launch_plan(bops, base)
    b, bufs_b = clone_batch(base), bufs.clone()
    ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    ev0.record()
    fdtd_cuda.chunk_steps_batch_plain(bops, b, wf, 7, n_sub, D, bufs_b,
                                      [True] * B)
    ev1.record()
    ev1.synchronize()
    plain_ms = ev0.elapsed_time(ev1)
    a, bufs_a = clone_batch(base), bufs.clone()
    fdtd_cuda.chunk_steps_batch(bops, a, wf, 7, n_sub, D, bufs_a, [True] * B)
    got, ref = batch_current(a, bufs_a), batch_current(b, bufs_b)
    err = max(close(f"{tag} chunk_steps_batch {i}", x, y)
              for i, (x, y) in enumerate(zip(got, ref)))
    same = all(torch.equal(x, y) for x, y in zip(got, ref))
    del b, bufs_b, got, ref
    ms = [device_ms(lambda: fdtd_cuda.chunk_steps_batch(
        bops, a, wf, 7, n_sub, D, bufs_a, [True] * B), reps=5, warmup=1)
        for _ in range(2)]
    b_ms, b_by = k1_batch_bound(bops, B, n_sub, D)
    say("26", f"{tag}: chunk_steps_batch at its shapes ({sim.grid.shape}, "
              f"B={B}, {n_sub} x D={D}), {plan_text(plan)}: == plain "
              f"(bit-equal {same}), max |err| {err:.3e}; device "
              f"{' / '.join(f'{t * 1e3:,.1f}' for t in ms)} us/launch; plain "
              f"{plain_ms * 1e3:,.1f} us; bound {b_ms * 1e3:.2f} us by {b_by} "
              f"({b_ms / min(ms):.4f} of it) [{card}]")
    return dict(form=plan.form, max_abs_err=err, ms=min(ms), plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by)


def cavity_f_hz(w_mm: float) -> float:
    """``tests/test_sweep.py``'s cavity-model fundamental of the fed W."""
    from fdtd_solver_antennas_tpu_torch.physics import C0, delta_L, effective_eps

    w = w_mm * 1e-3
    eps_eff = effective_eps(4.3, 1.6e-3, w)
    w_eff = w + 2 * delta_L(eps_eff, 1.6e-3, w)
    return C0 / (2 * w_eff * np.sqrt(eps_eff))


def phase_sweep_physics(card):
    """``tests/test_sweep.py``'s two patches (6,000 steps) against the
    cavity model, and its two 12 GHz horn apertures against their gain."""
    from fdtd_solver_antennas_tpu_torch.models.params import (
        HornAntennaParams, PatchAntennaParams)
    from fdtd_solver_antennas_tpu_torch.solvers.sweep import (
        prepare_horn_aperture_sweep, prepare_patch_geometry_sweep,
        run_horn_aperture_sweep, run_patch_geometry_sweep)

    geoms = [(26.0, 33.0), (32.0, 41.0)]  # (L_mm, W_mm); W is the fed x-dim
    prep = prepare_patch_geometry_sweep(
        [PatchAntennaParams.from_user_units(frequency_ghz=2.45, er=4.3,
                                            h_mm=1.6, L_mm=L, W_mm=W)
         for L, W in geoms], n_steps_max=6000, device="cuda")
    assert prep.ok, prep.message
    res = run_patch_geometry_sweep(prep)
    assert res.ok, res.message
    dips = []
    for (_L, W), sp in zip(geoms, res.spectra):
        f_pred = cavity_f_hz(W)
        db = 20 * np.log10(np.abs(sp.s11) + 1e-30)
        win = (sp.freq_hz > 0.85 * f_pred) & (sp.freq_hz < 1.15 * f_pred)
        assert win.any(), f"prediction {f_pred / 1e9:.2f} GHz out of band"
        i = int(np.argmin(np.where(win, db, 0.0)))
        rel = abs(sp.freq_hz[i] - f_pred) / f_pred
        assert db[i] < -8.0, f"W {W} mm: dip {db[i]:.2f} dB not below -8"
        assert rel < 0.08, (f"W {W} mm: dip at {sp.freq_hz[i] / 1e9:.4f} GHz, "
                            f"{rel:.1%} from the cavity model")
        dips.append((W, sp.freq_hz[i], db[i], f_pred, rel))
    assert dips[0][1] > dips[1][1], "the bigger patch does not resonate lower"
    say("16", f"patch sweep {prep.sim.grid.shape}, steps {res.steps.tolist()}: "
              + "; ".join(f"W {W} mm dip {f / 1e9:.4f} GHz at {d:.2f} dB, cavity "
                          f"model {fp / 1e9:.4f} GHz ({r:.2%} off)"
                          for W, f, d, fp, r in dips)
              + f"; run {res.wall_time_s:.3f} s [{card}]")

    base = HornAntennaParams.from_user_units(
        frequency_ghz=12.0, throat_a_mm=19.05, throat_b_mm=9.525,
        aperture_A_mm=48.0, aperture_B_mm=36.0, length_mm=40.0)
    apertures = [(30.0, 24.0, 30.0), (55.0, 42.0, 45.0)]
    hprep = prepare_horn_aperture_sweep(base, apertures, mesh_ppw=11.0,
                                        n_steps_max=5000, device="cuda")
    assert hprep.ok, hprep.message
    hres = run_horn_aperture_sweep(hprep)
    assert hres.ok, hres.message
    d0, d1 = hres.Dmax_dbi
    assert d1 > d0 + 2.0, f"Dmax {d0:.2f} -> {d1:.2f} dBi: not 2 dB more"
    assert 5.0 < d0 < 20.0 and 8.0 < d1 < 22.0, (d0, d1)
    say("16", f"horn sweep {hprep.sim.grid.shape}, apertures {apertures}: Dmax "
              f"{d0:.3f} / {d1:.3f} dBi, steps {hres.steps.tolist()}, run "
              f"{hres.wall_time_s:.3f} s [{card}]")


def tall_z_scene(nx=16):
    """The z = 131 scene of tests/_explicit_ranks.py (Pz > 128: K2's slab
    stepper), ``tall_z`` on 16 x lines; on 13 (``tall_straddle``) the top
    MUR wall, row 12, is the last rank's first row at 4 ranks (Px = 16,
    n = 4)."""
    from fdtd_solver_antennas_tpu_torch.models.scene import Scene
    from fdtd_solver_antennas_tpu_torch.ops.mesh import MeshBuilder

    mb = MeshBuilder()
    mb.add_line("x", np.linspace(0, nx - 1, nx))
    mb.add_line("y", np.linspace(0, 15, 16))
    mb.add_line("z", np.linspace(0, 130, 131))
    grid = mb.build(1.0)
    c = (nx - 1) // 2
    scene = Scene()
    scene.add_material_box("sub", 4.3, 0.005, [c - 4, 4, 60], [c + 4, 11, 64], 0)
    scene.add_metal_box("patch", [c - 3, 6, 64], [c + 3, 10, 64], priority=10)
    scene.add_metal_box("gnd", [c - 4, 4, 60], [c + 4, 11, 60], priority=10)
    scene.add_lumped_port(1, 50.0, [c, 8, 60], [c, 8, 64], direction="z")
    return scene, grid, 2.45e9, 1.225e9


def tall_straddle_scene():
    return tall_z_scene(13)


def slab_state(sh, seed):
    """A state of slab ``sh`` from a seeded normal draw (numpy), each ψ 0
    outside its slab."""
    rng = np.random.default_rng(seed)
    st = sh.new_state()
    for t in (*st.e[0], *st.e[1], *st.h, *st.psi_e, *st.psi_h):
        t.copy_(torch.from_numpy(rng.standard_normal(t.shape).astype(np.float32)))
    psi_to_slabs(sh.ops, st)
    return st


def segment_end_blocks(sh):
    """A count of resident blocks (``march_plan``'s ``blocks``) whose x cut
    ends a segment on the slab's upper wall (the JAX package's
    face-on-block-end regression)."""
    from fdtd_solver_antennas_tpu_torch.ops import fdtd_stream

    v0, _x_lo, x_hi = fdtd_stream.march_view(sh.ops)
    shape = (sh.ops.shape[0] - v0, *sh.ops.shape[1:])
    assert x_hi > 0, "the slab holds no upper wall"
    for blocks in range(1, 4096):
        _, _, _, (seg, so, segs), _ = fdtd_stream.march_plan(
            shape, sh.ops.grid_shape, sh.K, True, x_hi, blocks)
        if any(max(0, b * seg - so) == x_hi + 1 for b in range(segs)):
            return blocks
    raise AssertionError("no cut ends a segment on the upper wall")


def phase_slab_vs_plain(mixed, k2, card):
    """K2's slab stepper against its twin: one launch on a seeded random
    slab state per case, owned rows compared: z = 131 slabs at one rank
    (MUR T and remainder windows, PEC, PML_4); rank 0, an interior rank
    (its lower halo's first row the lower wall) and the last rank (the
    straddle) of a 4-way split, and the upper wall on an x segment's last
    plane; PEC and PML_4 on interior ranks; the mixed scene's one-rank
    slab, timed beside its bound and the single-card march."""
    from fdtd_solver_antennas_tpu_torch.ops import fdtd_cuda, fdtd_shard, fdtd_stream

    cases = (  # (label, scene, boundary, ranks, rank, decim, window, cut)
        ("z131", tall131_scene, "MUR", 1, 0, 9, "T", None),
        ("z131", tall131_scene, "MUR", 1, 0, 9, "rem", None),
        ("z131", tall131_scene, "PEC", 1, 0, 9, "T", None),
        ("tall z", tall_z_scene, "PML_4", 1, 0, 10, "T", None),
        ("tall z", tall_z_scene, "PML_4", 1, 0, 10, "rem", None),
        ("tall z", tall_z_scene, "PML_4", 4, 1, 10, "T", None),
        ("tall z", tall_z_scene, "PEC", 4, 2, 10, "rem", None),
        ("tall straddle", tall_straddle_scene, "MUR", 4, 0, 4, "T", None),
        ("tall straddle", tall_straddle_scene, "MUR", 4, 1, 4, "T", None),
        ("tall straddle", tall_straddle_scene, "MUR", 4, 2, 4, "T", "segment end"),
        ("tall straddle", tall_straddle_scene, "MUR", 4, 3, 4, "T", None),
        ("tall straddle", tall_straddle_scene, "MUR", 4, 3, 4, "rem", None),
        ("mixed", None, "MUR", 1, 0, None, "T", None),
    )
    worst = {"MUR/PEC": 0.0, "CPML": 0.0}
    timed = None
    for label, make, boundary, n_dev, rank, decim, window, cut in cases:
        sim = mixed if make is None else shard_sim(make, boundary, n_dev, decim)
        sh = fdtd_stream.build_stream_shard_stepper(sim, n_dev, rank)
        k = sh.K if window == "T" else sh.rem
        assert k >= 1, (label, window, sh.K, sh.rem)
        route = "shard_march"
        kind = "CPML" if sh.ops.pml is not None else "MUR/PEC"
        base = slab_state(sh, 29 + rank)
        wf = list(np.random.default_rng(31 + rank).uniform(-1.0, 1.0, k))
        sp = clone_state(base)
        fdtd_shard.shard_steps_plain(sh.ops, sp, wf)
        sk = clone_state(base)
        blocks = segment_end_blocks(sh) if cut else None
        fdtd_stream.reset_launch_counts()
        fdtd_stream.stream_shard_steps(sh.ops, sk, wf, blocks)
        torch.cuda.synchronize()
        assert fdtd_stream.launches_by_kernel[route] == 1, dict(
            fdtd_stream.launches_by_kernel)
        pairs = list(zip(fields_of(sk), fields_of(sp)))
        err = max(close(f"{label} stream_shard_steps {i}", a[sh.owned], b[sh.owned])
                  for i, (a, b) in enumerate(pairs))
        same = all(torch.equal(a[sh.owned], b[sh.owned]) for a, b in pairs)
        worst[kind] = max(worst[kind], err)
        view = fdtd_stream.march_view(sh.ops)
        extra = (f", x segments cut for {blocks} blocks to end on the upper "
                 f"wall" if cut else "")
        if label == "mixed":
            ms = device_ms(lambda: fdtd_stream.stream_shard_steps(sh.ops, sk, wf),
                           reps=10)
            spare = clone_state(sp)
            plain_ms = events_ms(
                lambda: fdtd_shard.shard_steps_plain(sh.ops, spare, wf),
                reps=2, warmup=1)
            del spare
            b_ms, b_by = k2_slab_bound(sh, k)
            out = torch.zeros(sh.ops.probes.n_rows, device=mixed.device)
            probe_ms = device_ms(lambda: fdtd_cuda.probe_gather(sh.ops, sk, out))
            timed = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                         probe_ms=probe_ms)
            extra += (f"; device {ms * 1e3:.1f} us/launch ({ms * 1e3 / k:.1f} "
                      f"us/step), bound {b_ms * 1e3:.1f} us by {b_by} "
                      f"({b_ms / ms:.3f} of it), plain {plain_ms * 1e3:.1f} us; "
                      f"the single-card march on the {mixed.padded_shape} grid "
                      f"{k2['ms'] * 1e3:.1f} us/launch (phase 8), bound "
                      f"{k2['bound_ms'] * 1e3:.1f} us; probe_gather on the slab "
                      f"table {probe_ms * 1e3:.2f} us")
        say("17", f"{label} {sim.grid.shape} {boundary}, {n_dev} rank(s), rank "
                  f"{rank}: slab {sh.ops.shape}, T={sh.K} W={sh.W} rem={sh.rem}, "
                  f"window {k}, {route} on view (v0, x_lo, x_hi) {view}{extra}: "
                  f"== plain on owned rows (bit-equal {same}), max |err| "
                  f"{err:.3e} [{card}]")
        del base, sk, sp, pairs
    return dict(max_abs_err=worst["MUR/PEC"], cpml_err=worst["CPML"], **timed)


def phase_explicit_large_main_path(mixed, mixed_res, k2, k17, card):
    """The explicit slice at Pz > 128: phase 8's prepared mixed scene
    through ``build_explicit_run`` on one card, to its stop, and its
    post-processing; only the slab march may launch. Then 2,000 steps of
    it against 2,000 steps of the single-card stream run."""
    from fdtd_solver_antennas_tpu_torch.ops import fdtd_cuda, fdtd_shard, fdtd_stream
    from fdtd_solver_antennas_tpu_torch.ops.fdtd import run_simulation
    from fdtd_solver_antennas_tpu_torch.parallel import build_explicit_run
    from fdtd_solver_antennas_tpu_torch.solvers.multi_patch_3d import (
        run_prepared_multi_patch_3d)

    run = build_explicit_run(mixed)
    sh = run.stepper
    outs = []

    def explicit():
        outs.append(run())
        return outs[-1]

    fdtd_cuda.reset_launch_counts()
    fdtd_shard.reset_launch_counts()
    fdtd_stream.reset_launch_counts()
    res = run_prepared_multi_patch_3d(k2["prep"], frequency_hz=k2["f_run"],
                                      verbose=0, run=explicit)
    counts = {**fdtd_cuda.launches, **fdtd_shard.launches,
              **fdtd_stream.launches, **fdtd_stream.launches_by_kernel}
    assert res.ok, res.message
    out = outs[0]
    steps, D, T = int(out["steps"]), mixed.probe_decim, sh.K
    intervals = steps // D
    per_interval = D // T + (D % T > 0)
    assert steps % D == 0, (steps, D)
    assert counts["shard_march"] == intervals * per_interval, counts
    assert counts["stream_shard_steps"] == counts["shard_march"], counts
    assert counts["probe_gather"] == intervals, counts
    for name in ("stream_march", "stream_march_batch", "stream_steps",
                 "shard_steps", "chunk_steps", "chunk_steps_batch", "h_update",
                 "e_update", "mur_faces"):
        assert counts[name] == 0, (name, counts)
    e_ratio = res.diagnostics["energy_ratio"]
    assert steps < mixed.cfg.n_steps_max and e_ratio < mixed.cfg.end_criteria, (
        steps, mixed.cfg.n_steps_max, e_ratio)
    assert steps == mixed_res.steps_run, (steps, mixed_res.steps_run)
    df = np.abs(np.diff(res.freq)).max()
    assert abs(res.f_res_hz - mixed_res.f_res_hz) <= df, (
        res.f_res_hz, mixed_res.f_res_hz)

    def s11_min_db(r):
        return [float(20 * np.log10(np.abs(s).min()))
                for s in r.diagnostics["s11_all_ports"]]

    s11, s11_ref = s11_min_db(res), s11_min_db(mixed_res)
    assert np.allclose(s11, s11_ref, atol=0.01), (s11, s11_ref)
    dmax, dmax_ref = 10 * np.log10(res.Dmax), 10 * np.log10(mixed_res.Dmax)
    assert abs(dmax - dmax_ref) <= 0.01, (dmax, dmax_ref)
    assert np.all(np.isfinite(res.intensity))
    busy = (counts["shard_march"] * k17["ms"]
            + counts["probe_gather"] * k17["probe_ms"]) / 1e3
    say("17", f"mixed explicit run: {res.wall_time_s:.3f} s wall, kernels busy "
              f"{busy:.3f} s (launches x device time per launch: slab march "
              f"{k17['ms'] * 1e3:.1f} us, probe_gather {k17['probe_ms'] * 1e3:.2f} "
              f"us), idle share {1 - busy / res.wall_time_s:.3f} [{card}]")
    say("17", f"mixed scene {mixed.grid.shape} through build_explicit_run on "
              f"{mixed.device}, one rank: slab {sh.ops.shape}, T={T} W={sh.W} "
              f"rem={sh.rem}, D={D} ({per_interval} launches an interval); "
              f"{steps} steps (stream mode, phase 8: {mixed_res.steps_run}) in "
              f"{res.wall_time_s:.3f} s, {res.mcells_per_s:.1f} Mcell-updates/s; "
              f"ended on energy ratio {e_ratio:.3e} < {mixed.cfg.end_criteria:.3e}; "
              f"f_res {res.f_res_hz / 1e9:.4f} GHz (phase 8 "
              f"{mixed_res.f_res_hz / 1e9:.4f}), |S11|min per port "
              f"{s11[0]:.3f} / {s11[1]:.3f} dB (phase 8 {s11_ref[0]:.3f} / "
              f"{s11_ref[1]:.3f}), Dmax {dmax:.4f} dBi (phase 8 {dmax_ref:.4f}); "
              f"launches {counts} [{card}]")

    cut = dataclasses.replace(
        mixed, cfg=dataclasses.replace(mixed.cfg, n_steps_max=2000))
    eo = build_explicit_run(cut)()
    so = run_simulation(cut, fdtd_stream.kernels)
    err = compare_runs(eo, so, "explicit vs stream, 2000 steps")
    same = all(torch.equal(a, b) for a, b in zip(eo["fields"], so["fields"]))
    say("17", f"mixed scene, {eo['steps']} steps: explicit (slab march) == "
              f"single-card stream run (uf, if_, nf_e, nf_h, fields; fields "
              f"bit-equal {same}), max |err| {err:.3e} [{card}]")
    return res, counts


# The 3-D tile kernel that carried CPML before the march did, µs per
# launch on an NVIDIA H100 80GB HBM3 at 700.00 W (PERF.md): the tall PML_8
# slab through the slab stepper and the batched PML_8 sweep, T = 4.
TILE_US = {"tall slab": (2851.6, 2873.2), "sweep": (3828.4, 3832.2)}


def phase_slab_cpml(card):
    """The CPML route of K2's slab stepper: the tall grid under PML_8
    through ``build_explicit_run`` on one card for 480 steps (launch
    counts; held to the single-card stream run), then one slab-march
    launch against its twin, timed beside its bound, the single-card march
    (``stream_steps``) on the same grid at the same T and the tile
    kernel's time that the route had before."""
    from fdtd_solver_antennas_tpu_torch.ops import fdtd_cuda, fdtd_shard, fdtd_stream
    from fdtd_solver_antennas_tpu_torch.parallel import build_explicit_run

    sim = shard_sim(tall_scene, "PML_8", 1, 48)
    run = build_explicit_run(sim)
    sh = run.stepper
    fdtd_cuda.reset_launch_counts()
    fdtd_shard.reset_launch_counts()
    fdtd_stream.reset_launch_counts()
    eo = run()
    counts = {**fdtd_shard.launches, **fdtd_stream.launches_by_kernel,
              "probe_gather": fdtd_cuda.launches["probe_gather"]}
    T, D = sh.K, sim.probe_decim
    per_interval = D // T + (D % T > 0)
    assert counts["shard_march"] == eo["steps"] // D * per_interval, counts
    assert counts["shard_steps"] == counts["stream_march"] == 0, counts
    so = sim.run()
    err = compare_runs(eo, so, "tall PML_8 explicit vs stream")
    say("17", f"tall {sim.grid.shape} PML_8 through build_explicit_run, one "
              f"rank: slab {sh.ops.shape}, T={T} W={sh.W}; {eo['steps']} steps "
              f"== single-card run ({sim.pallas_mode}, T={sim.stream_T}; uf, "
              f"if_, nf_e, nf_h, fields, psi), max |err| {err:.3e}; launches "
              f"{counts} [{card}]")
    del eo, so
    base = slab_state(sh, 37)
    wf = list(np.random.default_rng(41).uniform(-1.0, 1.0, T))
    sp, sk = clone_state(base), clone_state(base)
    del base
    fdtd_shard.shard_steps_plain(sh.ops, sp, wf)
    fdtd_stream.stream_shard_steps(sh.ops, sk, wf)
    torch.cuda.synchronize()
    err = max(close(f"slab march {i}", a[sh.owned], b[sh.owned])
              for i, (a, b) in enumerate(zip(fields_of(sk), fields_of(sp))))
    same = all(torch.equal(a[sh.owned], b[sh.owned])
               for a, b in zip(fields_of(sk), fields_of(sp)))
    ms = device_ms(lambda: fdtd_stream.stream_shard_steps(sh.ops, sk, wf), reps=10)
    plain_ms = events_ms(lambda: fdtd_shard.shard_steps_plain(sh.ops, sp, wf),
                         reps=2, warmup=1)
    del sk, sp
    # the single-card march on the whole grid, same T
    whole = random_state(sim, seed=43)
    one_ms = device_ms(lambda: fdtd_stream.stream_steps(sim.operands, whole, wf),
                       reps=10)
    del whole
    b_ms, b_by = k2_slab_bound(sh, T)
    a_ms = k2_slab_bound(sh, T, all_psi=True)[0]
    one_b_ms, _ = k2_bound(sim.operands, T)
    old = TILE_US["tall slab"]
    say("17", f"slab march (CPML), tall {sim.grid.shape} PML_8 slab "
              f"{sh.ops.shape}, T={T}: == plain on owned rows, max |err| "
              f"{err:.3e} (bit-equal {same}); device {ms * 1e3:.1f} us/launch "
              f"({ms * 1e3 / T:.1f} us/step), bound {b_ms * 1e3:.1f} us by "
              f"{b_by} ({b_ms / ms:.3f} of it; moving all twelve psi "
              f"everywhere {a_ms * 1e3:.1f} us, {a_ms / ms:.3f}), plain "
              f"{plain_ms * 1e3:.1f} us; "
              f"the tile kernel before it {old[0]:,.1f}-{old[1]:,.1f} us "
              f"(PERF.md, not measured here); the "
              f"single-card march (stream_steps) on the {sim.padded_shape} "
              f"grid at T={T} {one_ms * 1e3:.1f} us/launch (bound "
              f"{one_b_ms * 1e3:.1f} us, {one_b_ms / one_ms:.3f} of it) [{card}]")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, launches=counts["shard_march"], one_ms=one_ms)


K2_COEF_REPLACES = "fdtd_solver_antennas_tpu/ops/fdtd_pallas.py:1320"


def k2_batch_bound(ops, T, batch, all_psi=False):
    """Bound of one ``stream_steps_batch`` launch with every variant
    stepping: per variant its fields in and out once, its ca/cb in once and
    its ψ as ``psi_cells`` counts them, the shared source stamps in once;
    per variant T steps of H and E updates, as ``k2_bound`` counts them
    (``k2_bound`` × B but for the stamps, read once)."""
    n = int(np.prod(ops.shape))
    n_src = sum(s is not None for s in ops.src)
    psi = psi_cells(ops, (0, ops.shape[0]), all_psi)
    nbytes = 4 * n * (batch * (6 + 6 + 6) + n_src) + batch * 8 * psi
    return bound(nbytes, batch * T * (48 * n + 4 * psi))


def gather_batch_bound(ops, batch):
    """Bound of one ``probe_gather_batch`` launch with every variant
    sampled: the used entries' codes and weights in once, each variant's
    field value of every used entry in and its rows out once; 2
    operations per used entry per variant."""
    rows = ops.probes.n_rows
    used = int(torch.count_nonzero(ops.probes.w))
    return bound(8 * used + batch * (4 * used + 4 * rows), batch * 2 * used)


def stream_batch_state(sim, batch, seed):
    """A seeded random batch state (fields and ψ, each ψ 0 outside its
    slab) at E buffer 1, H set 0, on the card."""
    from fdtd_solver_antennas_tpu_torch.ops import fdtd_cuda

    rng = np.random.default_rng(seed)
    st = fdtd_cuda.new_batch_state(sim.padded_shape, sim.device,
                                   sim.operands.pml is not None, batch)
    for t in batch_tensors(st):
        t.copy_(torch.from_numpy(rng.standard_normal(t.shape).astype(np.float32)))
    psi_to_slabs(sim.operands, st)
    st.parity = [1] * batch
    return st


def stream_batch_current(st):
    """Each variant's current fields and ψ, from its own E buffer and set."""
    out = []
    for b in range(st.batch):
        v = st.variant(b)
        out += [*v.fields, *v.psi_e, *v.psi_h]
    return out


def phase_stream_batch_vs_plain(card):
    """``stream_steps_batch`` against ``stream_steps_batch_plain`` at the
    8-variant sweep's shapes: one launch of the batched march under MUR
    and one under CPML (the same sweep prepared with PML_8), each on a
    seeded random state with variant 3 frozen, every variant's fields and
    ψ compared and the frozen one bit-unchanged; each launch timed with
    every variant stepping beside its bound, the twin and (PML_8) the tile
    kernel's time that the route had before. The PML_8 sweep then runs one
    chunk through ``run_patch_geometry_sweep`` (its launches counted; not
    to its end). Then B = 1 against ``stream_steps`` on the same state,
    bit for bit."""
    from fdtd_solver_antennas_tpu_torch.ops import fdtd_cuda, fdtd_stream
    from fdtd_solver_antennas_tpu_torch.solvers.sweep import (
        prepare_patch_geometry_sweep, run_patch_geometry_sweep)

    variants = sweep_variants()
    B = len(variants)
    rows = {}
    for boundary, seed in (("MUR", 151), ("PML_8", 157)):
        prep = prepare_patch_geometry_sweep(
            variants, n_steps_max=SWEEP_STEPS if boundary == "MUR" else 1,
            boundary=boundary, pallas_mode="stream", device="cuda")
        assert prep.ok, prep.message
        sim, ops = prep.sim, sweep_operands(prep)
        T = sim.stream_T
        wf = [0.37, -0.21, 0.55, 0.13, 0.4, -0.3, 0.2, 0.1][:T]
        march = ops.pml is None
        route = "stream_march_batch"
        base = stream_batch_state(sim, B, seed)
        a, b = clone_batch(base), clone_batch(base)
        mask = [v != 3 for v in range(B)]
        fdtd_stream.reset_launch_counts()
        fdtd_stream.stream_steps_batch(ops, a, wf, mask)
        assert fdtd_stream.launches_by_kernel[route] == 1, dict(
            fdtd_stream.launches_by_kernel)
        fdtd_stream.stream_steps_batch_plain(ops, b, wf, mask)
        torch.cuda.synchronize()
        got, ref = stream_batch_current(a), stream_batch_current(b)
        err = max(close(f"stream_steps_batch {boundary} {i}", x, y)
                  for i, (x, y) in enumerate(zip(got, ref)))
        same = all(torch.equal(x, y) for x, y in zip(got, ref))
        untouched = (all(torch.equal(t[3], t0[3]) for t, t0 in
                         zip(batch_tensors(a), batch_tensors(base)))
                     and all(int(torch.count_nonzero(t[3])) == 0
                             for t in (*a.h1, *a.psi_e1, *a.psi_h1))
                     and (a.parity[3], a.hset[3]) == (1, 0))
        assert untouched, "stream_steps_batch wrote a frozen variant"
        del got, ref, a
        on = [True] * B  # timed with every variant stepping, from base
        ms = device_ms(lambda: fdtd_stream.stream_steps_batch(ops, base, wf, on),
                       reps=10, warmup=2)
        plain_ms = events_ms(
            lambda: fdtd_stream.stream_steps_batch_plain(ops, b, wf, on),
            reps=2, warmup=1)
        del base, b
        b_ms, b_by = k2_batch_bound(ops, T, B)
        a_ms = k2_batch_bound(ops, T, B, all_psi=True)[0]
        k2_ms = k2_bound(sim.operands, T)[0]
        core, _o, mt, (seg, _so, segs), smem = fdtd_stream.march_plan(
            ops.shape, ops.grid_shape, T, ops.mur is not None, batch=B,
            pml=not march)
        plan = (f"march{'' if march else ' (CPML)'}: {mt[0] * mt[1] * segs} "
                f"blocks a variant, {B * mt[0] * mt[1] * segs} a launch "
                f"({mt[0]}x{mt[1]} tiles of {core[0]}x{core[1]}, {segs} x "
                f"segments of {seg}), {smem} B dynamic shared memory")
        old = "" if march else (
            f"; the tile kernel before it {TILE_US['sweep'][0]:,.1f}-"
            f"{TILE_US['sweep'][1]:,.1f} us (PERF.md, not measured here)")
        cells = int(np.prod(ops.shape))
        say("18", f"stream_steps_batch {boundary} at the sweep's grid "
                  f"{sim.grid.shape} (padded {tuple(ops.shape)}), B={B}, "
                  f"T={T}, {plan}: == plain with variant 3 frozen (untouched "
                  f"{untouched}; bit-equal {same}), max |err| {err:.3e}; "
                  f"device {ms * 1e3:,.1f} us/launch ({ms * 1e3 / T:,.1f} us a "
                  f"step of {B * cells:,} cells, "
                  f"{ms * 1e6 / T / (B * cells) * 1e3:.2f} ns per 1,000 "
                  f"cell-updates); bound {b_ms * 1e3:.1f} us by {b_by} "
                  f"({b_ms / ms:.3f} of it; k2_bound x B "
                  f"{k2_ms * B * 1e3:.1f} us"
                  f"{'' if march else f'; moving all twelve psi everywhere {a_ms * 1e3:.1f} us, {a_ms / ms:.3f}'}"
                  f"); plain {plain_ms * 1e3:,.1f} us"
                  f"{old} [{card}]")
        row = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                   bound_by=b_by, T=T)
        if march:
            row["prep"] = prep
        else:  # one chunk of the PML_8 sweep through the entry points
            fdtd_cuda.reset_launch_counts()
            fdtd_stream.reset_launch_counts()
            res = run_patch_geometry_sweep(prep)
            assert res.ok, res.message
            counts = {**fdtd_cuda.launches, **fdtd_stream.launches_by_kernel}
            assert counts[route] == res.steps_run // T > 0, counts
            assert counts["probe_gather_batch"] == res.steps_run // sim.probe_decim
            assert counts["chunk_steps_batch"] == counts["stream_march"] == 0
            assert np.isfinite(np.stack([sp.uf for sp in res.spectra])).all()
            row["launches"] = counts[route]
            say("18", f"PML_8 sweep, one chunk ({res.steps_run} steps, D="
                      f"{sim.probe_decim}): {counts[route]} {route} and "
                      f"{counts['probe_gather_batch']} probe_gather_batch "
                      f"launches, no other, in {res.wall_time_s:.3f} s [{card}]")
        rows[boundary] = row
        del prep, sim, ops

    # B = 1 against stream_steps at the sweep's shapes, bit for bit
    prep = rows["MUR"]["prep"]
    sim, T = prep.sim, rows["MUR"]["T"]
    wf = [0.37, -0.21, 0.55, 0.13, 0.4, -0.3, 0.2, 0.1][:T]
    one = sweep_operands(prep)
    one = dataclasses.replace(one, ca=tuple(c[:1] for c in one.ca),
                              cb=tuple(c[:1] for c in one.cb))
    st1 = stream_batch_state(sim, 1, seed=163)
    v = st1.variant(0)
    ref = fdtd_cuda.YeeState(
        e=[tuple(t.clone() for t in v.e[p]) for p in range(2)],
        h=tuple(t.clone() for t in v.h), parity=1)
    fdtd_stream.stream_steps_batch(one, st1, wf, [True])
    fdtd_stream.stream_steps(fdtd_cuda.variant_operands(one, 0), ref, wf)
    torch.cuda.synchronize()
    same = all(torch.equal(x, y) for x, y in zip(st1.variant(0).fields, ref.fields))
    assert same, "stream_steps_batch at B = 1 differs from stream_steps"
    say("18", f"B=1 at the sweep's grid: stream_steps_batch bit-equal to "
              f"stream_steps [{card}]")
    return rows


def phase_stream_sweep_main_path(k18, k1b, card):
    """The main path: ``bench.py``'s 8-variant sweep through
    ``prepare_patch_geometry_sweep(..., pallas_mode="stream")`` and
    ``run_patch_geometry_sweep``, 2,000 steps asked, MUR, not cut: only
    ``stream_march_batch`` and ``probe_gather_batch`` launches, phase 16's
    2,440 steps, eight distinct spectra, each variant's f_res and |S11|min
    phase 16's to the sweep's bound (rtol 2e-3); the wall of a run and a
    rerun beside phase 16's K1-batched walls, the idle share. Then
    ``probe_gather_batch`` at the sweep's table against its twin, bit for
    bit, timed beside its bound, the twin and one cuSPARSE SpMM."""
    from fdtd_solver_antennas_tpu_torch.ops import fdtd_cuda, fdtd_stream
    from fdtd_solver_antennas_tpu_torch.solvers.sweep import (
        prepare_patch_geometry_sweep, run_patch_geometry_sweep)

    variants = sweep_variants()
    B = len(variants)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prep = prepare_patch_geometry_sweep(variants, n_steps_max=SWEEP_STEPS,
                                        end_criteria=1e-4, pallas_mode="stream",
                                        device="cuda")
    torch.cuda.synchronize()
    prep_s = time.perf_counter() - t0
    assert prep.ok, prep.message
    sim = prep.sim
    T, D = sim.stream_T, sim.probe_decim
    assert sim.pallas_mode == "stream" and D % T == 0, sim.pallas_mode_reason
    fdtd_cuda.reset_launch_counts()
    fdtd_stream.reset_launch_counts()
    res = run_patch_geometry_sweep(prep)
    assert res.ok, res.message
    counts = {**fdtd_cuda.launches, **fdtd_stream.launches,
              **fdtd_stream.launches_by_kernel}
    ref = k1b["res"]
    steps = res.steps_run
    assert steps == ref.steps_run and (res.steps == steps).all(), (
        res.steps, ref.steps_run)
    assert counts["stream_march_batch"] == counts["stream_steps_batch"] == steps // T
    assert counts["probe_gather_batch"] == steps // D, counts
    for name, n in counts.items():
        if name not in ("stream_march_batch", "stream_steps_batch",
                        "probe_gather_batch"):
            assert n == 0, (name, counts)
    uf = np.stack([sp.uf for sp in res.spectra]) / sim.dft_dt
    assert np.isfinite(uf).all(), "non-finite port DFTs"
    for i in range(1, B):
        assert not np.allclose(uf[0], uf[i], rtol=1e-3), (
            f"variant {i} spectrum identical to variant 0: geometry broadcast")
    np.testing.assert_allclose(res.f_res_hz, ref.f_res_hz, rtol=2e-3)
    np.testing.assert_allclose(res.s11_min_db, ref.s11_min_db, rtol=2e-3)
    res2 = run_patch_geometry_sweep(prep)
    assert res2.ok, res2.message
    np.testing.assert_array_equal(
        np.stack([sp.uf for sp in res2.spectra]) / sim.dft_dt, uf)

    # the batched gather at the sweep's table
    ops = sweep_operands(prep)
    st = stream_batch_state(sim, B, seed=167)
    rows = ops.probes.n_rows
    out_k = torch.full((B, rows), float("nan"), device=sim.device)
    out_p = out_k.clone()
    on = [True] * B
    fdtd_cuda.probe_gather_batch(ops, st, out_k, on)
    fdtd_cuda.probe_gather_batch_plain(ops, st, out_p, on)
    torch.cuda.synchronize()
    g_same = torch.equal(out_k, out_p)
    assert g_same, "probe_gather_batch is not bit-equal to its twin"
    g_err = float((out_k - out_p).abs().max())
    g_ms = device_ms(lambda: fdtd_cuda.probe_gather_batch(ops, st, out_k, on))
    g_plain = events_ms(lambda: fdtd_cuda.probe_gather_batch_plain(ops, st,
                                                                   out_p, on))
    A = probe_csr(sim.operands)
    # the stack [Ex Ey Ez Hx Hy Hz] with one column a variant
    X = torch.cat([f.reshape(B, -1) for f in st.fields()], dim=1).T.contiguous()
    lib = (A @ X).T
    torch.cuda.synchronize()
    lib_err = close("probe_gather_batch vs SpMM", out_k, lib)
    g_lib = device_ms(lambda: A @ X)
    g_b_ms, g_b_by = gather_batch_bound(ops, B)
    del st, X, A

    walls = [res.wall_time_s, res2.wall_time_s]
    ms = k18["MUR"]["ms"]
    busy = (counts["stream_march_batch"] * ms
            + counts["probe_gather_batch"] * g_ms) / 1e3
    cells = sim.grid.num_cells
    rate = [cells * steps * B / t / 1e6 for t in walls]
    say("18", f"stream sweep prepared ({prep_s:.2f} s): {sim.pallas_mode_reason}, "
              f"D={D} [{card}]")
    say("18", f"stream sweep main path: {B} variants x {steps} steps "
              f"({SWEEP_STEPS} asked, phase 16's {ref.steps_run}) in "
              f"{' / '.join(f'{t:.3f}' for t in walls)} s (the counted run, "
              f"then a rerun), aggregate "
              f"{' / '.join(f'{r:.1f}' for r in rate)} Mcell-updates/s; K1 "
              f"batched in phase 16 of this call "
              f"{' / '.join(f'{t:.3f}' for t in k1b['walls'])} s; launches "
              f"{counts['stream_march_batch']} stream_march_batch, "
              f"{counts['probe_gather_batch']} probe_gather_batch, no other; "
              f"busy {busy:.3f} s ({counts['stream_march_batch']} x "
              f"{ms * 1e3:,.1f} us + {counts['probe_gather_batch']} x "
              f"{g_ms * 1e3:.2f} us), idle share {idle_text(walls, busy)}; "
              f"f_res {np.round(res.f_res_hz / 1e9, 4).tolist()} GHz, |S11|min "
              f"{np.round(res.s11_min_db, 3).tolist()} dB, == phase 16's "
              f"within rtol 2e-3 (max |df| "
              f"{np.abs(res.f_res_hz - ref.f_res_hz).max() / 1e6:.3f} MHz, max "
              f"|dS11| {np.abs(res.s11_min_db - ref.s11_min_db).max():.4f} dB) "
              f"[{card}]")
    used = int(torch.count_nonzero(ops.probes.w))
    say("18", f"probe_gather_batch at the sweep's table ({rows} rows, {used:,} "
              f"used entries, B={B}): == plain (bit-equal {g_same}); device "
              f"{g_ms * 1e3:.2f} us/launch, bound {g_b_ms * 1e3:.3f} us by "
              f"{g_b_by} ({g_b_ms / g_ms:.3f} of it), plain {g_plain * 1e3:,.1f} "
              f"us, cuSPARSE SpMM (torch sparse CSR @ ({6 * cells:,}+, {B})) "
              f"{g_lib * 1e3:.2f} us, == kernel within rtol {RTOL} (max |err| "
              f"{lib_err:.3e}) [{card}]")
    return dict(launches=counts["stream_march_batch"],
                gather=dict(launches=counts["probe_gather_batch"],
                            max_abs_err=g_err, ms=g_ms, plain_ms=g_plain,
                            bound_ms=g_b_ms, bound_by=g_b_by, library_ms=g_lib))


HORN_AUTO_PPW = 20.0  # the horn sweep's mesh whose union grid spills the L2


def phase_stream_sweep_auto(card):
    """The automatic route: the two 12 GHz horn apertures of phase 16 at
    ``mesh_ppw`` 20, whose base working set exceeds ``L2_BYTES``: the
    sweep resolves to stream with no argument and its first chunk runs on
    the batched march (``n_steps_max`` 1: one chunk, not to its end)."""
    from fdtd_solver_antennas_tpu_torch.models.params import HornAntennaParams
    from fdtd_solver_antennas_tpu_torch.ops import fdtd_cuda, fdtd_stream
    from fdtd_solver_antennas_tpu_torch.ops.fdtd import (
        L2_BYTES, working_set_bytes)
    from fdtd_solver_antennas_tpu_torch.solvers.sweep import (
        prepare_horn_aperture_sweep, run_horn_aperture_sweep)

    base = HornAntennaParams.from_user_units(
        frequency_ghz=12.0, throat_a_mm=19.05, throat_b_mm=9.525,
        aperture_A_mm=48.0, aperture_B_mm=36.0, length_mm=40.0)
    apertures = [(30.0, 24.0, 30.0), (55.0, 42.0, 45.0)]
    t0 = time.perf_counter()
    prep = prepare_horn_aperture_sweep(base, apertures, mesh_ppw=HORN_AUTO_PPW,
                                       n_steps_max=1, device="cuda")
    prep_s = time.perf_counter() - t0
    assert prep.ok, prep.message
    sim = prep.sim
    ops = sim.operands
    ws = working_set_bytes(sim.padded_shape, sum(s is not None for s in ops.src),
                           ops.pml is not None)
    assert ws > L2_BYTES and sim.pallas_mode == "stream", sim.pallas_mode_reason
    fdtd_cuda.reset_launch_counts()
    fdtd_stream.reset_launch_counts()
    res = run_horn_aperture_sweep(prep)
    assert res.ok, res.message
    counts = {**fdtd_cuda.launches, **fdtd_stream.launches_by_kernel}
    T, D = sim.stream_T, sim.probe_decim
    assert counts["stream_march_batch"] == res.steps_run // T > 0, counts
    assert counts["probe_gather_batch"] == res.steps_run // D, counts
    assert counts["chunk_steps_batch"] == 0, counts
    assert np.isfinite(np.stack([sp.uf for sp in res.spectra])).all()
    say("18", f"automatic route: horn sweep at mesh_ppw {HORN_AUTO_PPW:g}, "
              f"grid {sim.grid.shape} (padded {tuple(sim.padded_shape)}, "
              f"{int(np.prod(sim.padded_shape)):,} cells a variant), working "
              f"set {ws / 1e6:.1f} MB > L2 {L2_BYTES / 1e6:.1f} MB: "
              f"{sim.pallas_mode_reason}; one chunk of {res.steps_run} steps "
              f"(D={D}) in {res.wall_time_s:.3f} s: {counts['stream_march_batch']}"
              f" stream_march_batch, {counts['probe_gather_batch']} "
              f"probe_gather_batch, 0 chunk_steps_batch; prepare {prep_s:.1f} s "
              f"[{card}]")


TWO_PATCH_RECIP = 5e-3  # tests/test_sparams.py:104: reciprocity < 5e-3·max|S|
SUPERPOSITION = 2e-2  # tests/test_array_synth.py:135: all-on run vs synthesis
LINEAR_CHUNKS = 4  # the fixed length of the linearity runs, in chunks


def two_patch_sim():
    """tests/test_sparams.py's two-patch scene (two 12×10 mm patches on
    one ground plane, a lumped z-port at each centre; 63×20×21, 3,000
    steps asked) on the card."""
    from fdtd_solver_antennas_tpu_torch.models.scene import Scene
    from fdtd_solver_antennas_tpu_torch.ops.fdtd import FDTDConfig, build_simulation
    from fdtd_solver_antennas_tpu_torch.ops.mesh import MeshBuilder

    scene = Scene()
    scene.add_material_box("sub", 2.2, 0.0, [-30, -15, 0], [30, 15, 1.6], 0)
    scene.add_metal_box("gnd", [-30, -15, 0], [30, 15, 0], priority=10)
    for cx, name in ((-13.0, "pa"), (13.0, "pb")):
        scene.add_metal_box(
            name, [cx - 6, -5, 1.6], [cx + 6, 5, 1.6], priority=10)
    scene.add_lumped_port(1, 50.0, [-13, 0, 0], [-13, 0, 1.6], direction="z")
    scene.add_lumped_port(2, 50.0, [13, 0, 0], [13, 0, 1.6], direction="z")
    mb = MeshBuilder()
    mb.add_line("x", np.linspace(-34, 34, 35))
    mb.add_line("x", [-19.0, -13.0, -7.0, 7.0, 13.0, 19.0])
    mb.add_line("y", np.linspace(-19, 19, 20))
    mb.add_line("z", list(np.linspace(-8, 12, 11)) + [0.0, 0.8, 1.6])
    cfg = FDTDConfig(n_steps_max=3000, end_criteria=1e-5, check_every=500)
    return build_simulation(
        scene, mb.build(3.0), f0=2.45e9, fc=1.225e9, cfg=cfg, device="cuda",
        port_freqs_hz=np.linspace(2.0e9, 3.0e9, 11),
        nf_freqs_hz=np.array([2.45e9]))


class runs_recorded:
    """Within the block every ``PreparedSimulation.run`` is recorded: its
    output, steps and wall (host clock; ``run`` returns after the host
    has read the DFT sums)."""

    def __enter__(self):
        from fdtd_solver_antennas_tpu_torch.ops.fdtd import PreparedSimulation

        self.cls, self.real = PreparedSimulation, PreparedSimulation.run
        self.runs = []

        def run(sim, *args, **kw):
            t0 = time.perf_counter()
            out = self.real(sim, *args, **kw)
            self.runs.append(dict(out=out, steps=int(out["steps"]),
                                  wall=time.perf_counter() - t0))
            return out

        self.cls.run = run
        return self

    def __exit__(self, *exc):
        self.cls.run = self.real
        return False


def abort_after(n_chunks):
    """An ``abort_cb`` that stops a run after ``n_chunks`` chunks."""
    calls = [0]

    def cb():
        calls[0] += 1
        return calls[0] >= n_chunks
    return cb


def slashed(values, fmt) -> str:
    return " / ".join(format(v, fmt) for v in values)


def smatrix_text(res) -> str:
    s = res.s
    n = s.shape[0]
    peak = float(np.nanmax(np.abs(s)))
    recip = res.reciprocity_error()
    off = np.abs(s[~np.eye(n, dtype=bool)])
    diag = [20 * np.log10(np.nanmin(np.abs(s[i, i]))) for i in range(n)]
    return (f"reciprocity error {recip:.3e} = {recip / peak:.3e} of max|S| "
            f"{peak:.4f} (tests/test_sparams.py's bound: {TWO_PATCH_RECIP:g} "
            f"of it), passivity margin {res.passivity_margin():.4f}, max "
            f"coupling {20 * np.log10(np.nanmax(off)):.2f} dB, |S_ii|min "
            f"{slashed(diag, '.2f')} dB")


def runs_text(runs, busy) -> str:
    walls = [r["wall"] for r in runs]
    return (f"{len(runs)} runs of {slashed([r['steps'] for r in runs], 'd')} "
            f"steps in {slashed(walls, '.3f')} s "
            f"({slashed([w / r['steps'] * 1e6 for r, w in zip(runs, walls)], '.2f')}"
            f" us a step), idle share "
            f"{slashed([1 - b / w for b, w in zip(busy, walls)], '.3f')}")


def linear_err(runs) -> float:
    """Drive (1, 1) against (1, 0) + (0, 1): asserts the port DFT sums
    within 1e-6 of their peak (8 float32 ulps) and the fields within 1e-4
    of each component's peak (rounding over the steps, in fields far below
    the peak); returns the DFT sums' gap over their peak."""
    a, b, ab = runs
    worst = 0.0
    for key in ("uf", "if_"):
        peak = np.abs(ab[key]).max()
        gap = float(np.abs(a[key] + b[key] - ab[key]).max())
        assert gap <= 1e-6 * peak, (key, gap, peak)
        worst = max(worst, gap / peak)
    for fa, fb, fab in zip(a["fields"], b["fields"], ab["fields"]):
        gap = float((fa + fb - fab).abs().max())
        assert gap <= 1e-4 * float(fab.abs().max()), gap
    return worst


def superposition_residual(sim, eps, out, fi) -> float:
    """|E(out) − Σ w_j ê_j| / |E(out)| at row ``fi`` of ``eps.freq_hz``:
    the far field of run ``out`` against the embedded patterns weighted by
    the run's own incident waves (tests/test_array_synth.py:93)."""
    from fdtd_solver_antennas_tpu_torch.post.nf2ff import (
        nf2ff_transform, select_face_freqs)
    from fdtd_solver_antennas_tpu_torch.solvers.sparams import _port_polarities

    f = eps.freq_hz[fi]
    row = int(np.argmin(np.abs(sim.nf_freqs_hz - f)))
    ff = nf2ff_transform(
        sim.faces, select_face_freqs(out["nf_e"], row),
        select_face_freqs(out["nf_h"], row), sim.dft_dt, np.array([f]),
        np.degrees(eps.theta), np.degrees(eps.phi), device=sim.device)
    n = len(sim.ports)
    pol = _port_polarities(sim)[:, None]
    z = np.array([float(p.spec.resistance) for p in sim.ports])[:, None]
    a = (0.5 * (out["uf"][:n] * pol + z * out["if_"][:n] * pol) / np.sqrt(z)
         * sim.dft_dt)
    w = np.array([np.interp(f, sim.port_freqs_hz, a[j].real)
                  + 1j * np.interp(f, sim.port_freqs_hz, a[j].imag)
                  for j in range(n)])
    pat = eps.synthesize(w, fi=fi)
    ref = np.stack([ff.E_theta[0], ff.E_phi[0]])
    return float(np.linalg.norm(np.stack([pat.E_theta, pat.E_phi]) - ref)
                 / np.linalg.norm(ref))


def phase_two_patch_smatrix(card):
    """tests/test_sparams.py's two-patch scene through ``compute_s_matrix``
    on the card (K1), held to that test's reciprocity bound; each one-hot
    run held to the plain twins on the same drive."""
    from fdtd_solver_antennas_tpu_torch.ops import fdtd_stream
    from fdtd_solver_antennas_tpu_torch.ops.fdtd import (
        chunk_geometry, run_simulation, set_port_excitation)
    from fdtd_solver_antennas_tpu_torch.solvers.sparams import compute_s_matrix

    sim = two_patch_sim()
    with runs_recorded() as rec:
        res, counts = counted(lambda: compute_s_matrix(sim))
    assert res.ok, res.message
    assert_only(counts, {"chunk_steps"}, "two-patch S matrix")
    chunk = chunk_geometry(sim)[2]
    assert counts["chunk_steps"] == sum(r["steps"] // chunk for r in rec.runs)
    recip = res.reciprocity_error()
    assert recip < TWO_PATCH_RECIP * np.nanmax(np.abs(res.s)), recip
    err = 0.0
    for j, r in enumerate(rec.runs):
        set_port_excitation(sim, np.eye(2)[j])
        err = max(err, compare_runs(
            r["out"], run_simulation(sim, fdtd_stream.plain), f"one-hot {j}"))
    set_port_excitation(sim, [1.0, 1.0])
    row = k1_launch_alone(sim, "22", card, "two-patch")
    busy = [r["steps"] // chunk * row["ms"] / 1e3 for r in rec.runs]
    say("22", f"two-patch S matrix (tests/test_sparams.py's scene, "
              f"{sim.grid.shape}; {sim.pallas_mode_reason}): one-hot "
              f"{runs_text(rec.runs, busy)}; "
              f"{smatrix_text(res)}; each run == its plain twin on the card "
              f"(fields, uf, if_, nf_e, nf_h), max |err| {err:.3e}; launches "
              f"{ {k: v for k, v in counts.items() if v} } [{card}]")


def phase_array_main_path(card):
    """The 2×1 array of the canonical FR-4 patch at the CLI's defaults
    through ``design_array`` (two one-hot runs, ``chunk_steps`` alone),
    the all-ports-on run against the embedded patterns' superposition,
    linearity across re-excitations at a fixed step count, a checkpoint
    stopped after two chunks and resumed, and the CLI's ``array``."""
    import contextlib
    import io
    import os

    from fdtd_solver_antennas_tpu_torch import __main__ as cli
    from fdtd_solver_antennas_tpu_torch.ops import fdtd_cuda
    from fdtd_solver_antennas_tpu_torch.ops.fdtd import (
        chunk_geometry, set_port_excitation)
    from fdtd_solver_antennas_tpu_torch.post.checkpoint import load_state, save_state
    from fdtd_solver_antennas_tpu_torch.post.touchstone import read_touchstone
    from fdtd_solver_antennas_tpu_torch.solvers.array_synth import (
        compute_embedded_patterns, design_array)

    params = canonical_params()
    t0 = time.perf_counter()
    with runs_recorded() as rec:
        design, counts = counted(lambda: design_array(params, 2, 1,
                                                      device="cuda"))
    total = time.perf_counter() - t0
    forms = dict(fdtd_cuda.launches_by_form)
    assert design.ok, design.message
    sim = design.prep.sim
    assert sim.pallas_mode == "chunk", sim.pallas_mode_reason
    assert_only(counts, {"chunk_steps"}, "array 2x1")
    chunk = chunk_geometry(sim)[2]
    assert len(rec.runs) == 2
    assert counts["chunk_steps"] == sum(r["steps"] // chunk for r in rec.runs)
    row = k1_launch_alone(sim, "22", card, "array 2x1")
    busy = [r["steps"] // chunk * row["ms"] / 1e3 for r in rec.runs]
    sm, eps = design.smatrix, design.patterns
    say("22", f"array 2x1 through design_array (the canonical FR-4 patch, "
              f"pitch {design.spacing_mm:.1f} mm, margin "
              f"{design.margin_mm:.1f} mm, feed {design.feed_mm:.1f} mm, mesh "
              f"quality 3; grid {sim.grid.shape}, {sim.grid.num_cells} cells; "
              f"{sim.pallas_mode_reason}): one-hot {runs_text(rec.runs, busy)}"
              f"; launches {counts['chunk_steps']} chunk_steps (by form "
              f"{forms}), nothing else; design_array {total:.2f} s in all; "
              f"{smatrix_text(sm)} (the runs stop on their energy criterion: "
              f"a finding, not a gate); synthesis at "
              f"{eps.freq_hz[design.fi] / 1e9:.4f} GHz, resonant "
              f"{design.resonant} [{card}]")

    # the all-ports-on run: its far field is the embedded patterns'
    # superposition at the run's own incident waves where all three runs
    # have one length, as in tests/test_array_synth.py; the design's runs
    # stop on their energy criterion, each at its own step, so there the
    # residual also holds the DFTs' different truncations (printed)
    out_all, counts = counted(sim.run)
    assert counts["chunk_steps"] == out_all["steps"] // chunk
    fi, f = design.fi, eps.freq_hz[design.fi]
    resid_stop = superposition_residual(sim, eps, out_all, fi)
    n_fix = max(r["steps"] for r in rec.runs)
    fixed = dataclasses.replace(sim, cfg=dataclasses.replace(
        sim.cfg, n_steps_max=n_fix, end_criteria=0.0))
    (eps_fix, out_fix), counts = counted(lambda: (compute_embedded_patterns(
        fixed, theta_deg=np.degrees(eps.theta), phi_deg=np.degrees(eps.phi),
        freq_idx=[fi]), fixed.run()))
    assert eps_fix.ok, eps_fix.message
    assert counts["chunk_steps"] == 3 * n_fix // chunk, counts
    resid = superposition_residual(fixed, eps_fix, out_fix, 0)
    assert resid < SUPERPOSITION, resid
    say("22", f"array 2x1 all ports on: far field at {f / 1e9:.4f} GHz "
              f"against the embedded patterns weighted by the run's incident "
              f"waves: residual {resid:.3e} with the two one-hot runs and the "
              f"all-on run at {n_fix} steps each ({counts['chunk_steps']} "
              f"chunk_steps; bound {SUPERPOSITION:g}, "
              f"tests/test_array_synth.py); {resid_stop:.3e} for the design's "
              f"patterns and the all-on run to its energy stop "
              f"({out_all['steps']} steps; not gated) [{card}]")

    # linearity across re-excitations on the same preparation, at a fixed
    # step count: K1's resident form copies the stamps in at each launch
    with runs_recorded() as lin:
        for drive in ((1.0, 0.0), (0.0, 1.0), (1.0, 1.0)):
            set_port_excitation(sim, drive)
            out, counts = counted(
                lambda: sim.run(abort_cb=abort_after(LINEAR_CHUNKS)))
            assert out["aborted"] and out["steps"] == LINEAR_CHUNKS * chunk
            assert_only(counts, {"chunk_steps"}, "linearity")
    form = [k for k, v in fdtd_cuda.launches_by_form.items() if v]
    lin_err = linear_err([r["out"] for r in lin.runs])
    say("22", f"array 2x1 linearity, drives (1, 0), (0, 1), (1, 1) of the "
              f"same preparation: {runs_text(lin.runs, [LINEAR_CHUNKS * row['ms'] / 1e3] * 3)}"
              f", {LINEAR_CHUNKS} chunk_steps each (form {form}); uf and if_ "
              f"of drive (1, 1) == (1, 0) + (0, 1) within {lin_err:.2e} of "
              f"their peak (asserted 1e-6), fields within 1e-4 of each "
              f"component's peak [{card}]")

    # a checkpoint: stopped after two chunks, saved, loaded, resumed
    set_port_excitation(sim, [float(p.spec.excite) for p in sim.ports])
    stopped = sim.run(abort_cb=abort_after(2))
    assert stopped["aborted"] and stopped["steps"] == 2 * chunk
    path = "outputs/smoke_checkpoint/array_2x1.npz"
    os.makedirs(os.path.dirname(path), exist_ok=True)
    save_state(path, stopped)
    t0 = time.perf_counter()
    resumed, counts = counted(lambda: sim.run(resume_state=load_state(path)))
    resume_s = time.perf_counter() - t0
    assert resumed["steps"] == out_all["steps"], (resumed["steps"], out_all["steps"])
    assert counts["chunk_steps"] == (out_all["steps"] - 2 * chunk) // chunk
    err = compare_runs(resumed, out_all, "checkpoint resume")
    same = all(torch.equal(x, y) for x, y in zip(resumed["fields"],
                                                 out_all["fields"]))
    say("22", f"checkpoint: the all-on run stopped by abort_cb after 2 chunks "
              f"({stopped['steps']} steps), saved to {path} "
              f"({os.path.getsize(path):,} B), loaded and resumed to "
              f"{resumed['steps']} steps ({counts['chunk_steps']} chunk_steps, "
              f"{resume_s:.3f} s with the load): "
              f"== the straight run (uf, if_, nf_e, nf_h, fields), max |err| "
              f"{err:.3e}, fields bit-equal {same} [{card}]")

    # the CLI: python -m fdtd_solver_antennas_tpu_torch array --nx 2 --ny 1
    outdir = "outputs/smoke_array"
    argv = ["array", "--frequency-ghz", "2.45", "--er", "4.3", "--h-mm", "1.6",
            "--loss-tangent", "0.02", "--nx", "2", "--ny", "1",
            "--outdir", outdir]
    text = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(text), runs_recorded() as cli_runs:
        _none, counts = counted(lambda: cli.main(argv))
    cli_s = time.perf_counter() - t0
    cli_busy = [r["steps"] // chunk * row["ms"] / 1e3 for r in cli_runs.runs]
    text = text.getvalue()
    summary = json.loads(text[text.index("{"):text.rindex("}") + 1])
    assert summary["device"].startswith("cuda"), summary
    assert summary["n_ports"] == 2 and len(summary["s11_db"]) == 2
    assert_only(counts, {"chunk_steps"}, "cli array")
    with np.load(f"{outdir}/array_embedded.npz") as zf:
        assert set(zf.files) == {"freq_hz", "theta", "phi", "e_theta", "e_phi",
                                 "s", "s_freqs_hz", "port_centers_m"}
        cli_err = max(close("cli S", zf["s"], sm.s),
                      close("cli e_theta", zf["e_theta"], eps.e_theta),
                      close("cli e_phi", zf["e_phi"], eps.e_phi))
    f_ts, s_ts, z_ts = read_touchstone(f"{outdir}/array.s2p")
    np.testing.assert_allclose(s_ts, sm.s, rtol=1e-6, atol=1e-9)
    assert z_ts == 50.0 and len(f_ts) == len(sm.freq_hz)
    say("22", f"CLI {' '.join(argv)}: one-hot "
              f"{runs_text(cli_runs.runs, cli_busy)}; {counts['chunk_steps']} "
              f"chunk_steps, nothing else; the whole command {cli_s:.1f} s; "
              f"summary: "
              f"synthesis {summary['synth_freq_ghz']:.4f} GHz, S11 "
              f"{slashed(summary['s11_db'], '.2f')} dB, max coupling "
              f"{summary['max_coupling_db']:.2f} dB, broadside "
              f"{summary['broadside_gain_dbi']:.2f} dBi at "
              f"{summary['broadside_peak_deg']}, steered "
              f"{summary['steered_gain_dbi']:.2f} dBi at "
              f"{summary['steered_peak_deg']}; wrote array_embedded.npz (S and "
              f"patterns == design_array's, max |err| {cli_err:.3e}) and "
              f"array.s2p [{card}]")
    # phase 25 designs the same array through the web app's BackgroundRun
    return dict(row, launches=sum(r["steps"] // chunk for r in rec.runs),
                s=sm.s)


def phase_mixed_smatrix(mixed_prep, k2, card):
    """The mixed patch+horn scene's two-port S matrix under MUR through
    ``MultiPatchScene``'s prepared simulation (phase 8's): two one-hot runs
    on K2's march. Then the march's cached launch arguments: a state
    re-excited between launches steps with the new drive, as the plain
    twin does."""
    from fdtd_solver_antennas_tpu_torch.ops import fdtd_cuda, fdtd_stream
    from fdtd_solver_antennas_tpu_torch.ops.fdtd import set_port_excitation
    from fdtd_solver_antennas_tpu_torch.solvers.sparams import compute_s_matrix

    sim = mixed_prep.sim
    T, decim = sim.stream_T, sim.probe_decim
    with runs_recorded() as rec:
        res, counts = counted(lambda: compute_s_matrix(mixed_prep))
    assert res.ok, res.message
    assert len(rec.runs) == 2
    assert_only(counts, {"stream_steps", "stream_march", "probe_gather"},
                "mixed S matrix")
    steps = [r["steps"] for r in rec.runs]
    assert counts["stream_march"] == sum(steps) // T, counts
    assert counts["probe_gather"] == sum(steps) // decim, counts
    e_stop = [r["out"]["e_ratio"] < sim.cfg.end_criteria for r in rec.runs]
    busy = [(s // T * k2["ms"] + s // decim * k2["probe"]["ms"]) / 1e3
            for s in steps]
    s = res.s
    say("22", f"mixed scene S matrix (MultiPatchScene's prepared sim, MUR, "
              f"{sim.grid.shape}, stream T={T}): one-hot "
              f"{runs_text(rec.runs, busy)}; energy stops {e_stop}; launches "
              f"{ {k: v for k, v in counts.items() if v} }; "
              f"{smatrix_text(res)}; |S21| max "
              f"{20 * np.log10(np.nanmax(np.abs(s[1, 0]))):.2f} dB "
              f"(patch-horn isolation) [{card}]")

    # the march's packed arguments, kept on a running state, see a
    # re-excitation between two launches
    ops = sim.operands
    wf = np.random.default_rng(5).uniform(-1.0, 1.0, 8 * T).tolist()

    def go(impl, second):
        set_port_excitation(sim, (1.0, 0.0))
        st = fdtd_cuda.new_state(sim.padded_shape, sim.device, False)
        for k in range(8):
            if k == 4:
                cached = st._stream
                set_port_excitation(sim, second)
            impl.stream_steps(ops, st, wf[k * T:(k + 1) * T])
        assert st._stream is cached
        return tuple(t.clone() for t in st.fields)

    fdtd_stream.reset_launch_counts()
    kern = go(fdtd_stream.kernels, (0.0, 1.0))
    assert fdtd_stream.launches_by_kernel["stream_march"] == 8
    plain = go(fdtd_stream.plain, (0.0, 1.0))
    stale = go(fdtd_stream.kernels, (1.0, 0.0))
    set_port_excitation(sim, [float(p.spec.excite) for p in sim.ports])
    err = max(close(f"re-excited march {i}", a, b)
              for i, (a, b) in enumerate(zip(kern, plain)))
    moved = max(float((a - b).abs().max()) for a, b in zip(kern, stale))
    assert moved > 1e3 * max(err, 1e-30), (moved, err)
    say("22", f"mixed scene, one state re-excited between march launches 4 "
              f"and 5 (its packed arguments reused): == the plain twin, max "
              f"|err| {err:.3e}; the new drive moved the fields by up to "
              f"{moved:.3e} against the old one [{card}]")
    return dict(launches=counts["stream_march"])


INVERSE_ITERS = 3  # optimize(n_iters=3, lr=0.1), tests/test_inverse.py's
# The CLI's inverse runs one iteration: an iteration at its defaults is
# 10-16 s on an NVIDIA H100 at 700 W, launch-bound (PERF.md), and the phase's
# other iterations are the three above
CLI_ITERS = 1
INVERSE_STEPS = 500  # (a): the exposed step against K1, one chunk at D = 1
FD_EPS = 5e-2  # tests/test_inverse.py's central-difference step
FD_TOL = 0.05  # and its bound on the gradient against it


def inverse_metal_sim(prob):
    """The inverse problem's scene with the design region stamped as a
    metal sheet (tests/test_inverse.py:60-97), on its grid and controls."""
    from fdtd_solver_antennas_tpu_torch.models.scene import Scene
    from fdtd_solver_antennas_tpu_torch.ops.fdtd import build_simulation
    from fdtd_solver_antennas_tpu_torch.physics import substrate_conductivity

    params, sim, r = canonical_params(), prob.sim, prob.region
    f0, h, half = params.frequency_hz, params.h_m * 1e3, 30.0  # sub_mm / 2
    scene = Scene()
    scene.add_material_box(
        "substrate", params.eps_r,
        substrate_conductivity(f0, params.eps_r, params.loss_tangent),
        [-half, -half, 0.0], [half, half, h], priority=0)
    scene.add_metal_box("gnd", [-half, -half, 0.0], [half, half, 0.0],
                        priority=10)
    scene.add_metal_box("patch", [r.x_mm[0], r.y_mm[0], h],
                        [r.x_mm[1], r.y_mm[1], h], priority=10)
    scene.add_lumped_port(1, 50.0, [-6.0, 0.0, 0.0], [-6.0, 0.0, h],
                          direction="z", excite=1.0)
    return build_simulation(
        scene, sim.grid, f0=f0, fc=sim.fc, cfg=sim.cfg, device="cuda",
        port_freqs_hz=sim.port_freqs_hz, nf_freqs_hz=sim.nf_freqs_hz)


def synced(fn):
    """``(fn(), host seconds)``, the clock read after a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def fd_check(loss_fn, rho, what):
    """The loss and its gradient at ``rho``; the largest-|g| pixel against
    central differences (tests/test_inverse.py's criterion). Returns the
    seconds of the loss with its gradient and of one forward."""
    r = torch.tensor(rho, device="cuda", requires_grad=True)

    def value_and_grad():
        v = loss_fn(r)
        v.backward()
        return v

    val, grad_s = synced(value_and_grad)
    g = r.grad.cpu().numpy()
    assert np.isfinite(g).all(), what
    i, j = (int(a) for a in np.unravel_index(np.argmax(np.abs(g)), g.shape))
    plus, minus = rho.copy(), rho.copy()
    plus[i, j] += FD_EPS
    minus[i, j] -= FD_EPS
    with torch.no_grad():
        lp, fwd_s = synced(lambda: loss_fn(plus).item())
        lm = loss_fn(minus).item()
    fd = (lp - lm) / (2 * FD_EPS)
    assert fd != 0.0 and abs(fd - g[i, j]) <= FD_TOL * abs(fd) + 1e-8, (
        what, fd, g[i, j])
    return val.item(), g, (i, j), fd, grad_s, fwd_s


def chunk_loss_grad(prob, rho):
    """The S11-band loss of ``prob`` at ``rho`` with its gradient."""
    r = torch.tensor(rho, device="cuda", requires_grad=True)
    prob.loss(r).backward()
    return r.grad


def traced_device_s(fn, path):
    """(seconds the card was busy while ``fn()`` ran, number of device
    activities) from a ``torch.profiler`` trace written to ``path``: the
    union of its kernel, copy and set intervals; (None, 0) if the trace
    holds none."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)
    events = events["traceEvents"] if isinstance(events, dict) else events
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
                   for e in events if e.get("ph") == "X" and e.get("cat") in
                   ("kernel", "gpu_memcpy", "gpu_memset"))
    if not spans:
        return None, 0
    busy_us, end = 0.0, -np.inf
    for a, b in spans:
        if b > end:
            busy_us += b - max(a, end)
            end = b
    return busy_us / 1e6, len(spans)


def phase_inverse_main_path(card):
    """The inverse-design slice at the CLI's defaults: the exposed step
    against K1's ``chunk_steps`` over one chunk, the S11-band and
    broadside losses with their gradients against central differences,
    three Adam iterations, ``validate`` through K1 alone (the base put
    back bit for bit, ρ ≡ 1 equal to the metal-patch scene) and the CLI's
    ``inverse``."""
    import contextlib
    import io

    from fdtd_solver_antennas_tpu_torch import __main__ as cli
    from fdtd_solver_antennas_tpu_torch.ops import fdtd_cuda
    from fdtd_solver_antennas_tpu_torch.ops.fdtd import (
        ExposedStep, chunk_geometry, padded_waveform)
    from fdtd_solver_antennas_tpu_torch.post.ports import port_spectra
    from fdtd_solver_antennas_tpu_torch.solvers.inverse import prepare_patch_inverse

    params = canonical_params()
    f0 = params.frequency_hz
    prob, prep_s = synced(lambda: prepare_patch_inverse(
        params, freqs_hz=np.linspace(0.9 * f0, 1.1 * f0, 5), device="cuda"))
    sim = prob.sim
    D, n_sub, _chunk, _ = chunk_geometry(sim)
    n_total = -(-prob.n_steps // prob.remat_chunk) * prob.remat_chunk
    assert sim.grid.shape == (47, 40, 33) and prob.region.shape == (28, 18)
    assert prob.n_steps == 3310 and n_total == 3350, (prob.n_steps, n_total)
    assert sim.pallas_mode == "chunk" and (D, n_sub) == (1, 500), (D, n_sub)
    say("23", f"prepare_patch_inverse at the CLI's defaults (mesh lambda/20): "
              f"grid {sim.grid.shape}, {sim.grid.num_cells:,} cells, region "
              f"{prob.region.shape} px, {prob.n_steps} differentiable steps "
              f"({n_total // prob.remat_chunk} checkpointed chunks of "
              f"{prob.remat_chunk}), source {sim.n_source_steps} steps; "
              f"{sim.pallas_mode_reason}; {prep_s:.2f} s")

    # (a) the exposed step against K1 on a thresholded seeded density
    rng = np.random.default_rng(23)
    hard = (rng.uniform(size=prob.region.shape) >= 0.5).astype(np.float32)
    with torch.no_grad():
        coeffs = prob.overlay_coeffs(hard)
    ops = dataclasses.replace(
        sim.operands, ca=tuple(coeffs["ca_" + c] for c in ("ex", "ey", "ez")),
        cb=tuple(coeffs["cb_" + c] for c in ("ex", "ey", "ez")))
    wf = torch.tensor(padded_waveform(sim), dtype=torch.float32, device="cuda")
    st = fdtd_cuda.new_state(sim.padded_shape, sim.device, False)
    bufs = torch.zeros((INVERSE_STEPS, ops.probes.n_rows), device="cuda")
    plan = fdtd_cuda.chunk_launch_plan(ops, st)
    fdtd_cuda.chunk_steps(ops, st, wf, 0, INVERSE_STEPS, 1, bufs)
    step = ExposedStep(sim)
    E = H = torch.zeros((3, *sim.padded_shape), device="cuda")
    samples = []
    with torch.no_grad():
        operands = step.operands(coeffs)
        for n in range(INVERSE_STEPS):
            E, H, _pe, _ph = step.step(E, H, None, None, *operands, wf[n])
            samples.append(step.sample(E, H, step.all_rows))
    err = max(close(f"exposed step vs K1, field {m}", a, b)
              for m, (a, b) in enumerate(zip((*E, *H), fields_of(st))))
    err = max(err, close("exposed step vs K1, probe samples",
                         torch.stack(samples), bufs))
    say("23", f"(a) the exposed step (autograd's forward) against K1's "
              f"chunk_steps, one launch of {INVERSE_STEPS} x D=1 steps ("
              f"{plan_text(plan)}, probe rows {ops.probes.n_rows:,}, bufs "
              f"{tuple(bufs.shape)}) on the overlay of a thresholded seeded "
              f"density ({int(hard.sum())} of {hard.size} px metal): fields "
              f"and every step's probe samples agree, max |err| {err:.3e} "
              f"[{card}]")

    # (b) the losses and their gradients against central differences
    rho = np.clip(0.5 + 0.1 * np.random.default_rng(7).standard_normal(
        prob.region.shape), 0, 1).astype(np.float32)
    for what, fn in (("S11 band", prob.loss),
                     ("broadside gain", prob.broadside_gain_loss)):
        val, g, ij, fd, grad_s, fwd_s = fd_check(fn, rho, what)
        say("23", f"(b) {what} loss {val:.6f} at the seeded density: "
                  f"gradient finite, max |g| {np.abs(g).max():.4e} at pixel "
                  f"{ij}: {g[ij]:.5e} against central differences (eps "
                  f"{FD_EPS:g}) {fd:.5e}, within {abs(fd - g[ij]) / abs(fd):.4f}"
                  f" (bound {FD_TOL:g}); loss + gradient {grad_s:.3f} s "
                  f"({grad_s / n_total * 1e6:.1f} us a step), forward "
                  f"{fwd_s:.3f} s ({fwd_s / n_total * 1e6:.1f} us a step) "
                  f"[{card}]")

    # (c) three Adam iterations, each timed, its forward timed apart
    fwd_s, marks = [], []
    forward = prob.s11_fn

    def timed_forward(r):
        out, s = synced(lambda: forward(r))
        fwd_s.append(s)
        return out

    def mark(it, loss, _rho):
        torch.cuda.synchronize()
        marks.append((time.perf_counter(), loss,
                      torch.cuda.max_memory_allocated()))

    prob._s11_fn = timed_forward
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = prob.optimize(n_iters=INVERSE_ITERS, lr=0.1, callback=mark)
    prob._s11_fn = forward
    assert len(res.history) == INVERSE_ITERS, res.history
    assert res.history[-1] < res.history[0], res.history
    assert np.isfinite(res.s11).all()
    for it, (t, loss, peak) in enumerate(marks):
        wall = t - (marks[it - 1][0] if it else t0)
        say("23", f"(c) optimize iteration {it + 1}/{INVERSE_ITERS}: loss "
                  f"{loss:.6f}, wall {wall:.3f} s; forward "
                  f"{fwd_s[it] / n_total * 1e6:.1f} us a step, the "
                  f"iteration's wall per step {wall / n_total * 1e6:.1f} us "
                  f"(forward, backward, Adam step and callback); "
                  f"max_memory_allocated {peak / 2**20:,.1f} MiB [{card}]")
    say("23", f"(c) optimize(n_iters={INVERSE_ITERS}, lr=0.1): loss "
              f"{slashed(res.history, '.6f')} (falls), soft |S11| band "
              f"{slashed(res.s11_db(), '.2f')} dB; {res.wall_s:.2f} s with "
              f"the final S11 forward ({fwd_s[-1]:.3f} s) [{card}]")

    # the device's share of one checkpointed chunk's loss and gradient
    one = dataclasses.replace(prob, n_steps=prob.remat_chunk, _s11_fn=None,
                              _pattern_fns=None)
    walls = [synced(lambda: chunk_loss_grad(one, rho))[1] for _ in range(3)]
    busy, spans = traced_device_s(lambda: chunk_loss_grad(one, rho),
                                  "outputs/smoke_inverse/chunk_trace.json")
    chunk_wall = float(np.median(walls[1:]))
    busy_text = ("not measured: torch.profiler recorded no device activity"
                 if busy is None else
                 f"{busy * 1e3:.3f} ms busy in {spans} kernels, copies and "
                 f"sets ({busy / prob.remat_chunk * 1e6:.1f} us a step), idle "
                 f"share {1 - busy / chunk_wall:.3f}")
    say("23", f"(c) one checkpointed chunk's loss and gradient "
              f"({prob.remat_chunk} steps): wall {chunk_wall * 1e3:.3f} ms "
              f"({chunk_wall / prob.remat_chunk * 1e6:.1f} us a step; "
              f"{slashed([w * 1e3 for w in walls], '.3f')} ms, the first a "
              f"warm-up); device under torch.profiler: {busy_text} [{card}]")

    # (d) validate: K1 alone, the base put back, rho = 1 == the metal patch
    base = {k: v.clone() for k, v in sim.coeffs.items()}
    (val, counts), val_s = synced(lambda: counted(
        lambda: prob.validate(res.rho, pattern=True)))
    forms = dict(fdtd_cuda.launches_by_form)
    assert_only(counts, {"chunk_steps"}, "validate")
    assert counts["chunk_steps"] == val["steps"] // n_sub, (counts, val["steps"])
    for k, v in base.items():
        assert torch.equal(sim.coeffs[k], v), k
    s11_db = 20 * np.log10(np.maximum(np.abs(val["spectra"].s11), 1e-12))
    d_bs, d_max = val["broadside_directivity"], val["Dmax"]
    assert np.isfinite(val["broadside_realized_gain_dbi"])
    assert d_max >= d_bs - 1e-9 and d_bs > 0.0, (d_bs, d_max)
    ones = np.ones(prob.region.shape, np.float32)
    got = prob.validate(ones)
    ref = inverse_metal_sim(prob).run()
    assert got["steps"] == ref["steps"], (got["steps"], ref["steps"])
    want = port_spectra(sim.port_freqs_hz, ref["uf"][0], ref["if_"][0],
                        sim.dft_dt, z_ref=50.0)
    for key in ("uf", "if_"):
        assert np.array_equal(getattr(got["spectra"], key),
                              getattr(want, key)), key
    f_res = val["f_res_hz"]
    say("23", f"(d) validate of the thresholded design "
              f"({int(val['rho_binary'].sum())} of {hard.size} px metal): "
              f"{val['steps']} steps in {val_s:.3f} s, {counts['chunk_steps']} "
              f"chunk_steps (by form {forms}) and nothing else; f_res "
              f"{f_res / 1e9:.4f} GHz, |S11|min {s11_db.min():.2f} dB; "
              f"pattern=True through nf2ff_transform on the card: broadside "
              f"D {d_bs:.3f}, Dmax {10 * np.log10(d_max):.2f} dBi, realized "
              f"gain {val['broadside_realized_gain_dbi']:.2f} dBi; the "
              f"base ca/cb bit-equal afterwards; rho = 1 through validate == "
              f"the metal-patch scene built fresh and run ({got['steps']} "
              f"steps, uf and if_ bit for bit) [{card}]")
    row = k1_launch_alone(sim, "23", card, "inverse validate")

    # (e) the CLI: python -m fdtd_solver_antennas_tpu_torch inverse
    outdir = "outputs/smoke_inverse"
    argv = ["inverse", "--frequency-ghz", "2.45", "--er", "4.3", "--h-mm",
            "1.6", "--loss-tangent", "0.02", "--iters", str(CLI_ITERS),
            "--outdir", outdir]
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        (_none, cli_counts), cli_s = synced(lambda: counted(lambda: cli.main(argv)))
    text = text.getvalue()
    summary = json.loads(text[text.index("{"):text.rindex("}") + 1])
    assert summary["device"].startswith("cuda"), summary
    assert_only(cli_counts, {"chunk_steps"}, "cli inverse")
    assert cli_counts["chunk_steps"] == summary["validated_steps"] // n_sub
    assert f"iter {CLI_ITERS}/{CLI_ITERS}  loss=" in text, text
    with np.load(f"{outdir}/inverse_design.npz") as zf:
        assert set(zf.files) == {
            "rho", "rho_binary", "loss_history", "freqs_hz", "s11",
            "validated_freq_hz", "validated_s11", "region_x_mm", "region_y_mm"}
        assert zf["rho"].shape == prob.region.shape
        assert zf["loss_history"].shape == (CLI_ITERS,)
        assert np.isfinite(zf["validated_s11"]).all()
    say("23", f"CLI {' '.join(argv)}: {cli_s:.1f} s in all; loss "
              f"{summary['loss_initial']:.6f} -> {summary['loss_final']:.6f}, "
              f"validated {summary['validated_steps']} steps "
              f"({cli_counts['chunk_steps']} chunk_steps, nothing else), f_res "
              f"{summary['validated_f_res_ghz']:.4f} GHz, |S11|min "
              f"{summary['validated_s11_min_db']:.2f} dB; wrote "
              f"inverse_design.npz [{card}]")
    return dict(row, launches=counts["chunk_steps"])


WALK_SPLIT = 3  # (a): the mixed scene's 141 x rows as 3 slabs of 47


def seeded_state(ops, seed):
    """A state of ``ops``' shape, fields and ψ from a seeded normal draw on
    the card."""
    from fdtd_solver_antennas_tpu_torch.ops import fdtd_cuda

    gen = torch.Generator(device=ops.device)
    gen.manual_seed(seed)
    st = fdtd_cuda.new_state(ops.shape, ops.device, ops.pml is not None)
    for t in (*st.e[0], *st.e[1], *st.h, *st.psi_e, *st.psi_h):
        t.copy_(torch.randn(t.shape, generator=gen, device=ops.device))
    return st


def walk_bound(name, ops):
    """Bound of one launch of a walk kernel on ``ops`` (a slab): each input
    read once, each output written once (float32), the larger of bytes over
    the HBM rate and operations over the float32 peak. ``mur_faces``: the
    mean of its x, y and z launches, each moving the two tangential
    components of the walls inside the slab (read E[nb], E'[nb], E[wall],
    write E'[wall]; 3 operations a cell). ``e_update_mur``: ``e_update``'s
    (its walls read and write only cells the E update moves already)."""
    n = int(np.prod(ops.shape))
    n_src = sum(s is not None for s in ops.src)
    psi = 12 if ops.pml is not None else 0
    if name == "h_update":  # E, H in; H out (+ psi_h in and out)
        return bound(4 * n * (9 + psi), n * (21 + 2 * psi))
    if name in ("e_update", "e_update_mur"):  # E, H, ca, cb, src in; E out
        return bound(4 * n * (15 + n_src + psi), n * (27 + 2 * psi))
    cells = 0
    for axis in range(3):
        walls = sum(0 <= w < ops.shape[axis] for w in ops.mur_walls(axis))
        cells += walls * 2 * n // ops.shape[axis]
    return bound(16 * cells / 3, 3 * cells / 3)


WALK_CALLS = {
    "h_update": lambda m, ops, st: m.h_update(ops, st),
    "e_update": lambda m, ops, st: m.e_update(ops, st, 0.37),
    "mur_faces": lambda m, ops, st: [m.mur_faces(ops, st, a) for a in range(3)],
    "e_update_mur": lambda m, ops, st: m.e_update_mur(ops, st, 0.37),
}


def walk_kernels_vs_plain(label, ops, seed, card, timed):
    """Each walk kernel of ``WALK_CALLS`` on ``ops`` from one seeded state
    against its plain twin (at the tolerance; ``e_update_mur`` asserted bit
    for bit); with ``timed``, each timed beside its bound (``mur_faces``:
    the mean of its x, y and z launches). Returns (worst max |err|, rows
    by kernel, the comparison's text)."""
    from fdtd_solver_antennas_tpu_torch.ops import fdtd_cuda as fc

    base = seeded_state(ops, seed)
    rows, errs, worst = {}, [], 0.0
    for name, call in WALK_CALLS.items():
        a, b = clone_state(base), clone_state(base)
        call(fc.kernels, ops, a)
        call(fc.plain, ops, b)
        torch.cuda.synchronize()
        got, ref = (*a.e[1], *a.h), (*b.e[1], *b.h)
        err = max(close(f"{label} {name} {i}", x, y)
                  for i, (x, y) in enumerate(zip(got, ref)))
        same = all(torch.equal(x, y) for x, y in zip(got, ref))
        assert same or name != "e_update_mur", f"{label}: {name} not bit-equal"
        worst = max(worst, err)
        errs.append(f"{name} {err:.3e}{' (bit-equal)' if same else ''}")
        if timed:
            launches = 3 if name == "mur_faces" else 1
            ms = device_ms(lambda: call(fc.kernels, ops, a)) / launches
            plain_ms = device_ms(lambda: call(fc.plain, ops, b), reps=3,
                                 warmup=1) / launches
            b_ms, b_by = walk_bound(name, ops)
            rows[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                              bound_ms=b_ms, bound_by=b_by)
            say("24", f"{name} on the {label} {ops.shape}: device "
                      f"{ms * 1e3:.1f} us/launch, plain {plain_ms * 1e3:.1f} "
                      f"us, bound {b_ms * 1e3:.2f} us by {b_by} ({b_ms / ms:.3f} "
                      f"of it) [{card}]")
    return worst, rows, ", ".join(errs)


def phase_walk_vs_plain(mixed, card):
    """(a) The walk's kernels on slabs of the mixed scene against their
    plain twins: ``h_update``, ``e_update``, the three ``mur_faces`` and
    ``e_update_mur`` on the three slabs of a 3-rank split (rank 0 holds
    the bottom x wall, rank 1 none, rank 2 the top one; rows not starting
    at 0) and on the one-rank slab the main path runs, there timed beside
    the bound."""
    from fdtd_solver_antennas_tpu_torch.ops import fdtd_shard

    Px = mixed.padded_shape[0]
    n = Px // WALK_SPLIT
    slabs = {f"rank {r} of {WALK_SPLIT}": fdtd_shard.slab_operands(mixed, r, n, 1)
             for r in range(WALK_SPLIT)}
    slabs["one rank"] = fdtd_shard.slab_operands(mixed, 0, Px, 1)
    rows, worst = {}, 0.0
    for label, ops in slabs.items():
        err, timed, text = walk_kernels_vs_plain(
            f"mixed {label} slab", ops, 241, card, timed=label == "one rank")
        worst = max(worst, err)
        rows.update(timed)
        say("24", f"(a) mixed scene slab {label} {ops.shape}, x walls at slab "
                  f"rows {ops.mur_x_rows}: kernel == plain, max |err| {text}")
    for row in rows.values():
        row["max_abs_err"] = worst
    return rows


def walk_counts():
    from fdtd_solver_antennas_tpu_torch.ops import fdtd_cuda, fdtd_shard, fdtd_stream

    return {**fdtd_cuda.launches, **fdtd_shard.launches,
            **fdtd_stream.launches, **fdtd_stream.launches_by_kernel}


def reset_counts():
    from fdtd_solver_antennas_tpu_torch.ops import fdtd_cuda, fdtd_shard, fdtd_stream

    fdtd_cuda.reset_launch_counts()
    fdtd_shard.reset_launch_counts()
    fdtd_stream.reset_launch_counts()


def assert_walk_counts(counts, steps, D, fused=True):
    """A walk's run on the fused route launched ``h_update`` and
    ``e_update_mur`` once a step, ``probe_gather`` once an interval, and
    nothing else (no ``e_update``, no ``mur_faces``); on the per-axis route
    (``fused`` false, MUR) ``h_update`` and ``e_update`` once a step and
    ``mur_faces`` three times, ``probe_gather`` once an interval, and
    nothing else."""
    want = (dict(h_update=steps, e_update_mur=steps, probe_gather=steps // D)
            if fused else dict(h_update=steps, e_update=steps,
                               mur_faces=3 * steps, probe_gather=steps // D))
    for name, v in counts.items():
        assert v == want.get(name, 0), (name, v, want.get(name, 0), counts)


def phase_walk_canonical(group, card):
    """(b) The canonical patch to its stop through the walk on one rank
    (``use_kernel=False``), through ``run_prepared_fixed``, against K1's
    chunk-mode run: the fused route, launches, outputs, S11 and Dmax,
    wall, µs a step and the idle share; then each walk kernel on its slab
    against its twin, timed beside its bound."""
    from fdtd_solver_antennas_tpu_torch.ops import fdtd_cuda
    from fdtd_solver_antennas_tpu_torch.parallel import build_explicit_run
    from fdtd_solver_antennas_tpu_torch.solvers.patch_fixed import (
        prepare_patch_fixed, run_prepared_fixed)

    params = canonical_params()
    prep = prepare_patch_fixed(params, device="cuda")
    assert prep.ok, prep.message
    sim = prep.sim
    run = build_explicit_run(sim, group, use_kernel=False)
    walk, outs = run.stepper, []
    assert walk.fused and not walk.straddles, walk.straddles

    def walked():
        outs.append(run())
        return outs[-1]

    reset_counts()
    res = run_prepared_fixed(prep, frequency_hz=params.frequency_hz, verbose=0,
                             run=walked)
    counts = walk_counts()
    assert res.ok, res.message
    out, D = outs[0], sim.probe_decim
    steps = int(out["steps"])
    assert_walk_counts(counts, steps, D)
    ref = sim.run()
    err = compare_runs(out, ref, "walk vs chunk mode")
    same = all(torch.equal(a, b) for a, b in zip(out["fields"], ref["fields"]))
    s11_db = 20 * np.log10(np.maximum(np.abs(res.s11), 1e-12))
    dmax_dbi = 10 * np.log10(res.Dmax)
    assert 5.0 < dmax_dbi < 8.0, f"Dmax {dmax_dbi:.2f} dBi outside 5-8"
    assert s11_db.min() < -8.0, f"|S11|min {s11_db.min():.2f} dB not < -8"
    # device time of one walk step (its kernels, behind a sleep kernel) and
    # of one probe gather, on a seeded state of the slab
    st = seeded_state(walk.ops, seed=9)
    rows = torch.zeros(walk.ops.probes.n_rows, device=st.h[0].device)
    gather_ms = device_ms(lambda: fdtd_cuda.probe_gather(walk.ops, st, rows))
    step_ms = device_ms(lambda: walk.step(st, 0.37), reps=10)
    del st
    busy = (steps * step_ms + steps // D * gather_ms) / 1e3
    wall = res.wall_time_s
    say("24", f"(b) canonical patch {sim.grid.shape} through the walk "
              f"(build_explicit_run(use_kernel=False)) in a one-rank NCCL group: "
              f"slab {walk.ops.shape}, {steps} steps (chunk mode "
              f"{ref['steps']}) in {wall:.3f} s, {wall / steps * 1e6:.2f} us a "
              f"step, {res.mcells_per_s:.1f} Mcell-updates/s; == K1's chunk-mode "
              f"run (steps, e_ratio, uf, if_, nf_e, nf_h, fields; fields "
              f"bit-equal {same}), max |err| {err:.3e}; f_res "
              f"{res.f_res_hz / 1e9:.4f} GHz, |S11|min {s11_db.min():.2f} dB, "
              f"Dmax {dmax_dbi:.3f} dBi; kernels busy {busy:.3f} s (a step "
              f"{step_ms * 1e3:.1f} us of device time, a gather "
              f"{gather_ms * 1e3:.2f} us), idle share {1 - busy / wall:.3f}; "
              f"launches {counts} [{card}]")
    _err, _rows, text = walk_kernels_vs_plain("canonical slab", walk.ops, 9,
                                              card, timed=True)
    say("24", f"(b) canonical slab {walk.ops.shape}: kernel == plain, max "
              f"|err| {text} [{card}]")
    return counts


def phase_walk_mixed(group, mixed, mixed_res, k2, walk_rows, card):
    """(c) The mixed scene to its stop through the walk on one rank (Pz 152,
    past K3's route), through ``run_prepared_multi_patch_3d``, against the
    explicit path's march route on the same scene (launches, outputs,
    physics), and µs a step beside the march's and K1 forced onto the
    grid; then the same walk again with ``Walk.fused`` forced off, the
    per-axis route a straddled rank takes (``e_update`` and a
    ``mur_faces`` per axis), its launches asserted and its outputs bit-equal
    to the fused run's. Returns the launches of both runs."""
    from fdtd_solver_antennas_tpu_torch.ops import fdtd_cuda
    from fdtd_solver_antennas_tpu_torch.parallel import build_explicit_run
    from fdtd_solver_antennas_tpu_torch.solvers.multi_patch_3d import (
        run_prepared_multi_patch_3d)

    run = build_explicit_run(mixed, group, use_kernel=False)
    walk, outs = run.stepper, []
    assert mixed.padded_shape[2] > 128, mixed.padded_shape
    assert walk.fused and not walk.straddles, walk.straddles

    def walked():
        outs.append(run())
        return outs[-1]

    reset_counts()
    res = run_prepared_multi_patch_3d(k2["prep"], frequency_hz=k2["f_run"],
                                      verbose=0, run=walked)
    counts = walk_counts()
    assert res.ok, res.message
    out, D = outs[0], mixed.probe_decim
    steps = int(out["steps"])
    assert_walk_counts(counts, steps, D)
    e_ratio = res.diagnostics["energy_ratio"]
    assert steps < mixed.cfg.n_steps_max and e_ratio < mixed.cfg.end_criteria, (
        steps, e_ratio)
    assert steps == mixed_res.steps_run, (steps, mixed_res.steps_run)
    walk_wall = res.wall_time_s

    march = build_explicit_run(mixed, group)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = march()
    torch.cuda.synchronize()
    march_wall = time.perf_counter() - t0
    err = compare_runs(out, ref, "walk vs march route")
    same = all(torch.equal(a, b) for a, b in zip(out["fields"], ref["fields"]))
    k1_sim = dataclasses.replace(mixed, pallas_mode="chunk", stream_T=1)
    k1_out, k1_wall = timed_run(k1_sim, fdtd_cuda.kernels)
    assert k1_out["steps"] == steps, (k1_out["steps"], steps)
    dmax, dmax_ref = 10 * np.log10(res.Dmax), 10 * np.log10(mixed_res.Dmax)
    assert abs(dmax - dmax_ref) <= 0.01, (dmax, dmax_ref)
    step_ms = sum(walk_rows[k]["ms"] for k in ("h_update", "e_update_mur"))
    busy = (steps * step_ms + steps // D * k2["probe"]["ms"]) / 1e3
    say("24", f"(c) mixed scene {mixed.grid.shape} through the walk on one "
              f"rank: slab {walk.ops.shape}, {steps} steps (phase 8: "
              f"{mixed_res.steps_run}), energy ratio {e_ratio:.3e}; == the "
              f"march route's explicit run (steps, e_ratio, uf, if_, nf_e, "
              f"nf_h, fields; fields bit-equal {same}), max |err| {err:.3e}; "
              f"Dmax {dmax:.4f} dBi (phase 8 {dmax_ref:.4f}); launches {counts} "
              f"[{card}]")
    say("24", f"(c) mixed scene, {steps} steps, wall per step: walk "
              f"{walk_wall / steps * 1e6:.1f} us ({walk_wall:.3f} s, kernels "
              f"busy {busy:.3f} s: {step_ms * 1e3:.1f} us a step, idle share "
              f"{1 - busy / walk_wall:.3f}), march route (explicit, T="
              f"{march.kernel_window}) {march_wall / steps * 1e6:.1f} us "
              f"({march_wall:.3f} s), K1 forced (chunk_steps) "
              f"{k1_wall / steps * 1e6:.1f} us ({k1_wall:.3f} s) [{card}]")

    walk.fused = False  # the per-axis route, as a straddled rank runs it
    try:
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        axis_out = run()
        torch.cuda.synchronize()
        axis_wall = time.perf_counter() - t0
        axis_counts = walk_counts()
    finally:
        walk.fused = True
    assert_walk_counts(axis_counts, steps, D, fused=False)
    axis_err = compare_runs(axis_out, out, "per-axis walk vs fused walk")
    assert axis_err == 0.0 and axis_out["e_ratio"] == out["e_ratio"], (
        axis_err, axis_out["e_ratio"], out["e_ratio"])
    axis_ms = (walk_rows["h_update"]["ms"] + walk_rows["e_update"]["ms"]
               + 3 * walk_rows["mur_faces"]["ms"])
    axis_busy = (steps * axis_ms + steps // D * k2["probe"]["ms"]) / 1e3
    say("24", f"(c) mixed scene through the walk with Walk.fused forced off "
              f"(the per-axis route of a straddled rank): {steps} steps, "
              f"launches {axis_counts}; steps, e_ratio, uf, if_, nf_e, nf_h, "
              f"fields and psi bit-equal to the fused walk's; wall "
              f"{axis_wall / steps * 1e6:.1f} us a step ({axis_wall:.3f} s; "
              f"the fused run's, from run_prepared_multi_patch_3d: "
              f"{walk_wall / steps * 1e6:.1f} us), kernels busy "
              f"{axis_busy:.3f} s ({axis_ms * 1e3:.1f} us a step), idle share "
              f"{1 - axis_busy / axis_wall:.3f} [{card}]")
    return counts, axis_counts


def phase_shard_simulation(group, card):
    """(d) ``shard_simulation`` of the canonical patch over the one-rank
    mesh: ``sim.run()`` runs the explicit path (K3) and equals the
    unsharded run."""
    from fdtd_solver_antennas_tpu_torch.parallel import (
        make_device_mesh, shard_simulation)
    from fdtd_solver_antennas_tpu_torch.solvers.patch_fixed import prepare_patch_fixed

    prep = prepare_patch_fixed(canonical_params(), device="cuda")
    assert prep.ok, prep.message
    sim = prep.sim
    ref = sim.run()
    mesh = make_device_mesh(group=group)
    shard_simulation(sim, mesh)
    reset_counts()
    out = sim.run()
    counts = walk_counts()
    intervals = out["steps"] // sim.probe_decim
    assert counts["probe_gather"] == intervals and counts["shard_steps"] > 0, counts
    for name, v in counts.items():
        assert v == 0 or name in ("shard_steps", "probe_gather"), counts
    err = compare_runs(out, ref, "shard_simulation vs unsharded")
    same = all(torch.equal(a, b) for a, b in zip(out["fields"], ref["fields"]))
    say("24", f"(d) shard_simulation(canonical, mesh {mesh.shape} {mesh.axis_names}) "
              f"-> sim.run(): {out['steps']} steps == the unsharded run "
              f"(fields bit-equal {same}), max |err| {err:.3e}; launches "
              f"{counts} [{card}]")


def sweep_raw(prep):
    """``run_patch_geometry_sweep(prep)`` and the raw batched output it
    read."""
    from fdtd_solver_antennas_tpu_torch.solvers import sweep

    raw = []

    def spy(prepared, impl=None):
        raw.append(inner(prepared, impl))
        return raw[-1]

    inner, sweep._run_batched = sweep._run_batched, spy
    try:
        res = sweep.run_patch_geometry_sweep(prep)
    finally:
        sweep._run_batched = inner
    assert res.ok, res.message
    return res, raw[0][0]


def phase_shard_sweep(group, k1b, card):
    """(e) ``shard_sweep`` of ``bench.py``'s 8-variant sweep over the
    one-rank sweep mesh: the share is every variant, run through K1
    batched (one ``chunk_steps_batch`` a chunk, nothing else), and one
    NCCL ``all_gather`` gives the results; they equal the unsharded
    sweep's bit for bit."""
    from fdtd_solver_antennas_tpu_torch.parallel import make_sweep_mesh, shard_sweep
    from fdtd_solver_antennas_tpu_torch.solvers.sweep import prepare_patch_geometry_sweep

    prep = prepare_patch_geometry_sweep(sweep_variants(), n_steps_max=SWEEP_STEPS,
                                        end_criteria=1e-4, device="cuda")
    assert prep.ok, prep.message
    ref_res, ref = sweep_raw(prep)
    mesh = make_sweep_mesh(group=group)
    shard_sweep(prep, mesh)
    reset_counts()
    res, out = sweep_raw(prep)
    counts = walk_counts()
    chunks = k1b["launches"]
    for name, v in counts.items():
        assert v == (chunks if name == "chunk_steps_batch" else 0), counts
    for key in ("uf", "if_", "steps", "e_ratio", "e_max"):
        np.testing.assert_array_equal(out[key], ref[key], err_msg=key)
    for key in ("nf_e", "nf_h"):
        for a, b in zip(out[key], ref[key], strict=True):
            np.testing.assert_array_equal(a, b, err_msg=key)
    for a, b in zip(out["fields"], ref["fields"], strict=True):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(res.f_res_hz, ref_res.f_res_hz)
    say("24", f"(e) shard_sweep of the {len(prep.variants)}-variant sweep over "
              f"the sweep mesh {mesh.shape} {mesh.axis_names}: {counts['chunk_steps_batch']} "
              f"chunk_steps_batch launches and nothing else, one NCCL all_gather; "
              f"uf, if_, nf_e, nf_h, steps, e_ratio, e_max and the fields "
              f"bit-equal to the unsharded sweep; wall {res.wall_time_s:.3f} s "
              f"(unsharded {ref_res.wall_time_s:.3f} s), {res.mcells_per_s:.1f} "
              f"Mcell-updates/s aggregate [{card}]")


def phase_parallel(mixed, mixed_res, k2, k1b, card):
    """Phase 24, the parallel slice, inside a one-rank NCCL process group
    (destroyed at the end whatever happens)."""
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        group = dist.group.WORLD
        walk_rows = timed_phase("24", phase_walk_vs_plain, mixed, card)
        timed_phase("24", phase_walk_canonical, group, card)
        mixed_counts, axis_counts = timed_phase(
            "24", phase_walk_mixed, group, mixed, mixed_res, k2, walk_rows,
            card)
        timed_phase("24", phase_shard_simulation, group, card)
        timed_phase("24", phase_shard_sweep, group, k1b, card)
    finally:
        dist.destroy_process_group()
    for name, row in walk_rows.items():  # each from the route that runs it
        row["launches"] = (axis_counts if name in ("e_update", "mur_faces")
                           else mixed_counts)[name]
    return walk_rows


def run_cli(argv):
    """``__main__.main(argv)`` with its standard output captured and the
    launch counts set to 0 just before it; returns (text, counts)."""
    import contextlib
    import io

    from fdtd_solver_antennas_tpu_torch import __main__ as cli

    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        _none, counts = counted(lambda: cli.main(argv))
    return text.getvalue(), counts


def figure_lines(text):
    """The CLI's lines about its figures: saved PNGs or not drawn."""
    return [ln for ln in text.splitlines()
            if ln.startswith("Not drawn:") or (ln.startswith("Saved:")
                                               and ln.endswith(".png"))]


def same_result(a, b) -> bool:
    """Two solver results bit for bit: steps, S11, Z_in, pattern, Dmax."""
    return (a.steps_run == b.steps_run and a.Dmax == b.Dmax
            and all(np.array_equal(np.asarray(x), np.asarray(y))
                    for x, y in ((a.s11, b.s11), (a.z_in, b.z_in),
                                 (a.intensity, b.intensity))))


def phase_frontends_cli(res4, counts4, card):
    """(a) The CLI's ``simulate`` and ``fdtd --solver fixed`` at phase 4's
    arguments through ``__main__.main``: ``fdtd`` launches ``chunk_steps``
    alone, phase 4's count, and its summary and ``s11.npz`` equal phase
    4's run; the figures written, or the lines naming those not drawn."""
    import importlib.util

    outdir = "outputs/smoke_cli"
    mpl = importlib.util.find_spec("matplotlib") is not None
    t0 = time.perf_counter()
    text, counts = run_cli(["simulate", "--frequency-ghz", "2.45", "--er",
                            "4.3", "--h-mm", "1.6", "--outdir", outdir])
    sim_s = time.perf_counter() - t0
    assert_only(counts, set(), "cli simulate")
    design = [ln.strip() for ln in text.splitlines() if ln.startswith("  ")]
    pngs = figure_lines(text)
    assert len(pngs) == 2 and all(("Saved:" in ln) == mpl for ln in pngs), pngs
    say("25", f"CLI simulate in {sim_s:.2f} s (the analytical model, no "
              f"launch); design {'; '.join(design)}; {' | '.join(pngs)}; "
              f"matplotlib installed: {mpl}")

    argv = ["fdtd", "--frequency-ghz", "2.45", "--er", "4.3", "--h-mm", "1.6",
            "--loss-tangent", "0.02", "--solver", "fixed", "--outdir", outdir]
    t0 = time.perf_counter()
    text, counts = run_cli(argv)
    fdtd_s = time.perf_counter() - t0
    assert_only(counts, {"chunk_steps"}, "cli fdtd")
    assert counts["chunk_steps"] == counts4["chunk_steps"], counts
    summary = json.loads(text[text.index("{"):text.rindex("}") + 1])
    s11_db = 20 * np.log10(np.maximum(np.abs(res4.s11), 1e-12))
    want = {"f_res_ghz": res4.f_res_hz / 1e9, "s11_min_db": float(s11_db.min()),
            "Dmax_dbi": 10 * np.log10(res4.Dmax), "steps": res4.steps_run}
    for k, v in want.items():
        assert summary[k] == v, (k, summary[k], v)
    with np.load(f"{outdir}/s11.npz") as z:
        assert np.array_equal(z["s11"], res4.s11)
    pngs = figure_lines(text)
    assert len(pngs) == 1 and pngs[0].endswith(
        ("pattern_fdtd.png", "(matplotlib is not installed)")), pngs
    say("25", f"CLI {' '.join(argv)} in {fdtd_s:.2f} s: "
              f"{text.splitlines()[0] if text else ''}; {summary['steps']} "
              f"steps, f_res {summary['f_res_ghz']:.4f} GHz, |S11|min "
              f"{summary['s11_min_db']:.2f} dB, Dmax "
              f"{summary['Dmax_dbi']:.3f} dBi == phase 4's run (summary and "
              f"s11.npz bit for bit); launches {counts['chunk_steps']} "
              f"chunk_steps, nothing else; {' | '.join(pngs)} [{card}]")


def on_thread(fn):
    """``fn()`` on a new thread, as the GUI's worker runs; returns its
    result, the thread's CUDA device and stream, and the host seconds."""
    import threading

    box = {}

    def work():
        box["device"] = torch.cuda.current_device()
        box["stream"] = torch.cuda.current_stream().cuda_stream
        t0 = time.perf_counter()
        try:
            box["out"] = fn()
        except BaseException as e:  # re-raised on the calling thread
            box["error"] = e
        box["s"] = time.perf_counter() - t0

    t = threading.Thread(target=work, daemon=True)
    t.start()
    t.join(600)
    assert not t.is_alive(), "worker thread still running"
    if "error" in box:
        raise box["error"]
    return box


def phase_frontends_kinds(res4, k21, card):
    """(b) ``dispatch_prepare`` for the five solver kinds on the canonical
    FR-4 patch, each runner on a worker thread with ``progress_cb`` and
    ``abort_cb`` wired as the GUI's worker wires them (by the runner's
    signature): ``chunk_steps`` alone for four kinds, the march and
    ``probe_gather`` alone for microstrip_3d (quality 5, PML_8: phase
    21's arguments). ``fixed`` equals phase 4's run bit for bit."""
    import threading

    from fdtd_solver_antennas_tpu_torch.frontends.gui_app import (
        dispatch_prepare, format_port_diagnostics, runner_kwargs)

    params = canonical_params()
    main_stream = torch.cuda.current_stream().cuda_stream
    earlier = {"legacy": k21["legacy PML_8"]["res"],
               "2d": k21["quasi-2D PML_8"]["res"],
               "microstrip_3d": k21["microstrip_3d q5 PML_8"]["res"]}
    with np.load("outputs/smoke_s11/s11.npz") as z:
        s11_cli = z["s11"]  # phase 20's CLI s11: the same preparation
    kinds = (("fixed", {}), ("microstrip", {}),
             ("microstrip_3d", dict(boundary="PML_8", mesh_quality=5)),
             ("legacy", {}), ("2d", {}))
    for kind, kw in kinds:
        t0 = time.perf_counter()
        prep, runner = dispatch_prepare(params, kind, device="cuda", **kw)
        prep_s = time.perf_counter() - t0
        assert prep.ok, prep.message
        sim = prep.sim
        ticks, abort = [], threading.Event()
        wired = runner_kwargs(
            runner, lambda n, total, r: ticks.append((n, total, r)),
            abort.is_set)
        box, counts = counted(lambda: on_thread(lambda: runner(
            prep, frequency_hz=params.frequency_hz, verbose=0, **wired)))
        res = box["out"]
        check_result(res, kind in ("microstrip_3d", "legacy"))
        assert box["device"] == (sim.device.index or 0), box["device"]
        steps = res.steps_run
        if sim.pallas_mode == "stream":
            assert kind == "microstrip_3d"
            assert counts["stream_march"] == steps // sim.stream_T, counts
            assert_only(counts, {"stream_steps", "stream_march",
                                 "probe_gather"}, kind)
        else:
            assert kind != "microstrip_3d", sim.pallas_mode_reason
            assert_only(counts, {"chunk_steps"}, kind)
        if wired:
            assert [t[0] for t in ticks] == sorted(t[0] for t in ticks)
            assert ticks[-1][0] == ticks[-1][1] == steps, ticks[-1]
        if kind == "fixed":
            assert same_result(res, res4), "fixed != phase 4's run"
            same = "== phase 4's run bit for bit"
        elif kind == "microstrip":
            same = (f"S11 bit-equal to phase 20's CLI s11: "
                    f"{np.array_equal(res.s11, s11_cli)}")
        else:
            same = (f"bit-equal to phase 21's run: "
                    f"{same_result(res, earlier[kind])}")
        s11_db = 20 * np.log10(np.maximum(np.abs(res.s11), 1e-12))
        say("25", f"GUI {kind} ({', '.join(f'{k}={v}' for k, v in kw.items()) or 'defaults'}) "
                  f"grid {sim.grid.shape}, prepared in {prep_s:.2f} s, "
                  f"{sim.pallas_mode} mode; on a worker thread (device "
                  f"{box['device']}, stream {box['stream']:#x}, the main "
                  f"thread's {main_stream:#x}), callbacks wired "
                  f"{sorted(wired) or 'none (the runner takes none)'}, "
                  f"{len(ticks)} ticks; {steps} steps in {box['s']:.3f} s, "
                  f"f_res {res.f_res_hz / 1e9:.4f} GHz, |S11|min "
                  f"{s11_db.min():.2f} dB, Dmax {10 * np.log10(res.Dmax):.3f} "
                  f"dBi; launches { {k: v for k, v in counts.items() if v} }; "
                  f"{same} [{card}]")
        for line in format_port_diagnostics(res):
            say("25", f"  {kind} port diagnostics: {line}")


def wait_run(run, seconds=600.0):
    t0 = time.perf_counter()
    while run.running and time.perf_counter() - t0 < seconds:
        time.sleep(0.001)
    assert not run.running, "background run still running"
    assert run.error is None, run.error
    return time.perf_counter() - t0


def phase_frontends_background(res4, k22, card):
    """(c) ``BackgroundRun`` on the card: the canonical run with monotone
    ticks and a result bit-equal to phase 4's main-thread run; an abort
    after the first tick stopping at one chunk, its state resumed to the
    straight run; ``design_array`` through it equal to phase 22's S."""
    from fdtd_solver_antennas_tpu_torch.frontends.webapp import BackgroundRun
    from fdtd_solver_antennas_tpu_torch.ops.fdtd import chunk_geometry
    from fdtd_solver_antennas_tpu_torch.solvers.array_synth import design_array
    from fdtd_solver_antennas_tpu_torch.solvers.patch_fixed import (
        prepare_patch_fixed, run_prepared_fixed)

    params = canonical_params()
    prep = prepare_patch_fixed(params, device="cuda")
    assert prep.ok, prep.message
    chunk = chunk_geometry(prep.sim)[2]

    def recording(bg, ticks, abort_after_first=False):
        real = bg._on_progress

        def tick(*a):
            ticks.append(a)
            real(*a)
            if abort_after_first:
                bg.abort()
        bg._on_progress = tick
        return bg

    ticks = []
    bg = recording(BackgroundRun(), ticks)
    (wall, res), counts = counted(lambda: (wait_run(bg.start(
        run_prepared_fixed, prep, frequency_hz=params.frequency_hz,
        verbose=0)), bg.result))
    assert_only(counts, {"chunk_steps"}, "background run")
    steps = [t[0] for t in ticks]
    # a tick after every chunk but one that meets the energy criterion,
    # and the final one
    stopped = res.diagnostics["energy_ratio"] < prep.sim.cfg.end_criteria
    assert steps == sorted(steps), steps
    assert len(ticks) == counts["chunk_steps"] + (not stopped), (ticks, counts)
    assert ticks[-1][:2] == (res.steps_run, res.steps_run) == bg.progress[:2]
    assert same_result(res, res4), "BackgroundRun != phase 4's run"
    say("25", f"BackgroundRun(run_prepared_fixed) on the canonical patch: "
              f"{res.steps_run} steps, {len(ticks)} ticks, monotone, last "
              f"{ticks[-1][0]}/{ticks[-1][1]} (energy {ticks[-1][2]:.2e}); "
              f"{counts['chunk_steps']} chunk_steps, nothing else; done in "
              f"{wall:.3f} s of polling; result == phase 4's main-thread run "
              f"bit for bit [{card}]")

    ticks = []
    bg = recording(BackgroundRun(), ticks, abort_after_first=True)
    (wall, out), counts = counted(lambda: (wait_run(bg.start(prep.sim.run)),
                                           bg.result))
    assert out["aborted"] and out["steps"] == chunk == ticks[0][0], (
        out["steps"], chunk, ticks)
    assert counts["chunk_steps"] == 1, counts
    resumed, counts_r = counted(lambda: prep.sim.run(resume_state=out["state"]))
    straight = prep.sim.run()
    assert resumed["steps"] == straight["steps"] == res4.steps_run
    assert counts_r["chunk_steps"] == straight["steps"] // chunk - 1
    err = compare_runs(resumed, straight, "abort resume")
    same = all(torch.equal(x, y) for x, y in zip(resumed["fields"],
                                                 straight["fields"]))
    say("25", f"BackgroundRun(sim.run) aborted after its first tick: stopped "
              f"at {out['steps']} steps (one chunk of {chunk}, "
              f"{counts['chunk_steps']} chunk_steps) in {wall:.3f} s; its "
              f"state resumed on the main thread to {resumed['steps']} steps "
              f"({counts_r['chunk_steps']} chunk_steps) == the straight run "
              f"(uf, if_, nf_e, nf_h, fields), max |err| {err:.3e}, fields "
              f"bit-equal {same} [{card}]")

    ticks = []
    bg = recording(BackgroundRun(), ticks)
    (wall, design), counts = counted(lambda: (wait_run(bg.start(
        design_array, params, 2, 1, device="cuda")), bg.result))
    assert design.ok, design.message
    assert_only(counts, {"chunk_steps"}, "background design_array")
    same = np.array_equal(design.smatrix.s, k22["s"])
    assert same, "design_array through BackgroundRun != phase 22's S"
    say("25", f"BackgroundRun(design_array, 2x1) in {wall:.2f} s: "
              f"{counts['chunk_steps']} chunk_steps, nothing else; ticks "
              f"{[t[:2] for t in ticks]}; S matrix == phase 22's bit for bit "
              f"[{card}]")


def phase_frontends_views(counts4, card):
    """(d) ``open_scene_3d_view`` of phase 8's mixed designer scene, and
    ``utils.tracing.trace`` around a canonical run with
    ``summarize_trace`` naming ``chunk_steps_kernel``."""
    from fdtd_solver_antennas_tpu_torch.frontends.gui_app import (
        open_scene_3d_view)
    from fdtd_solver_antennas_tpu_torch.solvers.patch_fixed import (
        prepare_patch_fixed, run_prepared_fixed)
    from fdtd_solver_antennas_tpu_torch.utils.tracing import (
        summarize_trace, trace)
    from fdtd_solver_antennas_tpu_torch.viz.scene3d import scene_meshes

    scene = mixed_designer()
    os.makedirs("outputs/smoke_scene", exist_ok=True)
    t0 = time.perf_counter()
    path = open_scene_3d_view(scene, "outputs/smoke_scene/mixed_scene.html")
    view_s = time.perf_counter() - t0
    meshes = scene_meshes(scene)
    size = os.path.getsize(path)
    with open(path, encoding="utf-8") as f:
        html = f.read()
    assert len(meshes) >= 10 and all(f'"{m.name}"' in html for m in meshes)
    say("25", f"open_scene_3d_view of the mixed designer scene: {path}, "
              f"{size:,} B, {len(meshes)} meshes, "
              f"{sum(len(m.faces) for m in meshes)} triangles, {view_s:.3f} s")

    params = canonical_params()
    prep = prepare_patch_fixed(params, device="cuda")
    log_dir = "outputs/smoke_trace"
    t0 = time.perf_counter()
    with trace(log_dir):
        res, counts = counted(lambda: run_prepared_fixed(
            prep, frequency_hz=params.frequency_hz, verbose=0))
    traced_s = time.perf_counter() - t0
    assert res.ok and counts["chunk_steps"] == counts4["chunk_steps"], counts
    top = summarize_trace(log_dir, top=20)
    hits = [(n, s, c) for n, s, c in top if "chunk_steps_kernel" in n]
    assert hits and hits[0][2] == counts["chunk_steps"], top[:8]
    name, secs, n = hits[0]
    say("25", f"utils.tracing.trace around the canonical run ({traced_s:.2f} "
              f"s with the trace's export): summarize_trace's top 20 holds "
              f"{name[:60]!r}: {n} events, {secs * 1e3:.3f} ms in all, "
              f"{secs / n * 1e6:.1f} us each; top 5: "
              f"{[(a[:40], round(b * 1e3, 3), c) for a, b, c in top[:5]]} "
              f"[{card}]")


def phase_frontends(res4, counts4, k21, k22, card):
    """25. The frontends slice (``res4``, ``counts4``: phase 4's run and
    launches; ``k21``, ``k22``: phases 21's and 22's results)."""
    t0 = time.perf_counter()
    timed_phase("25", phase_frontends_cli, res4, counts4, card)
    timed_phase("25", phase_frontends_kinds, res4, k21, card)
    timed_phase("25", phase_frontends_background, res4, k22, card)
    timed_phase("25", phase_frontends_views, counts4, card)
    say("25", f"the frontends slice took {time.perf_counter() - t0:.1f} s")


def script_run(tag, fn):
    """``fn()`` (a usage script's function) with its standard output
    captured and every launch count set to 0 just before it; prints the
    script's lines under ``tag`` and returns (result, counts by wrapper and
    route, counts by storage form, seconds)."""
    import contextlib
    import io

    from fdtd_solver_antennas_tpu_torch.ops import fdtd_cuda, fdtd_shard, fdtd_stream

    reset_counts()
    text = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(text):
        out = fn()
    secs = time.perf_counter() - t0
    counts = {k: v for k, v in {**fdtd_cuda.launches, **fdtd_shard.launches,
                                **fdtd_stream.launches,
                                **fdtd_stream.launches_by_kernel}.items() if v}
    forms = {k: v for k, v in fdtd_cuda.launches_by_form.items() if v}
    for ln in text.getvalue().splitlines():
        say("26", f"{tag}| {ln}")
    return out, counts, forms, secs


def assert_launched(counts, want, what):
    """The run launched exactly the kernels of ``want`` (each at least
    once; ``want`` maps a name to its count, or to None for any count)."""
    assert set(counts) == set(want), (what, counts, sorted(want))
    for name, n in want.items():
        assert n is None or counts[name] == n, (what, name, counts[name], n)


def on_thread_with_device(fn):
    """``fn()`` on a new thread; its result and the thread's current CUDA
    device before and after it."""
    import threading

    box = {}

    def work():
        box["before"] = torch.cuda.current_device()
        try:
            box["out"] = fn()
        except BaseException as e:  # re-raised on the calling thread
            box["error"] = e
        box["after"] = torch.cuda.current_device()

    t = threading.Thread(target=work, daemon=True)
    t.start()
    t.join(600)
    assert not t.is_alive(), "worker thread still running"
    if "error" in box:
        raise box["error"]
    return box


def phase_examples(mixed_res, card):
    """26. The usage scripts (``fdtd_solver_antennas_tpu_torch/examples/``)
    on the card, each through its function, files into a temporary
    directory; then the device check of launches from a fresh thread.
    ``mixed_res``: phase 8's mixed-scene result. Returns the kernels
    line's row of ``chunk_steps_batch`` in the form ``design_sweep`` runs
    (its launches there, its numbers at its shapes)."""
    import tempfile

    from fdtd_solver_antennas_tpu_torch.examples import (
        checkpoint_resume, design_sweep, inverse_broadside_gain,
        inverse_miniaturized_patch, mixed_patch_horn, multi_patch_array,
        stream_tune)

    t_all = time.perf_counter()
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        # (a) checkpoint_resume at the JAX script's budgets
        out, counts, forms, secs = script_run(
            "checkpoint_resume", lambda: checkpoint_resume.checkpoint_resume(
                outdir=tmp, device="cuda"))
        assert out["close"] and out["steps"][0] == out["steps"][1]
        assert int(out["first"]["steps"]) >= 4000
        assert_launched(counts, {"chunk_steps": None}, "checkpoint_resume")
        runs["checkpoint_resume"] = (counts, forms)
        say("26", f"(a) checkpoint_resume: first segment "
                  f"{int(out['first']['steps'])} steps, resumed "
                  f"{out['steps'][0]} == straight {out['steps'][1]}, e_ratio "
                  f"{out['e_ratio'][0]:.6e} / {out['e_ratio'][1]:.6e}, max "
                  f"|gap| {max(out['gaps'].values()):.3e}, bit-equal "
                  f"{out['bit_equal']}; launches {counts}, forms {forms}; "
                  f"{secs:.2f} s [{card}]")

        # (b) design_sweep: K1 batched, each dip beside the cavity model
        (prep, res), counts, forms, secs = script_run(
            "design_sweep", lambda: design_sweep.design_sweep(device="cuda"))
        assert prep.sim.pallas_mode == "chunk", prep.sim.pallas_mode_reason
        assert_launched(counts, {"chunk_steps_batch": None}, "design_sweep")
        runs["design_sweep"] = (counts, forms)
        # its form's row of the kernels line: launches from this run,
        # numbers at its shapes
        row = sweep_chunk_row(prep, card, "(b) design_sweep")
        assert forms == {row["form"]: counts["chunk_steps_batch"]}, forms
        batch_row = dict(row, launches=counts["chunk_steps_batch"])
        dips = []
        for (L, W), sp in zip(design_sweep.GEOMETRIES_MM, res.spectra):
            db = 20 * np.log10(np.abs(sp.s11) + 1e-30)
            assert np.isfinite(db).all()
            i = int(np.argmin(db))  # the script's dip: the whole band's
            # phase 16's rule: the deepest dip within ±15% of the cavity
            # model's fundamental (phase 16 holds its patches within 8%)
            f_pred = cavity_f_hz(W)
            win = (sp.freq_hz > 0.85 * f_pred) & (sp.freq_hz < 1.15 * f_pred)
            j = int(np.argmin(np.where(win, db, 0.0)))
            dips.append(f"L {L} W {W} mm: the band's dip {db[i]:.2f} dB at "
                        f"{sp.freq_hz[i] / 1e9:.4f} GHz; near the cavity "
                        f"model's {f_pred / 1e9:.4f} GHz: {db[j]:.2f} dB at "
                        f"{sp.freq_hz[j] / 1e9:.4f} GHz "
                        f"({abs(sp.freq_hz[j] - f_pred) / f_pred:.2%} off)")
        say("26", f"(b) design_sweep {prep.sim.grid.shape}, steps "
                  f"{res.steps.tolist()}, run {res.wall_time_s:.3f} s, "
                  f"{res.mcells_per_s:.1f} aggregate Mcell-updates/s: "
                  + "; ".join(dips)
                  + f"; launches {counts}, forms {forms}; {secs:.2f} s [{card}]")

        # (c) multi_patch_array: the two-patch designer scene on K1
        res, counts, forms, secs = script_run(
            "multi_patch_array", lambda: multi_patch_array.multi_patch_array(
                outdir=tmp, device="cuda"))
        check_result(res, full_sphere=True)
        assert_launched(counts, {"chunk_steps": None}, "multi_patch_array")
        runs["multi_patch_array"] = (counts, forms)
        say("26", f"(c) multi_patch_array: {res.steps_run} steps, f_res "
                  f"{res.f_res_hz / 1e9:.4f} GHz, Dmax "
                  f"{10 * np.log10(res.Dmax):.3f} dBi, {len(res.diagnostics['s11_all_ports'])} "
                  f"ports; launches {counts}, forms {forms}; run "
                  f"{res.wall_time_s:.3f} s, script {secs:.2f} s [{card}]")

        # (d) mixed_patch_horn: the march, == phase 8's run
        res, counts, forms, secs = script_run(
            "mixed_patch_horn", lambda: mixed_patch_horn.mixed_patch_horn(
                outdir=tmp, device="cuda"))
        check_result(res, full_sphere=True)
        steps = res.steps_run
        assert_launched(counts, {"stream_steps": steps // 4,
                                 "stream_march": steps // 4,
                                 "probe_gather": None}, "mixed_patch_horn")
        runs["mixed_patch_horn"] = (counts, forms)
        same = (steps == mixed_res.steps_run and res.f_res_hz == mixed_res.f_res_hz
                and all(np.array_equal(a, b) for a, b in zip(
                    res.diagnostics["s11_all_ports"],
                    mixed_res.diagnostics["s11_all_ports"], strict=True))
                and np.array_equal(res.z_in, mixed_res.z_in))
        assert same, "the script's mixed run differs from phase 8's"
        say("26", f"(d) mixed_patch_horn: {steps} steps in "
                  f"{res.wall_time_s:.3f} s, {res.mcells_per_s:.1f} "
                  f"Mcell-updates/s, == phase 8's run (steps, f_res, both "
                  f"ports' S11, Z_in; bit for bit); launches {counts}; script "
                  f"{secs:.2f} s [{card}]")

        # (e) stream_tune over T = 1..5 on the tall grid
        (recs, outs), counts, forms, secs = script_run(
            "stream_tune", lambda: stream_tune.stream_tune(
                Ts=(1, 2, 3, 4, 5), device="cuda"))
        assert [r["T"] for r in recs] == [1, 2, 3, 4], recs
        assert all(r["uf_gap"] == 0.0 for r in recs), recs
        assert len({r["steps"] for r in recs}) == 1, recs
        assert_launched(counts, {"stream_steps": None, "stream_march": None,
                                 "probe_gather": None}, "stream_tune")
        runs["stream_tune"] = (counts, forms)
        say("26", f"(e) stream_tune: T = 5 skipped (the march's region), "
                  + "; ".join(f"T {r['T']} {r['wall_s']} s, "
                              f"{r['wall_s'] / r['steps'] * 1e6:.2f} us a "
                              f"step, {r['gcells_per_s']} Gcell-updates/s"
                              for r in recs)
                  + f"; every T's uf bit-equal to T = 1's; launches {counts}; "
                  f"{secs:.2f} s [{card}]")
        del outs

        # (f) the inverse-design scripts at their meshes, one iteration
        for name, fn in (
                ("inverse_miniaturized_patch",
                 inverse_miniaturized_patch.inverse_miniaturized_patch),
                ("inverse_broadside_gain",
                 inverse_broadside_gain.inverse_broadside_gain)):
            out, counts, forms, secs = script_run(name, lambda: fn(
                iters=1, outdir=tmp, device="cuda", check_headline=False))
            hist = out["result"].history
            assert len(hist) == 1 and np.isfinite(hist).all(), hist
            assert_launched(counts, {"chunk_steps": None}, name)
            runs[name] = (counts, forms)
            say("26", f"(f) {name}: grid {out['problem'].sim.grid.shape}, "
                      f"{out['problem'].n_steps} differentiable steps, one "
                      f"Adam iteration {out['optimize_s']:.2f} s, loss "
                      f"{hist[0]:.6g}; validate on K1 alone: launches "
                      f"{counts}, forms {forms}; script {secs:.2f} s [{card}]")

    # (g) launches from a fresh thread take the simulation's device
    from fdtd_solver_antennas_tpu_torch.solvers.patch_fixed import (
        prepare_patch_fixed)

    prep = prepare_patch_fixed(canonical_params(), device="cuda")
    sim = prep.sim
    before = torch.cuda.current_device()
    ref = sim.run()
    box = on_thread_with_device(sim.run)
    out = box["out"]
    assert torch.cuda.current_device() == before
    assert box["before"] == box["after"] == sim.device.index, box
    same = int(out["steps"]) == int(ref["steps"]) and all(
        torch.equal(a, b) for a, b in zip(out["fields"], ref["fields"]))
    assert same and np.array_equal(out["uf"], ref["uf"])
    say("26", f"(g) the canonical run from a fresh thread: the thread on "
              f"device {box['before']} before and {box['after']} after, the "
              f"simulation on {sim.device}, the main thread on {before} "
              f"before and {torch.cuda.current_device()} after; bit-equal to "
              f"the main thread's run ({int(out['steps'])} steps); "
              f"{torch.cuda.device_count()} card(s) here, so every launch "
              f"found its device current (fdtd_cuda.launch enters "
              f"torch.cuda.device only for another card) [{card}]")
    say("26", f"launches by script: "
              + "; ".join(f"{k}: {c}, forms {f}" for k, (c, f) in runs.items()))
    say("26", f"the usage-script slice took {time.perf_counter() - t_all:.1f} s")
    return batch_row


def ptxas_kernels(log):
    """(kernel, registers, spills) of each entry function in an nvcc
    ``-Xptxas -v`` log; a template kernel named as name<args>."""
    rows, fn, spill = [], None, ""
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name = m.group(1)
            n = re.match(r"_Z(\d+)", name)
            fn = name[n.end():n.end() + int(n.group(1))] if n else name
            args = re.match(r"I((?:L[ib]-?\d+E)+)E", name[n.end() + len(fn):] if n else "")
            if args:
                fn += f"<{','.join(re.findall(r'L[ib](-?\d+)E', args.group(1)))}>"
            spill = ""
        elif "spill" in ln:
            spill = ln.strip()
        elif "registers" in ln and fn is not None:
            rows.append((fn, ln.split(":", 1)[-1].strip(), spill))
            fn = None
    return rows


def timed_phase(tag, fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    say(tag, f"phase took {time.perf_counter() - t0:.1f} s")
    return out


def main() -> int:
    t_smoke = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "test needs an NVIDIA GPU", file=sys.stderr)
        return 2

    # 1. environment
    card = card_line()
    dev_name = torch.cuda.get_device_name(0)
    say("1", f"python {sys.version.split()[0]}, torch {torch.__version__}, "
             f"CUDA {torch.version.cuda}, device {dev_name}, "
             f"count {torch.cuda.device_count()}")
    print(card, flush=True)

    # 2. build the six libraries at once
    from fdtd_solver_antennas_tpu_torch.ops import (
        _build, chunk_march, fdtd_cuda, fdtd_shard, fdtd_steps, fdtd_stream,
        roll_chain)

    from fdtd_solver_antennas_tpu_torch.native import build as native_build

    def build_native():
        t = time.perf_counter()
        path = native_build.build()
        return path, time.perf_counter() - t

    t0 = time.perf_counter()
    libs = ("fdtd_chunk", "fdtd_chunk_march", "fdtd_stream", "fdtd_shard",
            "fdtd_steps", "roll_chain")
    with concurrent.futures.ThreadPoolExecutor(len(libs) + 1) as pool:
        native = pool.submit(build_native)
        builds = {name: pool.submit(_build.build, name) for name in libs}
        builds = {name: f.result() for name, f in builds.items()}
        native_path, native_s = native.result()
    say("2", f"built {native_path.name} in {native_s:.1f} s (g++ "
             f"{' '.join(native_build.GXX_FLAGS)}; the voxelizer's core)")
    for name, (lib_path, build_s, log) in builds.items():
        say("2", f"built {lib_path.name} in {build_s:.1f} s (nvcc "
                 f"{' '.join(_build.NVCC_FLAGS[:2])})")
        for fn, regs, spill in ptxas_kernels(log):
            say("2", f"ptxas {name}: {fn}: {regs}; {spill}")
    fdtd_cuda._library()
    chunk_march._library()
    fdtd_stream._library()
    fdtd_shard._library()
    fdtd_steps._library()
    roll_chain._library()
    say("2", f"phase took {time.perf_counter() - t0:.1f} s")

    # 3. K1 vs plain on the card
    worst = timed_phase("3", phase_kernel_vs_plain)
    say("3", f"all chunk comparisons agree; worst max |err| {worst:.3e}")
    k1c = timed_phase("3", phase_chunk_steps, card)
    say("3", "all chunk_steps comparisons agree; worst max |err| "
             f"{max(r['max_abs_err'] for r in k1c.values()):.3e}")
    canonical = one_chunk_sim(canonical_scene, "MUR")
    per_kernel = phase_each_kernel(canonical)

    # 4.-6. the canonical slice
    prep, res, counts = timed_phase("4", phase_main_path)
    timed_phase("5", phase_golden)
    step_counts = timed_phase("6", phase_times, prep, res, per_kernel, k1c,
                              card)

    # 7.-10. the large-grid slice
    worst = timed_phase("7", phase_stream_vs_plain, card)
    say("7", f"all stream comparisons agree; worst max |err| {worst:.3e}")
    mixed, mixed_res, mixed_counts, k2 = timed_phase(
        "8", phase_mixed_main_path, card)
    k2["sim"] = mixed
    timed_phase("9", phase_horn_golden)
    timed_phase("10", phase_stream_times, k2, card)

    # 11.-13. the explicit slice
    k3 = timed_phase("11", phase_shard_vs_plain, card)
    say("11", f"all shard comparisons agree; worst max |err| {k3['max_abs_err']:.3e}")
    explicit_res, explicit_counts = timed_phase(
        "12", phase_explicit_main_path, res, card)
    timed_phase("13", phase_explicit_times, k3, explicit_res, explicit_counts,
                card)

    # 14. the interval slice; 15. the roofline slice
    k4 = timed_phase("14", phase_steps_vs_plain, card)
    k4["launches"] = timed_phase("14", phase_steps_main_path, k4, card)
    k5 = timed_phase("15", phase_roll_chain, card)

    # 16. the sweep slice (K1 batched)
    worst, marched_err = timed_phase("16", phase_batch_vs_plain, card)
    say("16", f"all chunk_steps_batch comparisons agree; worst max |err| "
              f"{worst:.3e} (the marched form's {marched_err:.3e})")
    k1b = timed_phase("16", phase_sweep_main_path, marched_err, card)
    timed_phase("16", phase_sweep_physics, card)

    # 17. the explicit slice at Pz > 128 (K2's slab stepper)
    k17 = timed_phase("17", phase_slab_vs_plain, mixed, k2, card)
    say("17", f"all slab comparisons agree; worst max |err| MUR/PEC "
              f"{k17['max_abs_err']:.3e}, CPML {k17['cpml_err']:.3e}")
    _big_res, big_counts = timed_phase(
        "17", phase_explicit_large_main_path, mixed, mixed_res, k2, k17, card)
    k17c = timed_phase("17", phase_slab_cpml, card)

    # 18. the sweep slice in stream mode (K2 batched, its coef_ops_from form)
    k18 = timed_phase("18", phase_stream_batch_vs_plain, card)
    say("18", "all stream_steps_batch comparisons agree; worst max |err| "
              f"MUR {k18['MUR']['max_abs_err']:.3e}, PML_8 "
              f"{k18['PML_8']['max_abs_err']:.3e}")
    k18b = timed_phase("18", phase_stream_sweep_main_path, k18, k1b, card)
    timed_phase("18", phase_stream_sweep_auto, card)

    # 19. the CPML slice: the mixed scene under PML_8 on the march
    k19 = timed_phase("19", phase_mixed_pml_main_path, card)

    # 20. the microstrip slice (MSL and lumped ports, the CLI's s11);
    # 21. microstrip_3d, legacy and quasi-2D
    k20 = timed_phase("20", phase_microstrip_main_path, card)
    k21 = timed_phase("21", phase_solvers_main_path, card)

    # 22. the multi-port slice: the S matrix (two patches on K1, the mixed
    # scene on the march), the 2x1 array, re-excitation, a checkpoint, the
    # CLI's array
    timed_phase("22", phase_two_patch_smatrix, card)
    k22 = timed_phase("22", phase_array_main_path, card)
    k22m = timed_phase("22", phase_mixed_smatrix, k2["prep"], k2, card)

    # 23. the inverse-design slice: the exposed step under autograd, the
    # two objectives' gradients, Adam, validate on K1, the CLI's inverse
    k23 = timed_phase("23", phase_inverse_main_path, card)

    # 24. the parallel slice: the explicit path's per-step walk on K1's
    # per-step kernels, shard_simulation and shard_sweep, in a one-rank
    # NCCL group
    k24 = phase_parallel(mixed, mixed_res, k2, k1b, card)

    # 25. the frontends slice: the CLI's simulate and fdtd with its figures,
    # the GUI's five solver kinds on a worker thread, the web app's
    # BackgroundRun, the 3D scene view and utils.tracing
    phase_frontends(res, counts, k21, k22, card)

    # 26. the usage scripts: checkpoint resume, the design sweep, both
    # designer scenes, the march's operating-point sweep, both inverse
    # designs cut to one iteration; launches from a fresh thread
    k26 = timed_phase("26", phase_examples, mixed_res, card)
    say("26", f"the whole smoke took {time.perf_counter() - t_smoke:.1f} s "
              "(the kernels' build included)")

    keys = ("max_abs_err", "ms", "plain_ms")
    k1 = k1c[("canonical", "MUR", None)]
    # the per-step kernels' launches: h_update, e_update and mur_faces in
    # phase 6's run of the canonical patch through them (their times at
    # the canonical patch, phase 3); probe_gather's launches and times on
    # the mixed scene's main path (phase 8), where it costs the most (its
    # canonical time: phase 3's line)
    probe = k2["probe"]
    table = {"kernels": [
        {"name": "chunk_steps", "route": "cuda", "source": K1_SOURCE,
         "replaces": K1_REPLACES, "launches": counts["chunk_steps"],
         **{k: k1[k] for k in (*keys, "bound_ms", "bound_by")},
         "library_ms": None},
    ] + [
        {"name": name, "route": "cuda", "source": K1_SOURCE,
         "replaces": K1_REPLACES, "launches": step_counts[name],
         **{k: per_kernel[name][k] for k in keys},
         **dict(zip(("bound_ms", "bound_by"), k1_bound(name, canonical))),
         "library_ms": None}
        for name in ("h_update", "e_update", "mur_faces")
    ] + [
        {"name": "probe_gather", "route": "cuda", "source": K1_SOURCE,
         "replaces": K1_REPLACES, "launches": mixed_counts["probe_gather"],
         **{k: probe[k] for k in (*keys, "bound_ms", "bound_by", "library_ms")}},
    ] + [
        {"name": "stream_steps", "route": "cuda", "source": K2_SOURCE,
         "replaces": K2_REPLACES, "launches": mixed_counts["stream_march"],
         **{k: k2[k] for k in (*keys, "bound_ms", "bound_by")},
         "library_ms": None},
        # the CPML march: the mixed scene under PML_8 (phase 19)
        {"name": "stream_steps_cpml", "route": "cuda", "source": K2_SOURCE,
         "replaces": K2_REPLACES, "launches": k19["launches"],
         **{k: k19[k] for k in (*keys, "bound_ms", "bound_by")},
         "library_ms": None},
        {"name": "shard_steps", "route": "cuda", "source": K3_SOURCE,
         "replaces": K3_REPLACES, "launches": explicit_counts["shard_steps"],
         **{k: k3[k] for k in (*keys, "bound_ms", "bound_by")},
         "library_ms": None},
        # K2's shard= form: the slab march on the mixed scene's explicit
        # run (phase 17), under CPML on the tall grid's PML_8 explicit run
        {"name": "stream_shard_steps", "route": "cuda", "source": K2_SOURCE,
         "replaces": K2_REPLACES, "launches": big_counts["shard_march"],
         **{k: k17[k] for k in (*keys, "bound_ms", "bound_by")},
         "library_ms": None},
        {"name": "stream_shard_steps_cpml", "route": "cuda",
         "source": K2_SOURCE, "replaces": K2_REPLACES,
         "launches": k17c["launches"],
         "max_abs_err": max(k17["cpml_err"], k17c["max_abs_err"]),
         **{k: k17c[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
         "library_ms": None},
    ] + [
        {"name": name, "route": "cuda", "source": source, "replaces": replaces,
         "launches": row["launches"],
         **{k: row[k] for k in (*keys, "bound_ms", "bound_by")},
         "library_ms": None}
        for name, source, replaces, row in (
            ("interval_steps", K4_SOURCE, K4_REPLACES, k4),
            ("roll_chain", K5_SOURCE, K5_REPLACES, k5),
            # K1 under jax.vmap (solvers/sweep.py:69-103): the form the
            # 8-variant sweep's plan picks, launches from its main path
            # (phase 16), and the form design_sweep's plan picks, launches
            # from its run and numbers at its shapes (phase 26); no PyTorch
            # call computes a batched Yee chunk
            ("chunk_steps_batch", K1M_SOURCE if k1b["form"] == "marched"
             else K1_SOURCE, K1_REPLACES, k1b),
            (f"chunk_steps_batch_{k26['form']}", K1M_SOURCE
             if k26["form"] == "marched" else K1_SOURCE, K1_REPLACES, k26),
            # K2's coef_ops_from form under jax.vmap: the batched march on
            # the stream sweep's main path (phase 18), and under CPML on one
            # chunk of the same sweep under PML_8
            ("stream_steps_batch", K2_SOURCE, K2_COEF_REPLACES,
             dict(k18["MUR"], launches=k18b["launches"])),
            ("stream_steps_batch_cpml", K2_SOURCE, K2_COEF_REPLACES,
             k18["PML_8"]))
    ] + [
        # the stream sweep's gather, one launch an interval for all
        # variants; library: one cuSPARSE SpMM over the same entries
        {"name": "probe_gather_batch", "route": "cuda", "source": K1_SOURCE,
         "replaces": K1_REPLACES, **k18b["gather"]},
    ] + [
        # K1 on the microstrip slice's main path: the MSL-fed patch under
        # PML_8 (phase 20); K2's CPML march on microstrip_3d at quality 5
        # (phase 21)
        {"name": name, "route": "cuda", "source": source, "replaces": K,
         "launches": row["launches"],
         **{k: row[k] for k in (*keys, "bound_ms", "bound_by")},
         "library_ms": None}
        for name, source, K, row in (
            ("chunk_steps_msl", K1_SOURCE, K1_REPLACES, k20),
            ("stream_steps_cpml_microstrip_3d", K2_SOURCE, K2_REPLACES,
             k21["microstrip_3d q5 PML_8"]),
            # the multi-port slice (phase 22): K1 on the 2x1 array's
            # one-hot runs, timed at the array's shapes; the march on the
            # mixed scene's two one-hot runs, timed at phase 8
            ("chunk_steps_array", K1_SOURCE, K1_REPLACES, k22),
            ("stream_steps_sparams", K2_SOURCE, K2_REPLACES,
             dict(k2, launches=k22m["launches"])),
            # the inverse-design slice (phase 23): K1 on validate's run at
            # D = 1, timed at its shapes (the differentiated loop runs
            # PyTorch's operations: no TPU kernel lies inside it)
            ("chunk_steps_inverse", K1_SOURCE, K1_REPLACES, k23))
    ] + [
        # the parallel slice (phase 24): K1's per-step kernels on the
        # explicit path's walk, timed on the mixed scene's one-rank slab
        # (mur_faces: the mean of an x, y and z launch). h_update and
        # e_update_mur: launches from the mixed scene's walk on the fused
        # route. On the walk only a rank in a straddled wall's exchange
        # launches e_update and mur_faces, which one card cannot hold:
        # their launches come from the same walk run again with
        # Walk.fused forced off, the per-axis route such a rank takes
        {"name": f"{name}_walk", "route": "cuda", "source": K1_SOURCE,
         "replaces": K1_REPLACES, "launches": k24[name]["launches"],
         **{k: k24[name][k] for k in (*keys, "bound_ms", "bound_by")},
         "library_ms": None}
        for name in ("h_update", "e_update", "mur_faces", "e_update_mur")
    ]}
    print(card, flush=True)
    print(json.dumps(table), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev_name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
