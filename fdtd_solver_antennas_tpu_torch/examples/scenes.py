"""The large scenes the card's checks and timings run, and their timer.

Shared by ``chip_smoke.py`` at the repository root and by
``examples/compare_builds.py``, which loads this file from beside itself
and builds the scenes with whatever copy of the package it has imported,
so that two checkouts are timed on the same scenes.

- :func:`mixed_designer`: the mixed patch+horn scene of the JAX package's
  bench (141×201×152 array cells at mesh quality 2);
- :func:`tall_scene`: the tall patch, 161×121×160 lines;
- :func:`shard_sim`: a scene's simulation padded for an x-split;
- :func:`sweep_variants`, :func:`sweep_operands`: ``bench.py``'s
  8-variant geometry sweep and its batched operands;
- :func:`device_ms`: device milliseconds per call, CUDA events behind a
  sleep kernel; :func:`card_line`: the card's name and power limit.
"""

from __future__ import annotations

import subprocess
import time

import numpy as np
import torch


def card_line() -> str:
    """Name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def device_ms(fn, reps=20, warmup=5) -> float:
    """Device milliseconds per call: a sleep kernel holds the stream while
    the calls are queued behind it, so the CUDA events bracket device work
    only, not the host's launch overhead (reps stays small enough that the
    queue never fills)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)  # ~50 ms at the H100's clocks
    t0 = time.perf_counter()
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    queued = time.perf_counter() - t0
    b.synchronize()
    if queued > 0.04:
        raise RuntimeError(f"queueing took {queued * 1e3:.1f} ms, past the "
                           "sleep: the device time would include host time")
    return a.elapsed_time(b) / reps


def canonical_params():
    from fdtd_solver_antennas_tpu_torch.models.params import PatchAntennaParams

    return PatchAntennaParams.from_user_units(
        frequency_ghz=2.45, er=4.3, h_mm=1.6, loss_tangent=0.02)


def mixed_designer():
    """The mixed patch+horn scene of the JAX package's bench: the 2.45 GHz
    FR-4 patch and the 86×43 → 150×110×60 mm horn at x = 0.18 m, rotated
    25° about z, mesh quality 2."""
    from fdtd_solver_antennas_tpu_torch import HornAntennaParams
    from fdtd_solver_antennas_tpu_torch.frontends.designer import MultiPatchScene

    scene = MultiPatchScene(device="cuda")
    scene.add_patch(canonical_params())
    scene.add_horn(
        HornAntennaParams.from_user_units(
            frequency_ghz=2.45, throat_a_mm=86.0, throat_b_mm=43.0,
            aperture_A_mm=150.0, aperture_B_mm=110.0, length_mm=60.0),
        center_x_m=0.18, rot_z_deg=25.0)
    scene.controls.mesh_quality = 2
    return scene


def tall_scene():
    """The tall patch: 161×121×160 lines, 3.05M cells."""
    from fdtd_solver_antennas_tpu_torch.models.scene import Scene
    from fdtd_solver_antennas_tpu_torch.ops.mesh import MeshBuilder

    mb = MeshBuilder()
    mb.add_line("x", list(np.linspace(-60, 60, 161)) + [-6.0])
    mb.add_line("y", np.linspace(-45, 45, 121))
    mb.add_line("z", np.linspace(-40, 56, 160))
    grid = mb.build(4.0)
    scene = Scene()
    scene.add_material_box("sub", 4.3, 0.005, [-20, -20, 0], [20, 20, 1.6], 0)
    scene.add_metal_box("patch", [-15, -12, 1.6], [15, 12, 1.6], priority=10)
    scene.add_metal_box("gnd", [-20, -20, 0], [20, 20, 0], priority=10)
    scene.add_lumped_port(1, 50.0, [-6, 0, 0], [-6, 0, 1.6], direction="z")
    return scene, grid, 2.45e9, 1.225e9


def shard_sim(make_scene, boundary, n_dev, decim):
    """A simulation padded for an x-split over ``n_dev`` ranks."""
    from fdtd_solver_antennas_tpu_torch.ops.fdtd import FDTDConfig, build_simulation

    scene, grid, f0, fc = make_scene()
    cfg = FDTDConfig(n_steps_max=480, check_every=480, end_criteria=1e-30,
                     boundary=boundary, probe_decimation=decim)
    return build_simulation(
        scene, grid, f0=f0, fc=fc, cfg=cfg, device="cuda",
        port_freqs_hz=np.linspace(2e9, 3e9, 51), nf_freqs_hz=np.array([2.45e9]),
        nf_margin_cells=2, pad_multiple=(n_dev, 1, 1))


def sweep_variants(n=8):
    """``bench.py``'s sweep: canonical-patch variants, W 37.26 + 0.5·i mm,
    L 28.83 + 0.4·i mm."""
    from fdtd_solver_antennas_tpu_torch.models.params import PatchAntennaParams

    return [PatchAntennaParams.from_user_units(
        frequency_ghz=2.45, er=4.3, h_mm=1.6, loss_tangent=0.02,
        W_mm=37.26 + 0.5 * i, L_mm=28.83 + 0.4 * i) for i in range(n)]


def sweep_operands(prep):
    """The batched operands of a prepared sweep: the base's, with each
    variant's ca and cb."""
    from fdtd_solver_antennas_tpu_torch.ops import fdtd_cuda

    c = prep.batched_coeffs
    return fdtd_cuda.batch_operands(
        prep.sim.operands, [c["ca_" + k] for k in ("ex", "ey", "ez")],
        [c["cb_" + k] for k in ("ex", "ey", "ez")])
