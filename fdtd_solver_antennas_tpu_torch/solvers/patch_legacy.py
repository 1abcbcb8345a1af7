"""Legacy 3D patch solver on PyTorch.

Counterpart of ``fdtd_solver_antennas_tpu/solvers/patch_legacy.py``, the
reference's earlier solver variant: substrate and ground spanning the
whole 200×200 mm footprint, feed probe at x = −0.2·W, PML-8 walls,
NrTS = 60000, EndCriteria 1e-5, and a full-sphere NF2FF grid (θ: 91
points over 0..π, φ: 181 points over 0..2π, in radians — the legacy
module passes radians through, unlike the newer solvers' degrees).

``device`` chooses where the run steps: 'cuda' launches the CUDA kernels,
'cpu' runs their plain PyTorch twins.
"""

from __future__ import annotations

import numpy as np

from ..models.params import PatchAntennaParams
from ..models.scene import Scene
from ..ops.fdtd import FDTDConfig, build_simulation
from ..ops.mesh import MeshBuilder
from ..physics import C0, design_patch_for_frequency, substrate_conductivity
from .base import FDTDSolverResult, SolverPrepared, SolverProbe
from .patch_fixed import probe_fdtd, run_single_port


def probe_openems(device="cuda") -> SolverProbe:
    """Capability check under the legacy name: can the engine run on
    ``device``?"""
    return probe_fdtd(device)


def prepare_patch_legacy(
    params: PatchAntennaParams,
    *,
    device="cuda",
    verbose: int = 0,
    n_steps_max: int = 60_000,
    end_criteria: float = 1e-5,
) -> SolverPrepared:
    """Build the legacy scene (λ/20 mesh, PML_8) and its simulation on
    ``device``."""
    try:
        f0 = params.frequency_hz
        fc = f0 / 2.0

        if params.patch_length_m and params.patch_width_m:
            L = params.patch_length_m * 1e3  # along y
            W = params.patch_width_m * 1e3  # along x
        else:
            L_m, W_m, _ = design_patch_for_frequency(f0, params.eps_r, params.h_m)
            L, W = L_m * 1e3, W_m * 1e3
        h = params.h_m * 1e3

        feed_x = -0.2 * W  # legacy feed fraction
        sim_box = np.array([200.0, 200.0, 150.0])
        kappa = substrate_conductivity(f0, params.eps_r, params.loss_tangent)

        # substrate + ground span the full footprint
        half_x, half_y = sim_box[0] / 2.0, sim_box[1] / 2.0
        scene = Scene()
        scene.add_material_box(
            "substrate", params.eps_r, kappa,
            [-half_x, -half_y, 0.0], [half_x, half_y, h], priority=0,
        )
        scene.add_metal_box(
            "gnd", [-half_x, -half_y, 0.0], [half_x, half_y, 0.0], priority=10
        )
        scene.add_metal_box(
            "patch", [-W / 2, -L / 2, h], [W / 2, L / 2, h], priority=10
        )
        scene.add_lumped_port(
            1, 50.0, [feed_x, 0.0, 0.0], [feed_x, 0.0, h], direction="z"
        )

        res = C0 / (f0 + fc) / 1e-3 / 20.0
        mb = MeshBuilder()
        mb.add_line("x", [-half_x, half_x])
        mb.add_line("y", [-half_y, half_y])
        mb.add_line("z", [-sim_box[2] / 3.0, sim_box[2] * 2.0 / 3.0])
        mb.add_line("z", np.linspace(0.0, h, 5))
        mb.add_metal_edges(
            [-W / 2, -L / 2, h], [W / 2, L / 2, h], dirs="xy",
            metal_edge_res=res / 2.0,
        )
        mb.add_line("x", [float(feed_x)])
        mb.add_line("y", [0.0])
        grid = mb.build(res, ratio=1.4)

        cfg = FDTDConfig(
            n_steps_max=n_steps_max, end_criteria=end_criteria,
            boundary="PML_8",
        )
        sim = build_simulation(scene, grid, f0=f0, fc=fc, cfg=cfg,
                               device=device)

        # legacy stores radians
        theta = np.linspace(0.0, np.pi, 91)
        phi = np.linspace(0.0, 2.0 * np.pi, 181)
        nf_center = np.array([0.0, 0.0, 1e-3])

        if verbose:
            print(
                f"legacy solver prepared: W(x)={W:.2f} L(y)={L:.2f} h={h:.3f} "
                f"feed_x={feed_x:.2f}, grid {grid.shape}, device {sim.device}"
            )
        return SolverPrepared(
            True,
            f"Legacy patch prepared (PML_8, grid {grid.shape})",
            sim=sim,
            theta=theta,
            phi=phi,
            nf_center=nf_center,
        )
    except Exception as e:
        return SolverPrepared(False, f"prepare failed: {e}")


def run_prepared_legacy(
    prepared: SolverPrepared,
    *,
    frequency_hz: float,
    verbose: int = 1,
) -> FDTDSolverResult:
    """Run + S11 + the full-sphere pattern (θ, φ in radians)."""
    try:
        if not prepared.ok or prepared.sim is None:
            return FDTDSolverResult(False, prepared.message)
        return run_single_port(
            prepared, frequency_hz=frequency_hz,
            message="openEMS-equivalent FDTD completed",
            angles_in_radians=True)
    except Exception as e:
        return FDTDSolverResult(False, f"run failed: {e}")


# Reference-parity aliases
prepare_openems_patch = prepare_patch_legacy
run_prepared_openems = run_prepared_legacy
