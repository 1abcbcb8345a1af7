"""Quasi-2D patch solver on PyTorch.

Counterpart of ``fdtd_solver_antennas_tpu/solvers/patch_2d.py``: a thin
y-slice (max(6 mm, L/40)) of the patch cross-section for fast sanity
checks: PML-8 walls, NrTS = 60000, EndCriteria 1e-5, λ/25 mesh (slightly
finer than 3D), NF2FF sampled on 4 φ cuts (θ, φ in radians).

``device`` chooses where the run steps: 'cuda' launches the CUDA kernels,
'cpu' runs their plain PyTorch twins.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..models.params import PatchAntennaParams
from ..models.scene import Scene
from ..ops.fdtd import FDTDConfig, build_simulation
from ..ops.mesh import MeshBuilder
from ..physics import C0, design_patch_for_frequency, substrate_conductivity
from .base import FDTDSolverResult, SolverPrepared
from .patch_fixed import run_single_port


@dataclasses.dataclass
class Prepared2D(SolverPrepared):
    """Parity alias of the reference's ``OpenEMS2DPrepared``."""


def prepare_patch_2d(
    params: PatchAntennaParams,
    *,
    device="cuda",
    verbose: int = 0,
    n_steps_max: int = 60_000,
    end_criteria: float = 1e-5,
) -> Prepared2D:
    """Build the thin-slice scene and its simulation on ``device``."""
    try:
        f0 = params.frequency_hz
        fc = f0 / 2.0

        if params.patch_length_m and params.patch_width_m:
            L = params.patch_length_m * 1e3
            W = params.patch_width_m * 1e3
        else:
            L_m, W_m, _ = design_patch_for_frequency(f0, params.eps_r, params.h_m)
            L, W = L_m * 1e3, W_m * 1e3
        h = params.h_m * 1e3

        slice_len = max(6.0, L / 40.0)  # thin y-slice
        feed_x = -6.0
        res = C0 / (f0 + fc) / 1e-3 / 25.0  # λ/25
        sim_box = np.array([200.0, 200.0, 150.0])

        kappa = substrate_conductivity(f0, params.eps_r, params.loss_tangent)
        sub_w = 60.0
        sub_l = max(60.0, slice_len)

        scene = Scene()
        scene.add_material_box(
            "substrate", params.eps_r, kappa,
            [-sub_w / 2, -sub_l / 2, 0.0], [sub_w / 2, sub_l / 2, h], priority=0,
        )
        scene.add_metal_box(
            "gnd", [-sub_w / 2, -sub_l / 2, 0.0], [sub_w / 2, sub_l / 2, 0.0],
            priority=10,
        )
        scene.add_metal_box(
            "patch", [-W / 2, -slice_len / 2, h], [W / 2, slice_len / 2, h],
            priority=10,
        )
        scene.add_lumped_port(
            1, 50.0, [feed_x, 0.0, 0.0], [feed_x, 0.0, h], direction="z"
        )

        mb = MeshBuilder()
        mb.add_line("x", [-sim_box[0] / 2, -W / 2, 0.0, W / 2, sim_box[0] / 2])
        mb.add_line("y", [-slice_len / 2, 0.0, slice_len / 2])
        # keep the slice thin: pad y just enough for the 8-cell PML to sit
        # outside the ground edge instead of widening to the full ±100 mm
        y_pad = sub_l / 2 + 8.0 * res
        mb.add_line("y", [-y_pad, y_pad])
        mb.add_line("z", [-sim_box[2] / 3.0, 0.0, h, sim_box[2] * 2.0 / 3.0])
        mb.add_line("z", np.linspace(0.0, h, 5))
        mb.add_metal_edges(
            [-W / 2, -slice_len / 2, h], [W / 2, slice_len / 2, h],
            dirs="xy", metal_edge_res=res / 2.0,
        )
        mb.add_line("x", [float(feed_x)])
        grid = mb.build(res, ratio=1.4)

        cfg = FDTDConfig(
            n_steps_max=n_steps_max, end_criteria=end_criteria, boundary="PML_8"
        )
        sim = build_simulation(scene, grid, f0=f0, fc=fc, cfg=cfg,
                               device=device)

        theta = np.linspace(0.0, np.pi, 121)  # radians
        phi = np.array([0.0, np.pi / 2, np.pi, 3 * np.pi / 2])
        nf_center = np.array([0.0, 0.0, 1e-3])

        if verbose:
            print(f"2D slice prepared: W={W:.1f} slice={slice_len:.1f} mm, "
                  f"device {sim.device}")
        return Prepared2D(
            True,
            f"Prepared 2D-like slice (grid {grid.shape})",
            sim=sim,
            theta=theta,
            phi=phi,
            nf_center=nf_center,
        )
    except Exception as e:
        return Prepared2D(False, f"prepare_2d failed: {e}")


def run_prepared_2d(
    prepared: Prepared2D,
    *,
    frequency_hz: float,
    verbose: int = 1,
) -> FDTDSolverResult:
    """Run + S11 + the pattern on 4 φ cuts (θ, φ in radians)."""
    try:
        if not prepared.ok or prepared.sim is None:
            return FDTDSolverResult(False, prepared.message)
        return run_single_port(
            prepared, frequency_hz=frequency_hz,
            message="Quasi-2D FDTD completed",
            angles_in_radians=True)
    except Exception as e:
        return FDTDSolverResult(False, f"2D run failed: {e}")


# Reference-parity aliases
OpenEMS2DPrepared = Prepared2D
prepare_openems_patch_2d = prepare_patch_2d
