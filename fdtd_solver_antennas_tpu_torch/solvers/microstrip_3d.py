"""Full-sphere microstrip patch solver on PyTorch.

Counterpart of ``fdtd_solver_antennas_tpu/solvers/microstrip_3d.py``: the
microstrip solver's geometry with φ = 0..360° sampling at configurable
θ/φ steps and the mesh-quality → points-per-wavelength map
{1:12, 2:16, 3:20, 4:25, 5:32}. The transform covers the whole (θ, φ)
grid in one pass on the run's device.

``device`` chooses where the run steps: 'cuda' launches the CUDA kernels,
'cpu' runs their plain PyTorch twins.
"""

from __future__ import annotations

import numpy as np

from ..models.params import PatchAntennaParams
from ..physics import C0
from .base import FDTDSolverResult, SolverPrepared
from .microstrip import FeedDirection, prepare_at_mesh
from .patch_fixed import run_single_port

PPW_MAP = {1: 12.0, 2: 16.0, 3: 20.0, 4: 25.0, 5: 32.0}


def prepare_microstrip_patch_3d(
    params: PatchAntennaParams,
    *,
    device="cuda",
    feed_direction: FeedDirection = FeedDirection.NEG_X,
    feed_line_length_mm: float = 20.0,
    boundary: str = "MUR",
    theta_step_deg: float = 2.0,
    phi_step_deg: float = 5.0,
    mesh_quality: int = 3,
    verbose: int = 0,
    n_steps_max: int = 30_000,
    end_criteria: float = 1e-4,
) -> SolverPrepared:
    """Build the microstrip patch at the mesh of ``mesh_quality`` (1..5,
    clamped; 3 when it is not a number): λ/ppw at f0 + fc, ppw from
    :data:`PPW_MAP`; and its simulation on ``device``."""
    try:
        f0 = params.frequency_hz
        try:
            q = int(mesh_quality)
        except (TypeError, ValueError):
            q = 3
        q = max(1, min(5, q))
        ppw = PPW_MAP[q]
        mesh_res = C0 / (f0 + f0 / 2.0) / 1e-3 / ppw
        t_step = max(0.5, float(theta_step_deg))
        p_step = max(1.0, float(phi_step_deg))
        return prepare_at_mesh(
            params, mesh_res, np.arange(0.0, 181.0, t_step),
            np.arange(0.0, 360.0 + p_step, p_step),
            f"Microstrip 3D (quality {q} → {ppw:g} ppw)",
            device=device, feed_direction=feed_direction,
            feed_line_length_mm=feed_line_length_mm, boundary=boundary,
            port_mode="lumped", verbose=verbose, n_steps_max=n_steps_max,
            end_criteria=end_criteria)
    except Exception as e:
        return SolverPrepared(False, f"Microstrip 3D prepare failed: {e}")


def run_prepared_microstrip_3d(
    prepared: SolverPrepared,
    *,
    frequency_hz: float,
    verbose: int = 1,
    run=None,
) -> FDTDSolverResult:
    """Run + S11 + the full-sphere pattern. ``run`` replaces
    ``sim.run`` (``patch_fixed.run_single_port``)."""
    try:
        if not prepared.ok or prepared.sim is None:
            return FDTDSolverResult(False, prepared.message)
        return run_single_port(
            prepared, frequency_hz=frequency_hz,
            message="Microstrip 3D pattern computed", run=run)
    except Exception as e:
        return FDTDSolverResult(False, f"Microstrip 3D run failed: {e}")


# Reference-parity aliases
prepare_openems_microstrip_patch_3d = prepare_microstrip_patch_3d
run_prepared_openems_microstrip_3d = run_prepared_microstrip_3d
