"""Solvers in the probe → prepare → run protocol."""

from .analytical import AnalyticalPatchSolver, SolverResult
from .base import (
    FDTDSolverResult,
    OpenEMSPrepared,
    OpenEMSProbe,
    OpenEMSResult,
    SolverPrepared,
    SolverProbe,
)
from .sweep import (
    SweepPrepared,
    SweepResult,
    prepare_horn_aperture_sweep,
    prepare_patch_geometry_sweep,
    run_horn_aperture_sweep,
    run_patch_geometry_sweep,
)

__all__ = [
    "AnalyticalPatchSolver",
    "SolverResult",
    "SolverProbe",
    "SolverPrepared",
    "FDTDSolverResult",
    "OpenEMSProbe",
    "OpenEMSPrepared",
    "OpenEMSResult",
    "SweepPrepared",
    "SweepResult",
    "prepare_horn_aperture_sweep",
    "prepare_patch_geometry_sweep",
    "run_horn_aperture_sweep",
    "run_patch_geometry_sweep",
]
