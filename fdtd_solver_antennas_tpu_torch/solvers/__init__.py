"""Solvers in the probe → prepare → run protocol."""

from .sweep import (
    SweepPrepared,
    SweepResult,
    prepare_horn_aperture_sweep,
    prepare_patch_geometry_sweep,
    run_horn_aperture_sweep,
    run_patch_geometry_sweep,
)

__all__ = [
    "SweepPrepared",
    "SweepResult",
    "prepare_horn_aperture_sweep",
    "prepare_patch_geometry_sweep",
    "run_horn_aperture_sweep",
    "run_patch_geometry_sweep",
]
