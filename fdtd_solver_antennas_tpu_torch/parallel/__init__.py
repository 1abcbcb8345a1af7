"""Multi-device runs (counterpart of ``fdtd_solver_antennas_tpu/parallel``)."""

from .explicit import build_explicit_run

__all__ = ["build_explicit_run"]
