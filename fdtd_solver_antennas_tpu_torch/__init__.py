"""PyTorch and CUDA port of the patch-antenna FDTD framework.

Counterpart of ``fdtd_solver_antennas_tpu`` (the JAX package, which stays
the reference). The module tree and names follow it. The port imports
``torch`` and NumPy, never JAX. On a CUDA device the Yee step runs the
hand-written kernels of ``csrc/``; on the CPU it runs their plain PyTorch
twins (``ops/fdtd_cuda.py``).
"""

from .models.params import Metal, MetalProperties, PatchAntennaParams, metal_defaults
from .solvers.base import FDTDSolverResult, SolverPrepared, SolverProbe
from .solvers.patch_fixed import prepare_patch_fixed, probe_fdtd, run_prepared_fixed

__all__ = [
    "Metal",
    "MetalProperties",
    "PatchAntennaParams",
    "metal_defaults",
    "FDTDSolverResult",
    "SolverPrepared",
    "SolverProbe",
    "prepare_patch_fixed",
    "probe_fdtd",
    "run_prepared_fixed",
]
