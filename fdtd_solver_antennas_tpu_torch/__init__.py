"""PyTorch and CUDA port of the patch-antenna FDTD framework.

Counterpart of ``fdtd_solver_antennas_tpu`` (the JAX package, which stays
the reference). The module tree and names follow it. The port imports
``torch`` and NumPy, never JAX. On a CUDA device the Yee step runs the
hand-written kernels of ``csrc/``; on the CPU it runs their plain PyTorch
twins (``ops/fdtd_cuda.py``).
"""

from .models.params import (
    HornAntennaParams,
    Metal,
    MetalProperties,
    PatchAntennaParams,
    metal_defaults,
)
from .solvers.analytical import AnalyticalPatchSolver, SolverResult
from .solvers.base import FDTDSolverResult, SolverPrepared, SolverProbe
from .solvers.microstrip import (
    FeedDirection,
    calculate_microstrip_width,
    prepare_microstrip_patch,
    run_prepared_microstrip,
)
from .solvers.microstrip_3d import (
    prepare_microstrip_patch_3d,
    run_prepared_microstrip_3d,
)
from .solvers.patch_2d import Prepared2D, prepare_patch_2d, run_prepared_2d
from .solvers.patch_fixed import prepare_patch_fixed, probe_fdtd, run_prepared_fixed
from .solvers.patch_legacy import prepare_patch_legacy, run_prepared_legacy
from .solvers.sparams import SMatrixResult, compute_s_matrix
from .solvers.array_synth import (
    ArrayPattern,
    EmbeddedPatternSet,
    compute_embedded_patterns,
)

__all__ = [
    "AnalyticalPatchSolver",
    "SolverResult",
    "FeedDirection",
    "calculate_microstrip_width",
    "prepare_microstrip_patch",
    "run_prepared_microstrip",
    "prepare_microstrip_patch_3d",
    "run_prepared_microstrip_3d",
    "Prepared2D",
    "prepare_patch_2d",
    "run_prepared_2d",
    "prepare_patch_legacy",
    "run_prepared_legacy",
    "HornAntennaParams",
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
    "SMatrixResult",
    "compute_s_matrix",
    "ArrayPattern",
    "EmbeddedPatternSet",
    "compute_embedded_patterns",
]
