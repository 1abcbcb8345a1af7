"""PyTorch and CUDA port of the patch-antenna FDTD framework.

Counterpart of ``fdtd_solver_antennas_tpu`` (the JAX package, which stays
the reference). The module tree and names follow it, and ``__all__`` holds
every name of the JAX package's. The port imports ``torch`` and NumPy,
never JAX. On a CUDA device the Yee step runs the hand-written kernels of
``csrc/``; on the CPU it runs their plain PyTorch twins
(``ops/fdtd_cuda.py``). The plotting names resolve on first use (PEP 562),
so importing the package needs no matplotlib.
"""

from .utils.backend import disable_numpy_hugepage_stalls as _no_thp

_no_thp()  # see utils/backend.py: THP defrag stalls slow the prepare
del _no_thp

from .models.params import (
    HornAntennaParams,
    Metal,
    MetalProperties,
    PatchAntennaParams,
    metal_defaults,
)
from .solvers.analytical import AnalyticalPatchSolver, SolverResult
from .solvers.base import (
    FDTDSolverResult,
    OpenEMSPrepared,
    OpenEMSProbe,
    OpenEMSResult,
    SolverPrepared,
    SolverProbe,
)
from .solvers.patch_fixed import (
    prepare_openems_patch_fixed,
    prepare_patch_fixed,
    probe_fdtd,
    probe_openems_fixed,
    run_prepared_fixed,
    run_prepared_openems_fixed,
)
from .solvers.microstrip import (
    FeedDirection,
    calculate_microstrip_width,
    prepare_microstrip_patch,
    prepare_openems_microstrip_patch,
    probe_openems_microstrip,
    run_prepared_microstrip,
    run_prepared_openems_microstrip,
)
from .solvers.microstrip_3d import (
    prepare_microstrip_patch_3d,
    prepare_openems_microstrip_patch_3d,
    run_prepared_microstrip_3d,
    run_prepared_openems_microstrip_3d,
)
from .solvers.multi_patch_3d import (
    HornLike,
    PatchLike,
    prepare_multi_patch_3d,
    prepare_openems_microstrip_multi_3d,
    run_prepared_multi_patch_3d,
    run_prepared_openems_microstrip_multi_3d,
)
from .solvers.patch_legacy import (
    prepare_openems_patch,
    prepare_patch_legacy,
    probe_openems,
    run_prepared_legacy,
    run_prepared_openems,
)
from .solvers.patch_2d import (
    OpenEMS2DPrepared,
    Prepared2D,
    prepare_openems_patch_2d,
    prepare_patch_2d,
    run_prepared_2d,
)
from .solvers.horn import prepare_horn, run_prepared_horn, te10_guide_wavelength
from .solvers.sparams import SMatrixResult, compute_s_matrix
from .solvers.array_synth import (
    ArrayPattern,
    EmbeddedPatternSet,
    compute_embedded_patterns,
)

from .viz import _PLOTTING

__version__ = "0.1.0"

__all__ = [
    # Domain models
    "PatchAntennaParams",
    "HornAntennaParams",
    "Metal",
    "MetalProperties",
    "metal_defaults",
    # Analytical solver
    "AnalyticalPatchSolver",
    "SolverResult",
    # FDTD solver protocol
    "SolverProbe",
    "SolverPrepared",
    "FDTDSolverResult",
    "OpenEMSProbe",
    "OpenEMSPrepared",
    "OpenEMSResult",
    # Fixed patch solver
    "probe_fdtd",
    "prepare_patch_fixed",
    "run_prepared_fixed",
    "probe_openems_fixed",
    "prepare_openems_patch_fixed",
    "run_prepared_openems_fixed",
    # Microstrip solvers
    "FeedDirection",
    "calculate_microstrip_width",
    "prepare_microstrip_patch",
    "run_prepared_microstrip",
    "probe_openems_microstrip",
    "prepare_openems_microstrip_patch",
    "run_prepared_openems_microstrip",
    "prepare_microstrip_patch_3d",
    "run_prepared_microstrip_3d",
    "prepare_openems_microstrip_patch_3d",
    "run_prepared_openems_microstrip_3d",
    # Multi-patch solver
    "HornLike",
    "PatchLike",
    "prepare_multi_patch_3d",
    "run_prepared_multi_patch_3d",
    "prepare_openems_microstrip_multi_3d",
    "run_prepared_openems_microstrip_multi_3d",
    # Legacy full-sphere solver
    "probe_openems",
    "prepare_patch_legacy",
    "run_prepared_legacy",
    "prepare_openems_patch",
    "run_prepared_openems",
    # Horn solver
    "prepare_horn",
    "run_prepared_horn",
    "te10_guide_wavelength",
    # N-port S-matrix extraction
    "SMatrixResult",
    "compute_s_matrix",
    # Embedded element patterns + array synthesis
    "ArrayPattern",
    "EmbeddedPatternSet",
    "compute_embedded_patterns",
    # Quasi-2D solver
    "Prepared2D",
    "OpenEMS2DPrepared",
    "prepare_patch_2d",
    "run_prepared_2d",
    "prepare_openems_patch_2d",
    # Plotting (matplotlib, resolved on first use)
    *_PLOTTING,
]


def __getattr__(name):
    if name in _PLOTTING:
        from . import viz

        return getattr(viz, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
