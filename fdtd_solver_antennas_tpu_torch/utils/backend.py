"""Backend bring-up helpers.

Counterpart of ``fdtd_solver_antennas_tpu/utils/backend.py``.
:func:`ensure_backend` returns the CUDA devices and raises when CUDA is
asked for and absent; it never falls back to the CPU.
:func:`disable_numpy_hugepage_stalls` is carried over as is and runs when
the package is imported.

The JAX package's ``enable_compile_cache`` has no counterpart here: the
port's kernels are built once per source hash into the package's
``_build/`` directory (``ops/_build.py``), which serves as its cache.
"""

from __future__ import annotations

import os
import time


def disable_numpy_hugepage_stalls() -> None:
    """Stop NumPy from madvising MADV_HUGEPAGE on large allocations.

    NumPy ≥1.18 tags every ≥4 MB allocation with ``madvise(MADV_HUGEPAGE)``.
    On hosts where transparent-huge-page defrag is synchronous (``defrag =
    [madvise]``), the first write to each such allocation stalls in kernel
    page-compaction. ``prepare`` for a 4.2M-cell scene allocates
    gigabytes of NumPy temporaries (voxel masks, edge averages, Ca/Cb
    builds), so these stalls can dominate its wall clock. Host-side THP
    gives no measurable win for this workload — the hot loops stream once
    over each array — so turn the madvise off process-wide at package
    import. Honors an explicit user override via the standard
    ``NUMPY_MADVISE_HUGEPAGE`` env var.
    """
    if os.environ.get("NUMPY_MADVISE_HUGEPAGE"):
        return  # user explicitly chose a policy; respect it
    try:
        try:
            from numpy._core import multiarray as _ma  # numpy >= 2
        except ImportError:  # pragma: no cover - numpy 1.x fallback
            from numpy.core import multiarray as _ma
        _ma._set_madvise_hugepage(False)
    except Exception:
        pass  # private API; absence just means slower prepare, not failure


def ensure_backend(device: str = "cuda", retries: int = 5,
                   delay_s: float = 5.0):
    """The devices of ``device``'s type, initializing CUDA first.

    For ``"cuda"`` returns ``[torch.device("cuda", i), ...]``; raises
    ``RuntimeError`` when this PyTorch has no CUDA or sees no card, and
    retries a failing initialization (``torch.cuda.init``) ``retries``
    times ``delay_s`` apart before raising its error. ``"cpu"`` returns
    ``[torch.device("cpu")]``.
    """
    import torch

    kind = torch.device(device).type
    if kind == "cpu":
        return [torch.device("cpu")]
    if kind != "cuda":
        raise ValueError(f"unsupported device {device!r}")
    if not torch.backends.cuda.is_built():
        raise RuntimeError(
            f"device {device!r} asked for, but this PyTorch "
            f"({torch.__version__}) is built without CUDA")
    last = None
    for attempt in range(max(1, int(retries))):
        try:
            torch.cuda.init()
            n = torch.cuda.device_count()
            if n == 0:
                raise RuntimeError("CUDA initialized but sees no device")
            return [torch.device("cuda", i) for i in range(n)]
        except RuntimeError as e:
            last = e
            if attempt < retries - 1:
                time.sleep(delay_s)
    raise RuntimeError(f"device {device!r} asked for, but CUDA is "
                       f"unavailable: {last}") from last
