"""Build the CUDA sources in ``csrc/`` with ``nvcc`` and load them.

Counterpart of ``fdtd_solver_antennas_tpu/native/build.py``: one shared
library with a plain C interface, built at first use and loaded with
``ctypes``. The library is named by a hash of its sources and flags, so
an edited source never loads a stale build. Builds go to ``_build/``
beside the package (listed in ``.gitignore``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: dict = {}


def find_nvcc() -> str:
    """``nvcc`` from PATH, else from ``$CUDA_HOME`` or ``/usr/local/cuda``."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin); the "
        "CUDA kernels of fdtd_solver_antennas_tpu_torch need the CUDA toolkit"
    )


def build(name: str = "fdtd_chunk") -> tuple[Path, float, str]:
    """Compile ``csrc/<name>.cu`` unless a build of the same source exists.

    Returns ``(library path, build seconds, compiler log)``; seconds and
    log are 0 and "" when an existing build was reused.
    """
    src = CSRC / f"{name}.cu"
    text = src.read_bytes()
    tag = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"lib{name}_{tag}.so"
    if lib.exists():
        return lib, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
    os.replace(tmp, lib)  # atomic: a concurrent builder sees all or nothing
    (BUILD_DIR / f"lib{name}_{tag}.log").write_text(log)
    return lib, seconds, log


def load(name: str = "fdtd_chunk") -> ctypes.CDLL:
    """The loaded library, built first if needed (once per process)."""
    if name not in _LIBS:
        path, _, _ = build(name)
        _LIBS[name] = ctypes.CDLL(str(path))
    return _LIBS[name]
