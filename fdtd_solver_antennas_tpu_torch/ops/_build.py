"""Build the CUDA sources in ``csrc/`` with ``nvcc`` and load them.

Counterpart of ``fdtd_solver_antennas_tpu/native/build.py``: one shared
library with a plain C interface, built at first use and loaded with
``ctypes``. The library is named by a hash of its sources (the ``.cu``
file and the ``csrc/`` headers it includes) and flags, so an edited
source or header never loads a stale build. Builds go to ``_build/``
beside the package (listed in ``.gitignore``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
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
_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


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


def sources(name: str) -> list[Path]:
    """``csrc/<name>.cu`` and every ``csrc/`` header it includes with
    ``#include "..."``, directly or through another header."""
    out = [CSRC / f"{name}.cu"]
    for path in out:  # grows while it is walked
        for inc in _INCLUDE.findall(path.read_bytes()):
            header = CSRC / inc.decode()
            if header.exists() and header not in out:
                out.append(header)
    return out


def tag(name: str) -> str:
    """The hash that names the library: its sources and the nvcc flags."""
    h = hashlib.sha256()
    for path in sources(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes() + b"\0")
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build(name: str = "fdtd_chunk") -> tuple[Path, float, str]:
    """Compile ``csrc/<name>.cu`` unless a build of the same sources exists.

    Returns ``(library path, build seconds, compiler log)``; seconds and
    log are 0 and "" when an existing build was reused.
    """
    src = CSRC / f"{name}.cu"
    lib = BUILD_DIR / f"lib{name}_{tag(name)}.so"
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
    (BUILD_DIR / f"{lib.stem}.log").write_text(log)
    return lib, seconds, log


def load(name: str = "fdtd_chunk") -> ctypes.CDLL:
    """The loaded library, built first if needed (once per process)."""
    if name not in _LIBS:
        path, _, _ = build(name)
        _LIBS[name] = ctypes.CDLL(str(path))
    return _LIBS[name]
