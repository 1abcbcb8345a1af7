"""Build the native voxelizer core (``native/voxelize.cpp``) with ``g++``
and load it with ``ctypes``.

Counterpart of ``fdtd_solver_antennas_tpu/native/build.py`` for the host
compiler, beside ``ops/_build.py``, which builds the CUDA sources with
``nvcc``. The library is built at first use into ``_build/`` beside the
package (listed in ``.gitignore``) and named by a hash of its source and
flags, so an edited source never loads a stale build. A failed build or
load raises with the compiler's output; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

from ..ops._build import BUILD_DIR

SRC = Path(__file__).resolve().parent / "voxelize.cpp"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
BOX_DOUBLES = 22  # one box record (see voxelize.cpp)

_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None


def tag() -> str:
    """The hash that names the library: its source and the g++ flags."""
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile ``voxelize.cpp`` unless a build of the same source exists;
    the library's path. Compiles to a process-unique name and moves it
    into place, so a concurrent process never loads a half-written file."""
    lib = BUILD_DIR / f"libvoxelize_{tag()}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(["g++", *GXX_FLAGS, str(SRC), "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"g++ failed ({proc.returncode}) building {SRC.name}:\n"
            f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def get_voxelize_lib() -> ctypes.CDLL:
    """The loaded library, built first if needed (once per process)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            dp = ctypes.POINTER(ctypes.c_double)
            fp = ctypes.POINTER(ctypes.c_float)
            u8p = ctypes.POINTER(ctypes.c_uint8)
            i64 = ctypes.c_int64
            lib.box_contains_or.argtypes = [dp, i64, dp, u8p]
            lib.box_contains_or.restype = None
            lib.paint_materials.argtypes = [dp, i64, dp, dp, i64, dp, dp]
            lib.paint_materials.restype = None
            lib.cell_edge_avg_f32.argtypes = [fp, i64, i64, i64, ctypes.c_int, fp]
            lib.cell_edge_avg_f32.restype = None
            lib.cell_edge_avg_f64.argtypes = [dp, i64, i64, i64, ctypes.c_int, dp]
            lib.cell_edge_avg_f64.restype = None
            _LIB = lib
        return _LIB
