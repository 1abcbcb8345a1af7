"""The roll-calibration kernel: a chain of dependent circular row shifts.

Counterpart of the kernel body of ``examples/chunk_roofline.py::
calibrate_rolls`` (the TPU kernel K5), which times the TPU's lane-shift
unit. :func:`roll_chain` applies, ``iters`` times and starting from
``x = a``,

    x = roll(x, 1, 1) + a
    x = roll(x, 128, 1) * 0.9999f
    x = roll(x, C - 1, 1) + a
    x = roll(x, C - 128, 1) * 0.9999f

to a ``(R, C)`` float32 tensor, in one launch of ``csrc/roll_chain.cu``
(one block per row, the row in shared memory); on a CPU tensor it runs
:func:`roll_chain_plain` (``torch.roll``). A CUDA tensor always goes to the
kernel; a failed build or launch raises. ``launches`` counts kernel
launches.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import numpy as np
import torch

from .fdtd_cuda import _on_cuda, _ptr, _stream

KERNELS = ("roll_chain",)

# kernel launches per wrapper; only the wrapper's CUDA branch adds to it
launches: Dict[str, int] = dict.fromkeys(KERNELS, 0)

DECAY = float(np.float32(0.9999))  # the chain's float32 multiplier
SHIFTS_PER_ITER = 4
MIN_COLS = 128  # the chain shifts by 128 and C - 128


def reset_launch_counts() -> None:
    for k in KERNELS:
        launches[k] = 0


def roll_chain_plain(a: torch.Tensor, iters: int) -> torch.Tensor:
    """The chain with ``torch.roll``: the reference and the CPU path."""
    C = a.shape[1]
    x = a.clone()
    for _ in range(iters):
        x = torch.roll(x, 1, 1) + a
        x = torch.roll(x, 128, 1) * DECAY
        x = torch.roll(x, C - 1, 1) + a
        x = torch.roll(x, C - 128, 1) * DECAY
    return x


_P = ctypes.c_void_p
_lib = None


def _library():
    """Build (first use) and bind the kernel library."""
    global _lib
    if _lib is None:
        from . import _build

        lib = _build.load("roll_chain")
        lib.roll_chain_max_cols.argtypes = []
        lib.roll_chain_max_cols.restype = ctypes.c_int
        lib.roll_chain_error_string.argtypes = [ctypes.c_int]
        lib.roll_chain_error_string.restype = ctypes.c_char_p
        lib.roll_chain_launch.argtypes = [_P, _P, ctypes.c_int, ctypes.c_int,
                                          ctypes.c_int, _P]
        lib.roll_chain_launch.restype = ctypes.c_int
        _lib = lib
    return _lib


def roll_chain(a: torch.Tensor, iters: int) -> torch.Tensor:
    """The chain applied ``iters`` times to ``a`` (R, C), into a new
    tensor."""
    if a.dim() != 2 or a.shape[1] < MIN_COLS:
        raise ValueError(f"roll_chain takes (R, C >= {MIN_COLS}), got "
                         f"{tuple(a.shape)}")
    if iters < 0:
        raise ValueError(f"iters must be >= 0, got {iters}")
    if not _on_cuda(a):
        return roll_chain_plain(a, iters)
    lib = _library()
    R, C = a.shape
    if C > lib.roll_chain_max_cols():
        raise ValueError(f"roll_chain takes C <= {lib.roll_chain_max_cols()}, "
                         f"got {C}")
    out = torch.empty_like(a)
    code = lib.roll_chain_launch(_ptr(a, (R, C), dev=a.device),
                                 _ptr(out, (R, C), dev=a.device), R, C,
                                 int(iters), _stream(a.device))
    if code != 0:
        msg = lib.roll_chain_error_string(code).decode()
        raise RuntimeError(f"CUDA kernel roll_chain failed: {msg} ({code})")
    launches["roll_chain"] += 1
    return out
