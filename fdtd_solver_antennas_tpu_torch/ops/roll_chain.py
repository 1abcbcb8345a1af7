"""The roll-calibration kernel: a chain of dependent circular row shifts.

Counterpart of the kernel body of ``examples/chunk_roofline.py::
calibrate_rolls`` (the TPU kernel K5), which times the TPU's lane-shift
unit. :func:`roll_chain` applies, ``iters`` times and starting from
``x = a``,

    x = roll(x, 1, 1) + a
    x = roll(x, 128, 1) * 0.9999f
    x = roll(x, C - 1, 1) + a
    x = roll(x, C - 128, 1) * 0.9999f

to a ``(R, C)`` float32 tensor, in one launch of ``csrc/roll_chain.cu``:
every shift a real move of every element through shared memory, with
128-bit accesses and ghost columns instead of a wrap test, one block a
row. The design takes C a multiple of 4 and raises on any other C. On a
CPU tensor it runs :func:`roll_chain_plain` (``torch.roll``), after the
same checks. A CUDA tensor always goes to the kernel; a failed build or
launch raises. ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import numpy as np
import torch

from .fdtd_cuda import _on_cuda, _ptr, launch

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

        _i = ctypes.c_int
        lib = _build.load("roll_chain")
        lib.roll_chain_max_cols.argtypes = []
        lib.roll_chain_max_cols.restype = _i
        lib.roll_chain_error_string.argtypes = [_i]
        lib.roll_chain_error_string.restype = ctypes.c_char_p
        lib.roll_chain_plan.argtypes = [_i, _i, ctypes.POINTER(_i)]
        lib.roll_chain_plan.restype = _i
        lib.roll_chain_launch.argtypes = [_P, _P, _i, _i, _i, _P]
        lib.roll_chain_launch.restype = _i
        _lib = lib
    return _lib


def _check(lib, code: int, what: str) -> None:
    if code != 0:
        msg = lib.roll_chain_error_string(code).decode()
        raise RuntimeError(f"CUDA kernel roll_chain {what} failed: {msg} ({code})")


def check_shape(shape) -> None:
    """Raise unless the kernel's design takes an (R, C) array: C a
    multiple of 4, at least 128."""
    if len(shape) != 2 or shape[0] < 1:
        raise ValueError(f"roll_chain takes (R, C), got {tuple(shape)}")
    C = shape[1]
    if C < MIN_COLS:
        raise ValueError(f"roll_chain takes (R, C >= {MIN_COLS}), "
                         f"got {tuple(shape)}")
    if C % 4:
        raise ValueError(f"roll_chain's float4 design takes C a multiple "
                         f"of 4, got C = {C}")


def plan(shape) -> dict:
    """The launch of an (R, C) array: blocks (one a row), threads a block,
    float4s a thread, dynamic shared bytes a block."""
    check_shape(shape)
    lib = _library()
    R, C = shape
    if C > lib.roll_chain_max_cols():
        raise ValueError(f"roll_chain takes C <= {lib.roll_chain_max_cols()}, "
                         f"got {C}")
    out = (ctypes.c_int * 4)()
    _check(lib, lib.roll_chain_plan(R, C, out), "plan")
    return dict(blocks=out[0], threads=out[1], per_thread=out[2],
                smem_bytes=out[3])


def roll_chain(a: torch.Tensor, iters: int) -> torch.Tensor:
    """The chain applied ``iters`` times to ``a`` (R, C), into a new
    tensor."""
    check_shape(tuple(a.shape))
    if iters < 0:
        raise ValueError(f"iters must be >= 0, got {iters}")
    if not _on_cuda(a):
        return roll_chain_plain(a, iters)
    lib = _library()
    R, C = a.shape
    plan(a.shape)  # raises on a C past the design's widest
    if a.data_ptr() % 16:
        a = a.clone()  # the kernel reads whole float4s
    out = torch.empty_like(a)
    code = launch(a.device, lib.roll_chain_launch,
                  _ptr(a, (R, C), dev=a.device),
                  _ptr(out, (R, C), dev=a.device), R, C, int(iters))
    _check(lib, code, "launch")
    launches["roll_chain"] += 1
    return out
