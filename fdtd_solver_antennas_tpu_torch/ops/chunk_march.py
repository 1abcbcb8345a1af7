"""The marched form of K1 batched: its plan and its launch.

``fdtd_cuda.chunk_steps_batch`` steps one termination chunk of B design
variants of one grid in one cooperative launch, in one of three storage
forms (``fdtd_cuda.chunk_launch_plan``). Two are the persistent passes of
``csrc/yee_persist.cuh`` (``ops/persist.py``); this module carries the
third, ``"marched"``, ``chunk_march_kernel`` of
``csrc/fdtd_chunk_march.cu``: each block marches one variant's y–z tile
of an x segment with T = 3 time levels of a ring of planes in shared
memory, one barrier among a variant's blocks (a counter each) per round
of T steps, every plane's fields and coefficients copied in by cp.async a
plane ahead and staged once, and the probe gather in the kernel after
each interval. An interval is ⌊D/T⌋ rounds of T steps and one of D mod T;
D is the base's, never rounded.

- :func:`plan_layout`: the y–z core tile (picked by :func:`_pick` where
  not given), the cut (tiles, segments), threads and shared memory of a
  launch, on the host alone;
- :func:`plan`: the same on the card, its blocks from the occupancy query;
- :func:`chunk_steps`: the launch (``fdtd_cuda.chunk_steps_batch`` calls
  it where the plan says ``"marched"``). It reads each active variant's
  current E buffer and H set and leaves the result in the set its last
  round wrote, recorded in the variants' ``parity`` and ``hset``.

MUR and PEC only: under CPML the ψ slots and the staged coefficients do
not fit one block together, and the plan keeps the streamed form. A
failed plan, build or launch raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Tuple

import numpy as np
import torch

from . import fdtd_stream
from .fdtd_cuda import (YeeBatch, YeeOperands, _probe_args, _ProbeTable, _ptr,
                        device_guard, launch, one_set)

FORM = "marched"
T = 3  # steps of a round (the kernel's kT)
# The cells a block may hold (csrc/fdtd_chunk_march.cu::kP): a core and T
# cells a side in y and z fit this, one thread a cell (up to 96 registers
# a thread); the shared memory holds this many whatever the core, so that
# a field's components lie a constant apart.
LAYOUT_CELLS = 640
NCO = 9  # staged floats a cell and plane: ca, cb and the three stamps


def field_planes() -> int:
    """Planes of the E and H rings: the T + 2 the levels read, and the
    one in flight."""
    return T + 3


def coef_planes(mur: bool) -> int:
    """Planes of staged coefficients a block keeps: the T the levels
    read, the one in flight, and under MUR plane 0's (read by plane 1's
    step too)."""
    return T + 1 + int(bool(mur))


def region_cells(core) -> int:
    """Cells of a block: the core and T cells a side in y and z (the part
    outside the grid idles)."""
    return (core[0] + 2 * T) * (core[1] + 2 * T)


def smem_bytes(mur: bool) -> int:
    """Shared memory of a block (``csrc/fdtd_chunk_march.cu`` computes the
    same): per cell of :data:`LAYOUT_CELLS` the E and H rings of
    :func:`field_planes` planes, under MUR the old E of two planes and the
    upper x wall's two components, and the coefficient ring of
    :func:`coef_planes` planes of :data:`NCO` floats; then the x profiles
    (two floats a coefficient plane) and the round's T samples."""
    Tc = coef_planes(mur)
    floats = 6 * field_planes() + (8 if mur else 0) + Tc * NCO
    return 4 * (LAYOUT_CELLS * floats + 2 * Tc + T)


@dataclasses.dataclass(frozen=True)
class MarchPlan:
    """One marched launch: the fields of ``persist.Plan`` (``form``,
    ``cells_per_thread`` 0, ``blocks``, ``threads``, ``smem_bytes``) and
    the march's own: T, the y–z core, its origin and tiles, the x segments
    ``(length, origin, count)``, the items a variant (tiles × segments)
    and the blocks an SM the occupancy gives."""

    form: str
    cells_per_thread: int
    blocks: int
    threads: int
    smem_bytes: int
    T: int
    core: Tuple[int, int]
    origin: Tuple[int, int]
    tiles: Tuple[int, int]
    segments: Tuple[int, int, int]
    items_per_variant: int
    blocks_per_sm: int

    def rounds(self, D: int) -> int:
        """Rounds of one interval of D steps: ⌊D/T⌋ of T, one of D mod T."""
        return -(-int(D) // self.T)


def _layout(shape, grid_shape, mur, batch, core, resident):
    """The cut at ``core`` for ``resident`` blocks: ``(origin, tiles,
    segments, items a variant)``."""
    _, origin, tiles, segments = fdtd_stream._march_layout(
        shape, grid_shape, mur, None, resident, batch, core=core)
    return origin, tiles, segments, tiles[0] * tiles[1] * segments[2]


def threads(core) -> int:
    """Threads of a block: one a cell, in whole warps."""
    return -(-region_cells(core) // 32) * 32


def _cost(core, segments, items, resident) -> int:
    """The plan's measure of a round's time: the rounds of items a block
    runs, times the planes an item marches, times the block's warps."""
    warps = threads(core) // 32
    return -(-items // resident) * (segments[0] + 2 * T) * warps


def _pick(shape, grid_shape, mur, batch, resident):
    """The core of least :func:`_cost` among those whose sides split the
    grid's y and z evenly (⌈n / k⌉ cells, k pieces) and whose cells fit
    :data:`LAYOUT_CELLS`."""
    def sides(n):
        return sorted({-(-n // k) for k in range(1, n + 1)})

    best = None
    for cy in sides(int(shape[1])):
        for cz in sides(int(shape[2])):
            if region_cells((cy, cz)) > LAYOUT_CELLS:
                continue
            _, _, segs, per_v = _layout(shape, grid_shape, mur, batch,
                                        (cy, cz), resident)
            cost = _cost((cy, cz), segs, per_v * batch, resident)
            if best is None or cost < best[0]:
                best = (cost, (cy, cz))
    if best is None:
        raise ValueError(f"the marched form fits no core at {tuple(shape)}")
    return best[1]


def plan_layout(shape, grid_shape, mur: bool, batch: int,
                blocks_per_sm: int = 1, sms: int = fdtd_stream.SMS,
                core=None) -> MarchPlan:
    """The marched launch for ``batch`` variants of ``shape`` (``grid_shape``
    places the MUR walls) on ``sms`` SMs holding ``blocks_per_sm`` blocks
    each: the y–z core tile (None: :func:`_pick`'s), the y–z cut into
    cores with the march's shift off a lone wall plane, and the x segments
    whose items finish soonest over the resident blocks
    (``fdtd_stream.march_plan``'s rule with the batch's items). Blocks:
    the resident ones, at most the items. Raises ``ValueError`` where the
    core's cells outgrow :data:`LAYOUT_CELLS`."""
    if batch < 1:
        raise ValueError(f"batch={batch}: want at least one variant")
    resident = max(1, int(blocks_per_sm)) * int(sms)
    if core is None:
        core = _pick(shape, grid_shape, mur, batch, resident)
    core = tuple(int(v) for v in core)
    cells = region_cells(core)
    if cells > LAYOUT_CELLS:
        raise ValueError(
            f"the marched form takes no {core[0]}x{core[1]} core: {cells} "
            f"cells with T={T} a side (at most {LAYOUT_CELLS})")
    origin, tiles, segments, per_v = _layout(shape, grid_shape, mur, batch,
                                             core, resident)
    return MarchPlan(form=FORM, cells_per_thread=0,
                     blocks=min(resident, per_v * batch),
                     threads=threads(core), smem_bytes=smem_bytes(mur), T=T,
                     core=core, origin=tuple(origin), tiles=tuple(tiles),
                     segments=tuple(segments), items_per_variant=per_v,
                     blocks_per_sm=int(blocks_per_sm))


# ---------------------------------------------------------------------------
# CUDA launch
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int


class _MarchArgs(ctypes.Structure):
    """Field-for-field mirror of ``struct MarchArgs`` in
    csrc/fdtd_chunk_march.cu."""

    _fields_ = [
        ("f", _P * 12), ("ca", _P * 3), ("cb", _P * 3), ("src", _P * 3),
        ("inv_p", _P * 3), ("inv_d", _P * 3), ("probes", _ProbeTable),
        ("active", _P), ("bar", _P),
        ("n", _I * 3), ("q", _I * 3), ("has_mur", _I),
        ("dtmu", ctypes.c_float), ("mur_c", ctypes.c_float * 6),
        ("m_core", _I * 2), ("m_origin", _I * 2), ("m_tiles", _I * 2),
        ("m_seg", _I), ("m_seg_origin", _I), ("m_segs", _I),
        ("x_lo", _I), ("x_hi", _I), ("batch", _I),
        ("vstride", ctypes.c_longlong),
    ]


_lib = None
_PREFIX = "fdtd_chunk_march"


def _library():
    """Build (first use) and bind the kernel library."""
    global _lib
    if _lib is None:
        from . import _build

        lib = _build.load("fdtd_chunk_march")
        for name in ("args_size", "t", "cells"):
            fn = getattr(lib, f"{_PREFIX}_{name}")
            fn.argtypes, fn.restype = [], _I
        lib.fdtd_chunk_march_error_string.argtypes = [_I]
        lib.fdtd_chunk_march_error_string.restype = ctypes.c_char_p
        lib.fdtd_chunk_march_smem_bytes.argtypes = [_P]
        lib.fdtd_chunk_march_smem_bytes.restype = ctypes.c_longlong
        for name in ("threads", "blocks_per_sm"):
            fn = getattr(lib, f"{_PREFIX}_{name}")
            fn.argtypes, fn.restype = [_P], _I
        lib.fdtd_chunk_march.argtypes = [_P, _P, _I, _I, _I, _P, _I, _P]
        lib.fdtd_chunk_march.restype = _I
        if lib.fdtd_chunk_march_args_size() != ctypes.sizeof(_MarchArgs):
            raise RuntimeError(
                f"MarchArgs layout mismatch: C {lib.fdtd_chunk_march_args_size()} "
                f"bytes, ctypes {ctypes.sizeof(_MarchArgs)}")
        if (lib.fdtd_chunk_march_t(), lib.fdtd_chunk_march_cells()) != (
                T, LAYOUT_CELLS):
            raise RuntimeError("T or LAYOUT_CELLS differs between C and Python")
        _lib = lib
    return _lib


def _check(lib, code: int, what: str) -> None:
    if code != 0:
        msg = lib.fdtd_chunk_march_error_string(code).decode()
        raise RuntimeError(f"CUDA kernel {what} failed: {msg} ({code})")


def _pack(ops: YeeOperands, st: YeeBatch, p: int, q: int, mask, bar,
          plan: MarchPlan) -> _MarchArgs:
    """The launch arguments that step every active variant from E buffer
    ``p`` and H set ``q`` (set 0) with E buffer 1 − p and H set 1 − q as
    set 1, on the cut of ``plan``."""
    if ops.pml is not None:
        raise ValueError("the marched form takes MUR or PEC walls, not CPML")
    if ops.mur is not None and min(ops.grid_shape) < 3:
        raise ValueError(f"MUR needs >= 3 planes per axis, grid {ops.grid_shape}")
    if ops.mur_x_rows is not None or ops.mur_y_rows is not None:
        raise ValueError("the marched form takes a whole grid, not a slab")
    dev = ops.device
    shp = tuple(ops.shape)
    var = (st.batch, *shp)
    a = _MarchArgs()
    for s, (e, h) in enumerate(((st.e[p], st.h_set(q)[0]),
                                (st.e[1 - p], st.h_set(1 - q)[0]))):
        for m, t in enumerate((*e, *h)):
            a.f[6 * s + m] = _ptr(t, var, dev=dev)
    for m in range(3):
        a.ca[m] = _ptr(ops.ca[m], var, dev=dev)
        a.cb[m] = _ptr(ops.cb[m], var, dev=dev)
        a.src[m] = _ptr(ops.src[m], shp, dev=dev)
        a.inv_p[m] = _ptr(ops.inv_p[m], (shp[m],), dev=dev)
        a.inv_d[m] = _ptr(ops.inv_d[m], (shp[m],), dev=dev)
    a.probes = _probe_args(ops.probes, dev)
    a.active = _ptr(mask, (st.batch,), torch.int32, dev)
    a.bar = _ptr(bar, (st.batch,), torch.int32, dev)
    a.n[:] = shp
    a.q[:] = ops.grid_shape
    a.has_mur = int(ops.mur is not None)
    a.dtmu = ops.dtmu
    for b in range(3):
        for side in range(2):
            a.mur_c[2 * b + side] = ops.mur[b][side] if ops.mur else 0.0
    a.m_core[:] = plan.core
    a.m_origin[:] = plan.origin
    a.m_tiles[:] = plan.tiles
    a.m_seg, a.m_seg_origin, a.m_segs = plan.segments
    _, a.x_lo, a.x_hi = fdtd_stream.march_view(ops)
    a.batch = st.batch
    a.vstride = int(np.prod(shp))
    return a


# plans by (device, shape, grid shape, boundary, batch, core)
_PLANS: dict = {}


def plan(ops: YeeOperands, batch: int, core=None) -> MarchPlan:
    """:func:`plan_layout` on ``ops``' card: its SMs, and the blocks an SM
    holds by the occupancy query on the kernel's registers, threads and
    shared memory (one). Raises where the form does not take ``ops``
    (CPML) or no block fits."""
    if ops.pml is not None:
        raise ValueError("the marched form takes MUR or PEC walls, not CPML")
    mur = ops.mur is not None
    core = tuple(core) if core else None
    key = (str(ops.device), tuple(ops.shape), tuple(ops.grid_shape), mur,
           batch, core)
    if key in _PLANS:
        return _PLANS[key]
    lib = _library()
    with device_guard(ops.device):
        sms = torch.cuda.get_device_properties(ops.device).multi_processor_count
    layout = plan_layout(ops.shape, ops.grid_shape, mur, batch, 1, sms, core)
    a = _MarchArgs()
    a.n[:] = ops.shape
    a.has_mur = int(mur)
    a.m_core[:] = layout.core
    a.batch = batch
    a.vstride = int(np.prod(ops.shape))
    a.active = a.bar = 1  # checked for presence only
    smem = lib.fdtd_chunk_march_smem_bytes(ctypes.addressof(a))
    if smem != layout.smem_bytes:
        raise RuntimeError(f"marched shared memory: C {smem} B, "
                           f"plan_layout {layout.smem_bytes} B")
    with device_guard(ops.device):
        per_sm = lib.fdtd_chunk_march_blocks_per_sm(ctypes.addressof(a))
    if per_sm < 0:
        _check(lib, -per_sm, "chunk_steps_batch (marched) occupancy query")
    if per_sm < 1:
        raise RuntimeError(f"the marched form's block ({layout.threads} "
                           f"threads, {layout.smem_bytes} B) fits no SM")
    _PLANS[key] = plan_layout(ops.shape, ops.grid_shape, mur, batch, per_sm,
                              sms, layout.core)
    return _PLANS[key]


class _Buffers:
    """A batch's packed arguments, one struct per (E buffer, H set) the
    active variants start from, and the per-variant counters; kept on the
    batch (``YeeBatch._march``) while the operands, tensors, mask and plan
    are the ones it was packed with."""

    def __init__(self, ops, st, mask, plan):
        self.ops, self.mask, self.plan = ops, mask, plan
        self.key = self._key(st)
        self.bar = torch.zeros(st.batch, dtype=torch.int32, device=ops.device)
        self.args = {}

    @staticmethod
    def _key(st: YeeBatch):
        return (*st.e[0], *st.e[1], *st.h, *st.h1)

    def fits(self, ops, st, mask, plan) -> bool:
        key = self._key(st)
        return (ops is self.ops and mask is self.mask and plan == self.plan
                and len(key) == len(self.key)
                and all(x is y for x, y in zip(key, self.key)))

    def addr(self, st: YeeBatch, p: int, q: int) -> int:
        if (p, q) not in self.args:
            self.args[p, q] = _pack(self.ops, st, p, q, self.mask, self.bar,
                                    self.plan)
        return ctypes.addressof(self.args[p, q])


def chunk_steps(ops: YeeOperands, st: YeeBatch, wf: torch.Tensor, n0: int,
                n_sub: int, D: int, bufs: torch.Tensor, act, plan: MarchPlan,
                mask: torch.Tensor) -> None:
    """One chunk of every active variant (``act``, its device copy
    ``mask``) in one launch of the marched form on ``plan``: the caller
    (``fdtd_cuda.chunk_steps_batch``) has checked the window and the
    buffers. Every active variant starts from one E buffer and H set
    (``fdtd_cuda.one_set``); the second H set is made at the first launch.
    Afterwards each active variant's ``parity`` and ``hset`` name the set
    the last round wrote."""
    live = [b for b in range(st.batch) if act[b]]
    p, q = one_set(st, live, "chunk_steps_batch (marched)")
    if not st.h1:
        st.h1 = tuple(torch.zeros_like(t) for t in st.h)
    buf = st._march
    if buf is None or not buf.fits(ops, st, mask, plan):
        buf = st._march = _Buffers(ops, st, mask, plan)
    lib = _library()
    dev = ops.device
    code = launch(dev, lib.fdtd_chunk_march, buf.addr(st, p, q),
                  _ptr(wf, (len(wf),), dev=dev), n0, n_sub, D,
                  _ptr(bufs, (st.batch, n_sub, ops.probes.n_rows), dev=dev),
                  plan.blocks)
    _check(lib, code, "chunk_steps_batch (marched)")
    if n_sub * plan.rounds(D) % 2:
        for b in live:
            st.parity[b] ^= 1
            st.hset[b] ^= 1
