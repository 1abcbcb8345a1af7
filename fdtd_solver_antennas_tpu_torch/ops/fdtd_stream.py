"""The stream stepper: T leapfrog steps per CUDA launch, and its plain twin.

Counterpart of ``build_pallas_stream_stepper`` in
``fdtd_solver_antennas_tpu/ops/fdtd_pallas.py`` (the TPU kernel K2), which
carries the grids whose working set does not fit the chunk kernel. The
port computes the same T steps with a march of ``csrc/fdtd_stream.cu``: a
y–z tile that marches along x over a segment of planes and keeps T + 1
time levels of a few planes in shared memory (2.5-D temporal blocking).
``march_kernel`` takes MUR and PEC walls; ``cpml_march_kernel`` takes
CPML, whose ψ move through the levels in each thread's own slots and
whose ca, cb, x spacings and x profiles it stages in shared memory a
plane ahead (:func:`march_plan` cuts the grid into tiles and segments;
:func:`flat_runs` gives the profile runs where a ψ stays 0 and the kernel
skips it; :func:`stamp_planes` the planes whose source stamp it reads).
The operands choose: ``ops.pml`` set takes the CPML kernel.

- :func:`stream_steps`: T = ``len(wf_t)`` leapfrog steps (H, E with source
  sample ``wf_t[k]`` at inner step k, MUR walls x → y → z), with ψ under
  CPML. On a CUDA tensor it launches the march, or raises; it never falls
  back to the twin. On a CPU tensor it runs :func:`stream_steps_plain`,
  which is T calls of ``fdtd_cuda.leapfrog_step`` with the plain twins.
- :func:`build_stream_shard_stepper` and :func:`stream_shard_steps`: the
  march on one rank's halo-extended x-slab, the counterpart of K2's
  ``shard=`` form, which the explicit run (``parallel/explicit.py``)
  takes where Pz > ``fdtd_shard.MAX_PZ``. A launch advances T steps;
  halos are W = T + 1 rows, restocked once per launch. The march takes
  the slab's own x walls (:func:`march_view`; CPML has none).
- :func:`stream_steps_batch`: the march for B design variants of one grid
  in one launch, the counterpart of K2's ``coef_ops_from`` form (ca/cb as
  operands) under ``jax.vmap``, which a geometry sweep on a union grid
  that spills the L2 runs (``ops/fdtd.py::run_batched`` in stream mode).
  A ``fdtd_cuda.YeeBatch`` carries a second set of H and ψ and a set
  index per variant, so a frozen variant's fields stay where they are
  while the others move on; its plain twin is
  :func:`stream_steps_batch_plain`.

The engine samples probes between launches with K1's ``probe_gather``
(``probe_gather_batch`` for a batch). ``launches`` counts
``stream_steps``, ``stream_shard_steps`` and ``stream_steps_batch``
launches, as ``fdtd_cuda.launches`` does for K1, and
``launches_by_kernel`` counts them per route (``stream_march``,
``shard_march``, ``stream_march_batch``); ``cpml_staged_launches`` counts
those of them that ran ``cpml_march_kernel``. :data:`kernels` and
:data:`plain` are the engine's full sets of entry points (K1's
``chunk_steps``, ``chunk_steps_batch`` and per-step kernels, and
``stream_steps`` and ``stream_steps_batch``) that
``ops/fdtd.py::run_simulation`` and ``run_batched`` step with.
"""

from __future__ import annotations

import ctypes
from types import SimpleNamespace
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from . import fdtd_cuda, fdtd_shard
from .fdtd_cuda import (YeeBatch, YeeOperands, YeeState, _on_cuda, _ptr,
                        device_guard, launch)

KERNELS = ("stream_steps", "stream_shard_steps", "stream_steps_batch")

# kernel launches per wrapper; only the wrapper's CUDA branch adds to it
launches: Dict[str, int] = dict.fromkeys(KERNELS, 0)
# the same launches by the route that ran
ROUTES = ("stream_march", "shard_march", "stream_march_batch")
launches_by_kernel: Dict[str, int] = dict.fromkeys(ROUTES, 0)
# the launches of any route that ran cpml_march_kernel (ops.pml set)
cpml_staged_launches = 0

# Shared memory one block may use on Hopper (H100/H200), bytes.
SMEM_LIMIT = 232_448
# Steps per launch the kernel accepts (the source samples ride in its
# parameters).
MAX_T = 8
# The march: y-z core tile per boundary kind, one thread per region cell
# (core + 2T per axis, at most MARCH_THREADS: a 24x24 region at T = 4
# under MUR, T = 5 under PEC; 22x22 at T = 4 under CPML, whose staged
# rings fill the shared memory), and the H100's SMs, over which its x cut
# spreads the blocks (march_blocks).
_MARCH_CORE = {"mur": (16, 16), "pec": (14, 14), "pml": (14, 14)}
MARCH_THREADS = 576
SMS = 132
# floats of one plane's x scalars in cpml_march_kernel's scalar ring
_CPML_XS = 8


def _cpml_floats(T: int) -> int:
    """Floats a cell holds in ``cpml_march_kernel``'s rings at T: E and H
    of T + 2 planes, ca and cb of T + 1, the twelve ψ of T."""
    return 6 * (T + 2) + 6 * (T + 1) + 12 * T


def cpml_stride(T: int) -> int:
    """Cells a component and plane take in ``cpml_march_kernel``'s rings at
    T, whatever a block's region (at most this many cells): the most that
    fit the shared memory beside the x scalars, at most MARCH_THREADS, a
    multiple of 4 (``csrc/fdtd_stream.cu::cpml_stride``): 508 at T = 4."""
    fit = (SMEM_LIMIT // 4 - _CPML_XS * (T + 1)) // _cpml_floats(T) // 4 * 4
    return min(MARCH_THREADS, fit)


def reset_launch_counts() -> None:
    global cpml_staged_launches
    cpml_staged_launches = 0
    for k in KERNELS:
        launches[k] = 0
    for k in ROUTES:
        launches_by_kernel[k] = 0


def _kind(mur: bool, pml: bool) -> str:
    if mur and pml:
        raise ValueError("CPML takes no MUR walls")
    return "pml" if pml else "mur" if mur else "pec"


def march_core(mur: bool, pml: bool = False) -> Tuple[int, int]:
    """The march's y-z core tile for MUR, PEC or CPML."""
    return _MARCH_CORE[_kind(mur, pml)]


def march_blocks(pml: bool) -> int:
    """The resident blocks the march's x cut aims for: two an SM, one
    under CPML, whose ψ slots and staged rings fill an SM."""
    return SMS if pml else 2 * SMS


def max_T(shape, mur: bool, pml: bool) -> int:
    """The deepest T in 1..MAX_T whose march region fits its threads and
    shared memory (:func:`march_plan`): at the large grids 4 under MUR and
    CPML, 5 under PEC."""
    fits = [t for t in range(1, MAX_T + 1)
            if _march_cells_smem(shape, t, mur, pml)[1] is not None]
    if not fits:
        raise ValueError(f"no march region fits {MARCH_THREADS} threads and "
                         f"{SMEM_LIMIT} bytes for {tuple(shape)}")
    return max(fits)


def _cut(n: int, wall: int, core: int, mur: bool) -> Tuple[int, int]:
    """``(origin, pieces)`` of one axis cut into cores of ``core`` cells:
    piece b covers [b·core − origin, (b+1)·core − origin) ∩ [0, n). Under
    MUR no piece may start on the upper wall plane ``wall`` (−1: none),
    whose fix needs the plane below's new E: the cut shifts down by one
    cell where one would start there."""
    origin = int(bool(mur) and wall > 0 and wall % core == 0)
    return origin, -(-(n + origin) // core)


def _march_layout(shape, grid_shape, mur: bool, x_wall=None,
                  blocks=None, batch: int = 1, pml: bool = False, core=None):
    """The T-independent part of :func:`march_plan`. The x segments: the
    length (at least 3 planes) whose blocks finish soonest, counting
    rounds of ``blocks`` resident blocks (default :func:`march_blocks`)
    over the ``batch`` variants of a launch times the planes a block
    marches (its segment and the trapezoid's 2T more, taken at T = 4).
    ``core``: the y-z core (default :func:`march_core`)."""
    n0, n1, n2 = (int(v) for v in shape)
    q0, q1, q2 = (int(v) for v in grid_shape)
    x_wall = q0 - 1 if x_wall is None else int(x_wall)
    blocks = march_blocks(pml) if blocks is None else blocks
    core = tuple(core) if core is not None else march_core(mur, pml)
    oy, ty = _cut(n1, q1 - 1, core[0], mur)
    oz, tz = _cut(n2, q2 - 1, core[1], mur)

    def finish(seg):
        rounds = -(-ty * tz * -(-n0 // seg) * batch // blocks)
        return rounds * (seg + 8), -seg

    seg = min({max(3, -(-n0 // k)) for k in range(1, n0 + 1)}, key=finish)
    ox, segs = _cut(n0, x_wall, seg, mur)
    return core, (oy, oz), (ty, tz), (seg, ox, segs)


def _march_cells_smem(shape, T: int, mur: bool, pml: bool = False):
    """Region cells of the march's largest block and its shared memory
    (None where either is past the limit)."""
    core = march_core(mur, pml)
    cells = (min(int(shape[1]), core[0] + 2 * T)
             * min(int(shape[2]), core[1] + 2 * T))
    if pml:  # rings of fields, ca/cb and T ψ slots at a fixed stride
        smem = 4 * (cpml_stride(T) * _cpml_floats(T) + _CPML_XS * (T + 1))
        fits = cells <= cpml_stride(T) and smem <= SMEM_LIMIT
    else:
        smem = 4 * cells * (6 * (T + 2) + (8 if mur else 0))
        fits = cells <= MARCH_THREADS and smem <= SMEM_LIMIT
    return cells, smem if fits else None


def march_plan(shape, grid_shape, T: int, mur: bool, x_wall=None,
               blocks=None, batch: int = 1, pml: bool = False):
    """How the march cuts a grid for a T-step launch under MUR or PEC
    walls or (``pml``) CPML. ``grid_shape`` places the y and z walls;
    ``x_wall`` is the plane of the upper x wall (default ``grid_shape[0]
    − 1``, −1 for none): a slab's, from :func:`march_view`; ``blocks``
    the resident blocks the x cut aims for (default
    :func:`march_blocks`; another count moves the segment ends) over the
    ``batch`` variants a launch steps.

    Returns ``(core_yz, origin_yz, tiles_yz, x_segments, smem_bytes)``.
    Tile (by, bz) covers y in [by·core_y − origin_y, (by+1)·core_y −
    origin_y) and likewise z, clipped to the array; ``x_segments`` is
    ``(length, origin, count)``, segment s covering [s·length − origin,
    (s+1)·length − origin). There are ``tiles_y·tiles_z·count`` blocks
    per variant.
    A block
    holds the region core + T cells per side in y and z, one thread per
    region cell; ``smem_bytes`` is the largest block's shared memory: the
    E and H rings of T + 2 planes, under MUR the old E of two planes and
    the upper x wall's two fixed components; under CPML at the fixed
    stride of :func:`cpml_stride` cells, whatever the region, the rings,
    T slots of the twelve ψ, the ca/cb ring of T + 1 planes, and T + 1
    planes' x scalars.
    ``csrc/fdtd_stream.cu`` computes the same from the packed
    arguments. Raises ``ValueError`` where a region outgrows the threads
    or the shared memory."""
    core, origin, tiles, segments = _march_layout(shape, grid_shape, mur,
                                                  x_wall, blocks, batch, pml)
    cells, smem = _march_cells_smem(shape, T, mur, pml)
    if smem is None:
        raise ValueError(
            f"the march takes no T={T} at {tuple(shape)}: {cells} region "
            f"cells (at most {MARCH_THREADS}) or their shared memory past "
            f"{SMEM_LIMIT} B")
    return core, origin, tiles, segments, smem


def flat_runs(pml) -> Tuple[Tuple[Tuple[int, int], ...], ...]:
    """Per side (H: ``bh``/``ch``; E: ``be``/``ce``) and axis, the longest
    run ``(lo, hi)`` of indices where the CPML profile is flat, b = 1 and
    c = 0 exactly: a ψ whose derivative runs along that axis keeps its 0
    there (``ops/fdtd.py::_cpml_profiles`` gives σ = α = 0 between the
    slabs), so the march skips it (``csrc/fdtd_stream.cu``'s header).
    ``(0, 0)`` where no index is flat. The profiles may be device tensors
    or host arrays."""
    out = []
    for b_key, c_key in (("bh", "ch"), ("be", "ce")):
        side = []
        for b, c in zip(pml[b_key], pml[c_key]):
            flat = (b == 1) & (c == 0)
            if torch.is_tensor(flat):
                flat = flat.cpu().numpy()
            best, lo = (0, 0), None
            for i, f in enumerate([*flat, False]):
                if f and lo is None:
                    lo = i
                elif not f and lo is not None:
                    best = max(best, (lo, i), key=lambda r: r[1] - r[0])
                    lo = None
            side.append(best)
        out.append(tuple(side))
    return tuple(out)


# the derivative axis of each ψ (order xy xz yz yx zx zy): its profile's
PSI_AXIS = (1, 2, 2, 0, 0, 1)


def stamp_planes(ops: YeeOperands, rows: int, device=None) -> torch.Tensor:
    """Per x plane of ``ops``' three source stamps (each (rows, Py, Pz) or
    None), an int32 whose bit m is set where stamp m holds a nonzero value
    on that plane or may hold one under another drive (``ops.src_planes``):
    the planes whose stamps ``cpml_march_kernel`` reads and adds
    (everywhere else the stamp is 0 and the twin adds 0)."""
    flags = torch.zeros(rows, dtype=torch.int32, device=device)
    for m, t in enumerate(ops.src):
        if t is not None:
            flags |= t.reshape(rows, -1).ne(0).any(1).to(torch.int32) << m
    for m, planes in enumerate(ops.src_planes or ()):
        flags[list(planes)] |= 1 << m
    return flags


def psi_slabs(ops: YeeOperands) -> Tuple[torch.Tensor, ...]:
    """Where each ψ may be non-zero: twelve boolean masks (ψ_e in
    ``fdtd_cuda.PSI_KEYS`` order, then ψ_h) along the ψ's derivative axis,
    shaped to broadcast over a (X, Y, Z) field, False in that axis's
    :func:`flat_runs` run. The march skips a ψ there, which equals the
    twin while the ψ is 0 there, as it is from ``fdtd_cuda.new_state`` and
    after any run."""
    runs = flat_runs(ops.pml)
    out = []
    for side in (1, 0):  # E, then H
        for ax in PSI_AXIS:
            lo, hi = runs[side][ax]
            n = ops.shape[ax]
            idx = torch.arange(n, device=ops.device)
            shape = [1, 1, 1]
            shape[ax] = n
            out.append(((idx < lo) | (idx >= hi)).view(shape))
    return tuple(out)


def check_psi_flat(ops: YeeOperands, psi) -> None:
    """Raise unless each of the twelve ψ in ``psi`` (ψ_e, then ψ_h; a
    state's or a batch's) is 0 in its axis's :func:`flat_runs` run, where
    the march skips it: the kernel's result equals the twin's only then.
    States from ``fdtd_cuda.new_state`` and from any run are; a caller's
    may not be. One host sync."""
    bad = torch.stack([t.masked_fill(keep, 0.0).ne(0).any()
                       for t, keep in zip(psi, psi_slabs(ops))])
    if bool(bad.any()):
        names = [f"psi_{side}[{k}]" for side in "eh" for k in range(6)]
        raise ValueError(
            "the CPML march needs each psi at 0 outside its slab (where its "
            "axis's profile has b = 1, c = 0); non-zero there: "
            + ", ".join(n for n, b in zip(names, bad.tolist()) if b))


def march_view(ops: YeeOperands) -> Tuple[int, int, int]:
    """``(v0, x_lo, x_hi)``: the march runs on rows ``[v0, m)`` of the
    operands' ``m`` rows; ``x_lo`` is 1 where the view's plane 0 is the
    lower MUR x wall, ``x_hi`` the view plane of the upper one (−1:
    none). A whole grid gives ``(0, 1, q0 − 1)``. A slab (``mur_x_rows``)
    whose lower wall lies in it starts the view at that wall: the rows
    below it are out of the domain, their coefficients zero, and no
    owned row reads them. An upper wall on the view's plane 0 fixes
    nothing an owned row reads (every row above it is out of the domain)
    and is left out. PEC and CPML have no walls: ``(0, 0, −1)``."""
    if ops.mur is None:
        return 0, 0, -1
    m = ops.shape[0]
    lo, hi = ops.mur_x_rows or (0, ops.grid_shape[0] - 1)
    x_lo = int(0 <= lo < m)
    v0 = lo if x_lo else 0
    x_hi = hi - v0
    return v0, x_lo, x_hi if 0 < x_hi < m - v0 else -1


# ---------------------------------------------------------------------------
# plain PyTorch twin (the CPU path, and the reference on the card)
# ---------------------------------------------------------------------------

def stream_steps_plain(ops: YeeOperands, st: YeeState,
                       wf_t: Sequence[float]) -> None:
    for s in wf_t:
        fdtd_cuda.leapfrog_step(fdtd_cuda.plain, ops, st, s)


# ---------------------------------------------------------------------------
# CUDA launch
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I3 = ctypes.c_int * 3


class _StreamArgs(ctypes.Structure):
    """Field-for-field mirror of ``struct StreamArgs`` in csrc/fdtd_stream.cu."""

    _fields_ = [
        ("e_in", _P * 3), ("h_in", _P * 3), ("pe_in", _P * 6), ("ph_in", _P * 6),
        ("e_out", _P * 3), ("h_out", _P * 3), ("pe_out", _P * 6),
        ("ph_out", _P * 6),
        ("ca", _P * 3), ("cb", _P * 3), ("src", _P * 3),
        ("inv_p", _P * 3), ("inv_d", _P * 3),
        ("bh", _P * 3), ("ch", _P * 3), ("be", _P * 3), ("ce", _P * 3),
        ("n", _I3), ("q", _I3),
        ("has_pml", ctypes.c_int), ("has_mur", ctypes.c_int),
        ("dtmu", ctypes.c_float), ("mur_c", ctypes.c_float * 6),
        ("flat", ctypes.c_int * 12),
        ("m_core", ctypes.c_int * 2), ("m_origin", ctypes.c_int * 2),
        ("m_tiles", ctypes.c_int * 2), ("m_seg", ctypes.c_int),
        ("m_seg_origin", ctypes.c_int), ("m_segs", ctypes.c_int),
        ("x_lo", ctypes.c_int), ("x_hi", ctypes.c_int),
        ("active", _P), ("vstride", ctypes.c_longlong),
        ("src_planes", _P),
    ]


_lib = None


def _library():
    """Build (first use) and bind the kernel library."""
    global _lib
    if _lib is None:
        from . import _build

        lib = _build.load("fdtd_stream")
        for name in ("fdtd_stream_args_size", "fdtd_stream_max_t"):
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = ctypes.c_int
        lib.fdtd_march_smem_bytes.argtypes = [_P, ctypes.c_int]
        lib.fdtd_march_smem_bytes.restype = ctypes.c_longlong
        lib.fdtd_march_blocks_per_sm.argtypes = [_P, ctypes.c_int]
        lib.fdtd_march_blocks_per_sm.restype = ctypes.c_int
        lib.fdtd_stream_error_string.argtypes = [ctypes.c_int]
        lib.fdtd_stream_error_string.restype = ctypes.c_char_p
        lib.fdtd_stream_march.argtypes = [_P, _P, ctypes.c_int, _P]
        lib.fdtd_stream_march.restype = ctypes.c_int
        lib.fdtd_stream_march_batch.argtypes = [_P, _P, ctypes.c_int,
                                                ctypes.c_int, _P]
        lib.fdtd_stream_march_batch.restype = ctypes.c_int
        if lib.fdtd_stream_args_size() != ctypes.sizeof(_StreamArgs):
            raise RuntimeError(
                f"StreamArgs layout mismatch: C {lib.fdtd_stream_args_size()} "
                f"bytes, ctypes {ctypes.sizeof(_StreamArgs)}")
        if lib.fdtd_stream_max_t() != MAX_T:
            raise RuntimeError("MAX_T differs between C and Python")
        _lib = lib
    return _lib


def _field_set(st: YeeState):
    """The state's current fields as one tuple: E3, H3, ψ_e6, ψ_h6."""
    return (*st.e[st.parity], *st.h, *st.psi_e, *st.psi_h)


def _pack(ops: YeeOperands, src, dst, view, blocks, batch: int = 0,
          active=None) -> _StreamArgs:
    """The launch arguments that step the fields ``src`` (E3, H3, ψ_e6,
    ψ_h6) into ``dst``, on the march's view ``(v0, x_lo, x_hi)``
    (:func:`march_view`; its arrays start at row v0). ``batch`` B > 0:
    the fields and ``ops``' ca/cb are (B, X, Y, Z), the view is a whole
    grid's and ``active`` the device mask of the variants that step."""
    if ops.mur is not None and min(ops.grid_shape) < 3:
        raise ValueError(f"MUR needs >= 3 planes per axis, grid {ops.grid_shape}")
    if ops.mur_y_rows is not None:
        raise ValueError("an x-y block (mur_y_rows) is the per-step walk's; "
                         "the march takes a whole y extent")
    dev = ops.device
    pml = ops.pml is not None
    v0, x_lo, x_hi = view
    shp = (ops.shape[0] - v0, *ops.shape[1:])
    own = (batch, *shp) if batch else shp  # a variant's arrays, batched

    def rows(t):  # the view [v0, m) of a (m, Py, Pz) tensor
        return None if t is None else t[v0:]

    inv_p = (ops.inv_p[0][v0:], *ops.inv_p[1:])
    inv_d = (ops.inv_d[0][v0:], *ops.inv_d[1:])
    a = _StreamArgs()
    for m in range(3):
        a.e_in[m] = _ptr(rows(src[m]), own, dev=dev)
        a.h_in[m] = _ptr(rows(src[3 + m]), own, dev=dev)
        a.e_out[m] = _ptr(rows(dst[m]), own, dev=dev)
        a.h_out[m] = _ptr(rows(dst[3 + m]), own, dev=dev)
        a.ca[m] = _ptr(rows(ops.ca[m]), own, dev=dev)
        a.cb[m] = _ptr(rows(ops.cb[m]), own, dev=dev)
        a.src[m] = _ptr(rows(ops.src[m]), shp, dev=dev)
        a.inv_p[m] = _ptr(inv_p[m], (shp[m],), dev=dev)
        a.inv_d[m] = _ptr(inv_d[m], (shp[m],), dev=dev)
    if pml:  # no walls, so v0 is 0
        for m in range(3):
            for key in ("bh", "ch", "be", "ce"):
                getattr(a, key)[m] = _ptr(ops.pml[key][m], (shp[m],), dev=dev)
        for m in range(6):
            a.pe_in[m] = _ptr(src[6 + m], own, dev=dev)
            a.ph_in[m] = _ptr(src[12 + m], own, dev=dev)
            a.pe_out[m] = _ptr(dst[6 + m], own, dev=dev)
            a.ph_out[m] = _ptr(dst[12 + m], own, dev=dev)
        a.flat[:] = [i for side in flat_runs(ops.pml) for run in side
                     for i in run]
        a._src_planes = stamp_planes(ops, shp[0], dev)  # kept alive here
        a.src_planes = _ptr(a._src_planes, (shp[0],), torch.int32, dev)
    a.n[:] = shp
    a.q[:] = ops.grid_shape
    a.has_pml = int(pml)
    a.has_mur = int(ops.mur is not None)
    a.dtmu = ops.dtmu
    for b in range(3):
        for side in range(2):
            a.mur_c[2 * b + side] = ops.mur[b][side] if ops.mur else 0.0
    core, origin, tiles, (seg, seg_origin, segs) = _march_layout(
        shp, ops.grid_shape, ops.mur is not None, x_hi, blocks,
        max(batch, 1), pml)
    a.m_core[:] = core
    a.m_origin[:] = origin
    a.m_tiles[:] = tiles
    a.m_seg, a.m_seg_origin, a.m_segs = seg, seg_origin, segs
    a.x_lo, a.x_hi = x_lo, x_hi
    if batch:
        a.active = _ptr(active, (batch,), torch.int32, dev)
        a.vstride = int(np.prod(shp))
    return a


class _StreamBuffers:
    """The state's second set of fields and the packed arguments of both
    launch directions (set 0 → set 1, set 1 → set 0). A launch reads one
    set and writes the other; the wrapper then points the state at the
    set it wrote. Kept on the state (``YeeState._stream``). The march's
    arrays start at row ``v0`` (:func:`march_view`); rows below it are
    never written and stay as the second set starts them, zero.
    ``blocks``: the march's x cut (:func:`march_plan`)."""

    def __init__(self, ops: YeeOperands, st: YeeState, blocks):
        first = _field_set(st)
        self.ops, self.blocks = ops, blocks
        self.view = march_view(ops)
        self.shape = (ops.shape[0] - self.view[0], *ops.shape[1:])
        if ops.pml is not None:
            check_psi_flat(ops, first[6:])
        self.sets = (first, tuple(torch.zeros_like(t) for t in first))
        self.args = tuple(_pack(ops, self.sets[i], self.sets[1 - i], self.view,
                                blocks) for i in range(2))
        self.addr = tuple(ctypes.addressof(a) for a in self.args)
        self.march_T = set()  # the T whose shared memory C and Python agree on

    def current(self, ops: YeeOperands, st: YeeState, blocks):
        """Index of the set the state points at, or None if neither."""
        if ops is not self.ops or blocks != self.blocks:
            return None
        now = _field_set(st)
        for i, s in enumerate(self.sets):
            if len(s) == len(now) and all(x is y for x, y in zip(s, now)):
                return i
        return None


class _BatchBuffers:
    """The packed arguments of a :class:`YeeBatch`'s launches, one struct
    per (E buffer, H set) the active variants start from, made at first
    use: a launch reads E from ``e[p]``, H and ψ from set q, and writes
    ``e[1 − p]`` and set 1 − q. Kept on the batch (``YeeBatch._stream``)
    while the operands, the batch's tensors and the device mask are the
    ones it was packed with."""

    def __init__(self, ops: YeeOperands, st: YeeBatch, mask: torch.Tensor):
        self.ops, self.mask, self.key = ops, mask, self._key(st)
        self.shape = tuple(ops.shape)
        self.view = march_view(ops)
        self.args = {}
        self.march_T = set()

    @staticmethod
    def _key(st: YeeBatch):
        return (*st.e[0], *st.e[1], *st.h, *st.h1, *st.psi_e, *st.psi_e1,
                *st.psi_h, *st.psi_h1)

    def fits(self, ops: YeeOperands, st: YeeBatch, mask) -> bool:
        key = self._key(st)
        return (ops is self.ops and mask is self.mask and len(key) == len(self.key)
                and all(x is y for x, y in zip(key, self.key)))

    def addr(self, st: YeeBatch, p: int, q: int) -> int:
        if (p, q) not in self.args:
            def fields(p, q):
                h, pe, ph = st.h_set(q)
                return (*st.e[p], *h, *pe, *ph)

            src, dst = fields(p, q), fields(1 - p, 1 - q)
            if self.ops.pml is not None:  # the march skips both sets' there
                check_psi_flat(self.ops, src[6:])
                check_psi_flat(self.ops, dst[6:])
            self.args[p, q] = _pack(self.ops, src, dst, self.view, None,
                                    st.batch, self.mask)
        return ctypes.addressof(self.args[p, q])


def stream_steps(ops: YeeOperands, st: YeeState, wf_t: Sequence[float]) -> None:
    """Advance ``st`` by T = ``len(wf_t)`` leapfrog steps; ``wf_t[k]`` is the
    source sample of inner step k. On CUDA it launches the march (MUR, PEC
    or CPML); the state afterwards points at the other of its two field
    sets (its earlier tensors hold the fields from before the launch)."""
    _check_T(wf_t)
    if not _on_cuda(st.h[0]):
        return stream_steps_plain(ops, st, wf_t)
    _stream_launch(ops, st, wf_t, "stream_steps", "stream_march")


def stream_shard_steps(ops: YeeOperands, st: YeeState,
                       wf_t: Sequence[float], blocks=None) -> None:
    """T = ``len(wf_t)`` steps of a rank's slab (``ops`` from
    :func:`build_stream_shard_stepper`): on CUDA one launch of the march
    on the slab's view (:func:`march_view`; its x cut aims at ``blocks``
    resident blocks, default :func:`march_blocks`, :func:`march_plan`);
    on the CPU ``fdtd_shard.shard_steps_plain``, the walls at
    ``ops.mur_x_rows``. The owned rows come out as T global steps would
    leave them when the halos are W = T + 1 rows deep."""
    _check_T(wf_t)
    if ops.mur_x_rows is None:
        raise ValueError("stream_shard_steps needs slab operands "
                         "(build_stream_shard_stepper)")
    if not _on_cuda(st.h[0]):
        return fdtd_shard.shard_steps_plain(ops, st, wf_t)
    _stream_launch(ops, st, wf_t, "stream_shard_steps", "shard_march", blocks)


def stream_steps_batch_plain(ops: YeeOperands, st: YeeBatch,
                             wf_t: Sequence[float], active) -> None:
    """:func:`stream_steps_plain` on the views of every active variant
    (its own ca/cb, E buffer and H set); its parity flips with each of
    the T steps, its H and ψ stay in their set. A frozen variant's
    tensors, parity and set stay as they are."""
    for b, on in enumerate(fdtd_cuda._active_mask(active, st.batch)):
        if on:
            vs = st.variant(b)
            stream_steps_plain(fdtd_cuda.variant_operands(ops, b), vs, wf_t)
            st.parity[b] = vs.parity


def stream_steps_batch(ops: YeeOperands, st: YeeBatch, wf_t: Sequence[float],
                       active) -> None:
    """T = ``len(wf_t)`` leapfrog steps of every variant b with
    ``active[b]`` (``ops`` from ``fdtd_cuda.batch_operands``; every variant
    driven by the same samples), the batched form of :func:`stream_steps`
    (K2's ``coef_ops_from`` under ``jax.vmap``). On a CUDA tensor one
    launch of the march (MUR, PEC or CPML) for all active variants, which
    must share their E buffer and H set (``fdtd_cuda.one_set``): it writes
    the other E buffer and the other set (made at the first launch) and
    flips both for each active variant. A frozen variant's blocks return
    before any load; its tensors, parity and set stay as they are. On a
    CPU tensor :func:`stream_steps_batch_plain`."""
    _check_T(wf_t)
    if ops.mur_x_rows is not None:
        raise ValueError("stream_steps_batch takes a whole grid, not a slab")
    act = fdtd_cuda._active_mask(active, st.batch)
    if not _on_cuda(st.h[0]):
        return stream_steps_batch_plain(ops, st, wf_t, act)
    live = [b for b in range(st.batch) if act[b]]
    if not live:
        return None  # nothing to step
    p, q = fdtd_cuda.one_set(st, live, "stream_steps_batch")
    if not st.h1:
        st.h1 = tuple(torch.zeros_like(t) for t in st.h)
        st.psi_e1 = tuple(torch.zeros_like(t) for t in st.psi_e)
        st.psi_h1 = tuple(torch.zeros_like(t) for t in st.psi_h)
    mask = fdtd_cuda._device_mask(st, act)
    buf = st._stream
    if buf is None or not buf.fits(ops, st, mask):
        buf = st._stream = _BatchBuffers(ops, st, mask)
    addr = buf.addr(st, p, q)
    lib = _library()
    _check_march_smem(lib, buf, addr, ops, len(wf_t), None, st.batch)
    _launch(lib, lib.fdtd_stream_march_batch, addr, wf_t, ops.device,
            "stream_steps_batch", "stream_march_batch", st.batch)
    for b in live:
        st.parity[b] ^= 1
        st.hset[b] ^= 1


def blocks_per_sm(st: YeeState, T: int) -> int:
    """Blocks of the march one SM holds at once for a T-step launch on the
    arrays ``st`` was last launched on (CUDA's occupancy API on the
    kernel's registers, threads and shared memory)."""
    buf = st._stream
    if buf is None:
        raise ValueError("no stream launch on this state yet")
    with device_guard(st.h[0].device):
        n = _library().fdtd_march_blocks_per_sm(buf.addr[0], T)
    if n < 0:
        raise RuntimeError(_library().fdtd_stream_error_string(-n).decode())
    return n


def _check_T(wf_t) -> None:
    if not 1 <= len(wf_t) <= MAX_T:
        raise ValueError(f"a stream launch takes 1..{MAX_T} samples, "
                         f"got {len(wf_t)}")


def _check_march_smem(lib, buf, addr: int, ops, T: int, blocks,
                      batch: int = 1) -> None:
    """Raise unless C and :func:`march_plan` agree on the march's shared
    memory at T (checked once per T and buffers)."""
    if T in buf.march_T:
        return
    smem = march_plan(buf.shape, ops.grid_shape, T, ops.mur is not None,
                      buf.view[2], blocks, batch, ops.pml is not None)[4]
    got = lib.fdtd_march_smem_bytes(addr, T)
    if got != smem:
        raise RuntimeError(f"march shared memory: C {got} B, "
                           f"march_plan {smem} B at T={T}")
    buf.march_T.add(T)


def _launch(lib, fn, addr: int, wf_t, dev, wrapper: str, route: str,
            *batch) -> None:
    """Launch ``fn`` on the packed arguments at ``addr`` with the samples
    ``wf_t`` (and the batch size for a batched kernel); raise on a failed
    launch, else count it, in ``cpml_staged_launches`` too where the
    arguments carry CPML (``has_pml``, which the C side launches
    ``cpml_march_kernel`` for)."""
    samples = (ctypes.c_float * MAX_T)(*[float(s) for s in wf_t])
    code = launch(dev, fn, addr, ctypes.addressof(samples), len(wf_t), *batch)
    if code != 0:
        msg = lib.fdtd_stream_error_string(code).decode()
        raise RuntimeError(f"CUDA kernel {route} failed: {msg} ({code})")
    global cpml_staged_launches
    launches[wrapper] += 1
    launches_by_kernel[route] += 1
    cpml_staged_launches += _StreamArgs.from_address(addr).has_pml


def _stream_launch(ops, st, wf_t, wrapper: str, route: str,
                   blocks=None) -> None:
    lib = _library()
    buf = st._stream
    cur = buf.current(ops, st, blocks) if buf is not None else None
    if cur is None:
        buf = st._stream = _StreamBuffers(ops, st, blocks)
        cur = 0
    _check_march_smem(lib, buf, buf.addr[cur], ops, len(wf_t), blocks)
    _launch(lib, lib.fdtd_stream_march, buf.addr[cur], wf_t, ops.device,
            wrapper, route)
    nxt = buf.sets[1 - cur]
    st.e[st.parity] = nxt[0:3]
    st.h = nxt[3:6]
    if ops.pml is not None:
        st.psi_e = nxt[6:12]
        st.psi_h = nxt[12:18]
    st._cargs = st._chunk = None  # K1's packed pointers named the other set


# ---------------------------------------------------------------------------
# the slab stepper (the explicit run at Pz > fdtd_shard.MAX_PZ)
# ---------------------------------------------------------------------------

def stream_shard_geometry(Px: int, Py: int, Pz: int, D: int, n_dev: int,
                          mur: bool, pml: bool, t_steps=None):
    """``(n, T, W, m, rem)`` of K2's slab stepper: n = Px / n_dev owned
    rows, T steps a launch, halos of W = T + 1 rows (the JAX package's
    Hx: the top MUR wall may be a block's first row, its neighbour then in
    the lower halo), m = n + 2W slab rows and the last launch of a probe
    interval rem = D % T steps. T is ``t_steps`` or the deepest in
    1..min(n − 1, D, MAX_T) that the march takes at the slab's shape
    (:func:`max_T`); the JAX package's VMEM picker does not carry over,
    its constraints (T + 1 ≤ n, T ≤ D) do."""
    n = fdtd_shard.owned_rows(Px, n_dev)
    top = min(n - 1, int(D), MAX_T)

    def fits(T):
        try:
            return T <= max_T((n + 2 * T + 2, Py, Pz), mur, pml)
        except ValueError:
            return False

    T = int(t_steps) if t_steps else max(
        (t for t in range(1, top + 1) if fits(t)), default=0)
    if not (1 <= T <= top and fits(T)):
        raise ValueError(f"no stream slab of T={T} steps: n={n}, D={D}, "
                         f"slab y-z {Py}x{Pz}, at most T={top}")
    return n, T, T + 1, n + 2 * T + 2, int(D) % T


def build_stream_shard_stepper(sim, n_dev: int, rank: int, device=None,
                               t_steps=None) -> fdtd_shard.ShardStepper:
    """The slab of ``rank`` of an x-split over ``n_dev`` ranks for
    :func:`stream_shard_steps` (the counterpart of K2's ``shard=``): a
    ``fdtd_shard.ShardStepper`` with K = T and W = T + 1
    (:func:`stream_shard_geometry`), its operands cut on the host by
    ``fdtd_shard.slab_operands`` and put on ``device`` (default
    ``sim.device``)."""
    if not 0 <= rank < n_dev:
        raise ValueError(f"rank {rank} outside [0, {n_dev})")
    Px, Py, Pz = sim.padded_shape
    mur = sim.cfg.boundary.upper().startswith("MUR")
    pml = sim._aux[3] is not None
    n, T, W, m, rem = stream_shard_geometry(Px, Py, Pz, sim.probe_decim, n_dev,
                                            mur, pml, t_steps)
    return fdtd_shard.ShardStepper(
        n_dev=n_dev, rank=rank, n=n, K=T, W=W, m=m, rem=rem,
        ops=fdtd_shard.slab_operands(sim, rank, n, W, device))


# the engine's entry points: K1's and the stream stepper's, unbatched and
# batched, through the kernels (CUDA tensors) or always through the plain
# twins
kernels = SimpleNamespace(**vars(fdtd_cuda.kernels), stream_steps=stream_steps,
                          stream_steps_batch=stream_steps_batch)
plain = SimpleNamespace(**vars(fdtd_cuda.plain), stream_steps=stream_steps_plain,
                        stream_steps_batch=stream_steps_batch_plain)
