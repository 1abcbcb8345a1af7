"""The shard stepper: K leapfrog steps of one rank's x-slab per CUDA launch.

Counterpart of ``build_pallas_shard_stepper`` in
``fdtd_solver_antennas_tpu/ops/fdtd_pallas.py`` (the TPU kernel K3), the
per-device kernel of the explicit multi-device run
(``parallel/explicit.py``). The grid is cut along x into ``n_dev`` blocks
of ``n = Px // n_dev`` rows. Each rank keeps its block with a halo of
``W`` rows on each side, a slab of ``m = n + 2W`` rows, and advances it
K steps per launch. Dependencies travel one row per step, so after K ≤ W
steps the owned rows ``[W, W + n)`` are exact; the caller then restocks
the halos from the neighbours (one exchange per K steps).

- :func:`build_shard_stepper`: the geometry (n, K, W, m and the
  remainder ``rem = D % K``) and the slab's operands
  (:func:`slab_operands`, which K2's slab stepper shares), a
  :class:`~.fdtd_cuda.YeeOperands` of shape ``(m, Py, Pz)``: ca/cb, x
  profiles and source stamps cut from the host copies, rows outside
  ``[0, Px)`` zero; a slab-local probe table; the slab rows of the MUR x
  walls (the JAX package's one-hot ``m0``/``mt`` columns). Its route is
  Pz ≤ :data:`MAX_PZ`.
- :func:`shard_steps`: ``len(wf_window)`` steps (K, or the remainder) in
  one launch of ``csrc/fdtd_shard.cu`` (2 grid barriers a step, the MUR
  walls fused into the E pass; the storage form, resident or streamed,
  picked from the shape by :func:`launch_plan`, see ``ops/persist.py``);
  on a CPU tensor :func:`shard_steps_plain`, the same steps built from
  K1's plain twins (their x walls at the slab's ``mur_x_rows``). A CUDA
  tensor always goes to the kernel; a failed plan, build or launch
  raises.

``launches`` counts kernel launches, as ``fdtd_cuda.launches`` does for
K1, and ``launches_by_form`` the same launches by storage form. The TPU
kernel's VMEM picker (``shard_vmem_bytes``) does not carry over: K
defaults to ``min(n, D, 32)``. K only sets how often halos are
exchanged; the owned rows come out the same for any K.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from . import fdtd_cuda, persist
from .fdtd_cuda import ProbeTable, YeeOperands, YeeState, _on_cuda, _stream

KERNELS = ("shard_steps",)

# kernel launches per wrapper; only the wrapper's CUDA branch adds to it
launches: Dict[str, int] = dict.fromkeys(KERNELS, 0)
# the same launches by storage form (``persist.FORMS``)
launches_by_form: Dict[str, int] = dict.fromkeys(persist.FORMS, 0)

# Steps per launch the kernel accepts (the source samples ride in its
# parameters).
MAX_K = 64
# Largest z extent of this kernel's route; above it the explicit run takes
# K2's slab stepper (``ops/fdtd_stream.py``), as the JAX package takes its
# sharded stream kernel.
MAX_PZ = 128


def reset_launch_counts() -> None:
    for k in KERNELS:
        launches[k] = 0
    for k in persist.FORMS:
        launches_by_form[k] = 0


def owned_rows(Px: int, n_dev: int) -> int:
    """Rows each of ``n_dev`` ranks owns of ``Px``, at least 2."""
    if Px % n_dev:
        raise ValueError(
            f"padded x extent {Px} not divisible by {n_dev} ranks; build the "
            f"simulation with pad_multiple=({n_dev}, 1, 1)")
    n = Px // n_dev
    if n < 2:
        raise ValueError(f"need >= 2 rows per rank (Px={Px}, {n_dev} ranks)")
    return n


def shard_geometry(Px: int, Qx: int, D: int, n_dev: int, mur: bool,
                   k_steps: Optional[int] = None) -> Tuple[int, int, int, int, int]:
    """``(n, K, W, m, rem)`` of an x-split of ``Px`` rows over ``n_dev``
    ranks, D steps per probe interval.

    K is ``k_steps`` or ``min(n, D, 32)``. When the top MUR wall (global
    row Qx−1) is a block's first row, its fix at the K-th step reads the
    lowest halo row, which edge effects reach after K steps: then
    K ≤ n − 1 and the halo is one row wider, W = K + 1.
    """
    n = owned_rows(Px, n_dev)
    straddle = mur and (Qx - 1) % n == 0
    K = int(k_steps) if k_steps else min(n, D, 32)
    if straddle:
        K = min(K, n - 1)
    if not 1 <= K <= min(n, D, MAX_K):
        raise ValueError(
            f"k_steps={K} must be in [1, min(n={n}, D={D}, {MAX_K})]")
    W = K + 1 if straddle else K
    return n, K, W, n + 2 * W, D % K


@dataclasses.dataclass
class ShardStepper:
    """One rank's slab: geometry and operands on one device."""

    n_dev: int
    rank: int
    n: int  # owned rows
    K: int  # steps per launch
    W: int  # halo rows per side
    m: int  # slab rows, n + 2W
    rem: int  # D % K: steps of the last launch of a probe interval
    ops: YeeOperands

    @property
    def owned(self) -> slice:
        """Slab rows this rank owns."""
        return slice(self.W, self.W + self.n)

    @property
    def rows(self) -> slice:
        """Global rows this rank owns."""
        return slice(self.rank * self.n, (self.rank + 1) * self.n)

    def new_state(self) -> YeeState:
        return fdtd_cuda.new_state(self.ops.shape, self.ops.device,
                                   self.ops.pml is not None)


def _cut(ga, axis: int, rank: int, n: int, W: int) -> np.ndarray:
    """Global rows of ``axis`` → this rank's halo-extended ``n + 2W`` rows,
    ``[rank·n − W, (rank + 1)·n + W)``; rows outside the array are zero
    (out-of-domain fields are zero, and so must their update coefficients
    be)."""
    ga = np.asarray(ga, np.float32)
    m = n + 2 * W
    out = np.zeros(ga.shape[:axis] + (m,) + ga.shape[axis + 1:], np.float32)
    g0 = rank * n - W
    s0, s1 = max(0, g0), min(ga.shape[axis], g0 + m)
    dst = [slice(None)] * ga.ndim
    src = [slice(None)] * ga.ndim
    dst[axis], src[axis] = slice(s0 - g0, s1 - g0), slice(s0, s1)
    out[tuple(dst)] = ga[tuple(src)]
    return out


def _block_probe_blocks(blocks, shape, cut):
    """The global probe blocks (flat indices into the (Px, Py, Pz) stack
    [Ex Ey Ez Hx Hy Hz]) → indices into this rank's block stack, block by
    block at the same widths; ``cut`` is ``(rank, n, W)`` per axis (z
    whole). Entries on cells the rank does not own get index 0 and weight
    0, so the rank's samples are partial sums (the JAX package's
    ``_localize_gathers``)."""
    Px, Py, Pz = shape
    (rx, nx, Wx), (ry, ny, Wy) = cut
    mx, my = nx + 2 * Wx, ny + 2 * Wy
    out = []
    for idx, w in blocks:
        comp, rest = np.divmod(np.asarray(idx, np.int64), Px * Py * Pz)
        i, jk = np.divmod(rest, Py * Pz)
        j, k = np.divmod(jk, Pz)
        own = ((i >= rx * nx) & (i < (rx + 1) * nx)
               & (j >= ry * ny) & (j < (ry + 1) * ny))
        local = ((comp * mx + Wx + i - rx * nx) * my + Wy + j - ry * ny) * Pz + k
        out.append((np.where(own, local, 0), np.where(own, w, 0.0)))
    return out


def slab_operands(sim, rank: int, n: int, W: int, device=None,
                  y=None) -> YeeOperands:
    """The operands of ``rank``'s slab of ``m = n + 2W`` rows, on
    ``device`` (default ``sim.device``): ca/cb, x profiles and source
    stamps cut on the host from ``sim._coeffs_np`` and ``sim._aux``, rows
    outside ``[0, Px)`` zero; the slab probe table; the slab rows of the
    MUR x walls. Both slab steppers (K3 here, K2's in
    ``ops/fdtd_stream.py``) take their operands from it. ``y = (rank_y,
    n_y, W_y)`` cuts y the same way, a block of the explicit path's walk
    over an x × y grid of ranks (``mur_y_rows`` then places the y walls)."""
    from .fdtd import build_probe_gathers, build_src_mats, probe_blocks

    Px, Py, Pz = sim.padded_shape
    cut = ((rank, n, W), y if y is not None else (0, Py, 0))
    dev = torch.device(device) if device is not None else sim.device
    inv_p, inv_d, mur_coef, pml = sim._aux

    def block(a):
        for axis, (r, nn, w) in enumerate(cut):
            if (r, nn, w) != (0, a.shape[axis], 0):
                a = _cut(a, axis, r, nn, w)
        return np.asarray(a, np.float32)

    def to_dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def axis_vec(prof, a):  # x and y profiles are cut to the block
        return to_dev(_cut(prof, 0, *cut[a]) if a < 2 else prof)

    coeffs = {k: to_dev(block(v)) for k, v in sim._coeffs_np.items()}
    src = build_src_mats(sim, Px, Py, Pz)
    blocks = _block_probe_blocks(
        probe_blocks(build_probe_gathers(sim), Px * Py * Pz), (Px, Py, Pz),
        cut)
    shape = tuple(nn + 2 * w for _r, nn, w in cut) + (Pz,)

    def walls(a):
        """The block's planes of the global walls 0 and Q−1 of axis a."""
        r, nn, w = cut[a]
        g0 = r * nn - w  # global plane of the block's plane 0
        return (0 - g0, sim.grid.shape[a] - 1 - g0)

    return YeeOperands(
        shape=shape,
        grid_shape=tuple(sim.grid.shape),
        dtmu=sim.operands.dtmu,
        inv_p=tuple(axis_vec(inv_p[a], a) for a in range(3)),
        inv_d=tuple(axis_vec(inv_d[a], a) for a in range(3)),
        ca=tuple(coeffs["ca_" + c] for c in ("ex", "ey", "ez")),
        cb=tuple(coeffs["cb_" + c] for c in ("ex", "ey", "ez")),
        src=tuple(to_dev(block(src[a])) if a in src else None for a in range(3)),
        mur=mur_coef,
        pml=None if pml is None else {
            key: tuple(axis_vec(pml[a][kind][j], a) for a in range(3))
            for key, kind, j in (("bh", "half", 0), ("ch", "half", 1),
                                 ("be", "node", 0), ("ce", "node", 1))
        },
        probes=ProbeTable.from_blocks(blocks, int(np.prod(shape)), dev),
        mur_x_rows=walls(0),
        mur_y_rows=walls(1) if y is not None else None,
    )


def build_shard_stepper(sim, n_dev: int, rank: int, k_steps=None,
                        device=None) -> ShardStepper:
    """The slab of ``rank`` of an x-split over ``n_dev`` ranks, with its
    operands on ``device`` (default ``sim.device``). Everything is cut on
    the host (:func:`slab_operands`); only the slab goes to the device."""
    Px, Py, Pz = sim.padded_shape
    if Pz > MAX_PZ:
        raise ValueError(f"Pz={Pz} > {MAX_PZ}: not the shard kernel's route")
    if not 0 <= rank < n_dev:
        raise ValueError(f"rank {rank} outside [0, {n_dev})")
    mur = sim.cfg.boundary.upper().startswith("MUR")
    n, K, W, m, rem = shard_geometry(Px, sim.grid.shape[0],
                                     int(sim.probe_decim), n_dev, mur, k_steps)
    return ShardStepper(n_dev=n_dev, rank=rank, n=n, K=K, W=W, m=m, rem=rem,
                        ops=slab_operands(sim, rank, n, W, device))


# ---------------------------------------------------------------------------
# plain PyTorch twin (the CPU path, and the reference on the card)
# ---------------------------------------------------------------------------

def shard_steps_plain(ops: YeeOperands, st: YeeState,
                      wf_window: Sequence[float]) -> None:
    """``len(wf_window)`` leapfrog steps of a slab: H, E with source
    sample ``wf_window[k]``, then the MUR walls x (at ``mur_x_rows``), y,
    z, each reading the old E (K1's plain twins on the slab)."""
    for s in wf_window:
        fdtd_cuda.leapfrog_step(fdtd_cuda.plain, ops, st, s)


# ---------------------------------------------------------------------------
# CUDA launch
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_PREFIX = "fdtd_shard"


class _ShardArgs(ctypes.Structure):
    """Field-for-field mirror of ``struct ShardArgs`` in csrc/fdtd_shard.cu."""

    _fields_ = [("o", persist.PersistOps), ("wf", ctypes.c_float * MAX_K)]


_lib = None


def _library():
    """Build (first use) and bind the kernel library."""
    global _lib
    if _lib is None:
        from . import _build

        lib = _build.load("fdtd_shard")
        persist.bind(lib, _PREFIX)
        lib.fdtd_shard_max_k.argtypes = []
        lib.fdtd_shard_max_k.restype = ctypes.c_int
        lib.fdtd_shard_steps.argtypes = [_P, ctypes.c_int, ctypes.c_int,
                                         ctypes.c_int, ctypes.c_int, _P]
        lib.fdtd_shard_steps.restype = ctypes.c_int
        if lib.fdtd_shard_args_size() != ctypes.sizeof(_ShardArgs):
            raise RuntimeError(
                f"ShardArgs layout mismatch: C {lib.fdtd_shard_args_size()} "
                f"bytes, ctypes {ctypes.sizeof(_ShardArgs)}")
        if lib.fdtd_shard_max_k() != MAX_K:
            raise RuntimeError("MAX_K differs between C and Python")
        _lib = lib
    return _lib


def grid_blocks() -> int:
    """Blocks the card keeps resident at once for the streamed form, the
    most any launch uses (one launch must hold every block)."""
    return persist.grid_blocks(_library(), _PREFIX, "shard_steps")


def _cuda_args(ops: YeeOperands, st: YeeState) -> _ShardArgs:
    """The packed kernel arguments of (ops, st), built once per pair and
    kept on the state; the kernel updates the state's tensors in place,
    so the pointers stay valid across launches and halo restocks."""
    cached = st._shard
    if cached is not None and cached[0] is ops:
        return cached[1]
    if ops.mur_x_rows is None:
        raise ValueError("shard_steps needs slab operands (build_shard_stepper)")
    a = _ShardArgs()
    a.o = persist.pack(ops, st, ops.mur_x_rows)
    st._shard = (ops, a)
    return a


def launch_plan(ops: YeeOperands, st: YeeState,
                form: Optional[str] = None) -> persist.Plan:
    """The storage form, blocks × threads and shared bytes the kernel
    launches with for (ops, st): ``form`` None lets the shape pick (the
    resident form where the operands fit on chip), else "resident" or
    "streamed"."""
    a = _cuda_args(ops, st)
    return persist.plan(_library(), _PREFIX, ops, ctypes.addressof(a), form,
                        "shard_steps")


def shard_steps(ops: YeeOperands, st: YeeState,
                wf_window: Sequence[float], *,
                form: Optional[str] = None) -> None:
    """Advance a slab state by ``len(wf_window)`` leapfrog steps in one
    launch; ``wf_window[k]`` is the source sample of step k. The kernel
    updates the state's tensors in place; ``st.parity`` names the E
    buffer that holds the result. ``form`` forces a storage form
    (:func:`launch_plan`); the CPU runs the plain twin whatever it says."""
    k = len(wf_window)
    if not 1 <= k <= MAX_K:
        raise ValueError(f"shard_steps takes 1..{MAX_K} samples, got {k}")
    if not _on_cuda(st.h[0]):
        return shard_steps_plain(ops, st, wf_window)
    lib = _library()
    a = _cuda_args(ops, st)
    plan = launch_plan(ops, st, form)
    a.wf[:k] = [float(s) for s in wf_window]
    code = lib.fdtd_shard_steps(ctypes.addressof(a), st.parity, k,
                                plan.cells_per_thread, plan.blocks,
                                _stream(ops.device))
    persist.check(lib, _PREFIX, code, "shard_steps")
    launches["shard_steps"] += 1
    launches_by_form[plan.form] += 1
    st.parity ^= k & 1
