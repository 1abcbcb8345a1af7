"""What the persistent steppers share on the host: K1's ``chunk_steps``
(``fdtd_cuda``), K3 (``fdtd_shard``) and K4 (``fdtd_steps``).

All three kernels are built from ``csrc/yee_persist.cuh``: one cooperative
launch runs whole leapfrog steps, an H pass and an E pass with the MUR
walls fused in, 2 grid barriers a step. Each comes in two storage forms
of one kernel, which the wrapper picks from the shape (:func:`plan`):

- ``"resident"``: each thread owns at most ``cells_per_thread`` cells for
  the whole launch, and their ca, cb, source stamp, (i, j, k) and the
  per-axis profiles sit in the block's shared memory;
- ``"streamed"``: each pass reads every operand from memory, for grids
  whose operands do not fit on chip.

Either form is exact (bit-equal to the plain twins); a form that fails to
plan, build or launch raises. K1's batched form (``chunk_steps_batch``)
steps B variants of one grid in one launch: :func:`pack` then takes the
per-variant arrays as (B, X, Y, Z) and :func:`plan` the batch, so the
occupancy query decides the form for the batched shape.

- :class:`PersistOps`: the ctypes mirror of ``struct persist::Ops``;
- :func:`pack`: a state's and its operands' pointers into one;
- :class:`Plan` and :func:`plan`: the form, blocks, threads and shared
  bytes of a launch, as the library's ``*_plan`` function decides them.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import TYPE_CHECKING, Dict, Optional, Tuple

if TYPE_CHECKING:  # fdtd_cuda imports this module
    from .fdtd_cuda import YeeOperands, YeeState

FORMS = ("streamed", "resident")
BARRIERS_PER_STEP = 2  # grid.sync() after the H pass and after the E pass

_P = ctypes.c_void_p


class PersistOps(ctypes.Structure):
    """Field-for-field mirror of ``struct persist::Ops`` in
    csrc/yee_persist.cuh."""

    _fields_ = [
        ("e", _P * 6), ("h", _P * 3), ("psi_e", _P * 6), ("psi_h", _P * 6),
        ("ca", _P * 3), ("cb", _P * 3), ("src", _P * 3),
        ("prof", _P * 18),  # inv_p, inv_d, bh, ch, be, ce; x, y, z each
        ("nx", ctypes.c_int), ("ny", ctypes.c_int), ("nz", ctypes.c_int),
        ("wall_lo", ctypes.c_int * 3), ("wall_hi", ctypes.c_int * 3),
        ("has_pml", ctypes.c_int), ("has_mur", ctypes.c_int),
        ("dtmu", ctypes.c_float), ("mur_c", ctypes.c_float * 6),
    ]


@dataclasses.dataclass(frozen=True)
class Plan:
    """One launch's shape: the storage form, cells a thread owns in the
    resident form (0 streamed), blocks × threads, dynamic shared bytes."""

    form: str
    cells_per_thread: int
    blocks: int
    threads: int
    smem_bytes: int


def pack(ops: YeeOperands, st: YeeState, x_walls: Tuple[int, int],
         batch: int = 0) -> PersistOps:
    """The pointers and scalars of (ops, st); the MUR x walls at array rows
    ``x_walls`` (a slab's may lie outside it), the y and z walls at the
    grid planes 0 and q − 1. MUR and CPML exclude each other. ``batch`` B
    > 0: the fields, ψ and ca/cb are (B, X, Y, Z) arrays of B variants
    (the source stamps and profiles shared), packed at variant 0."""
    from .fdtd_cuda import _ptr

    if ops.mur is not None and ops.pml is not None:
        raise ValueError("MUR walls and CPML exclude each other")
    if ops.mur is not None and min(ops.grid_shape) < 3:
        raise ValueError(f"MUR needs >= 3 planes per axis, grid {ops.grid_shape}")
    if ops.mur_y_rows is not None:
        raise ValueError("an x-y block (mur_y_rows) is the per-step walk's; "
                         "the persistent steppers take a whole y extent")
    shp = tuple(ops.shape)
    var = (batch,) + shp if batch else shp  # a per-variant array's shape
    if max(batch, 1) * shp[0] * shp[1] * shp[2] >= 2 ** 31:
        raise ValueError(f"{var}: the persistent steppers take < 2^31 cells "
                         "(all variants together)")
    dev = ops.device
    a = PersistOps()
    for p in range(2):
        for m in range(3):
            a.e[3 * p + m] = _ptr(st.e[p][m], var, dev=dev)
    profiles = [ops.inv_p, ops.inv_d]
    if ops.pml is not None:
        profiles += [ops.pml[key] for key in ("bh", "ch", "be", "ce")]
        for m in range(6):
            a.psi_e[m] = _ptr(st.psi_e[m], var, dev=dev)
            a.psi_h[m] = _ptr(st.psi_h[m], var, dev=dev)
    for m in range(3):
        a.h[m] = _ptr(st.h[m], var, dev=dev)
        a.ca[m] = _ptr(ops.ca[m], var, dev=dev)
        a.cb[m] = _ptr(ops.cb[m], var, dev=dev)
        a.src[m] = _ptr(ops.src[m], shp, dev=dev)
    for q, prof in enumerate(profiles):
        for m in range(3):
            a.prof[3 * q + m] = _ptr(prof[m], (shp[m],), dev=dev)
    a.nx, a.ny, a.nz = shp
    a.wall_lo[:] = (x_walls[0], 0, 0)
    a.wall_hi[:] = (x_walls[1], ops.grid_shape[1] - 1, ops.grid_shape[2] - 1)
    a.has_pml = int(ops.pml is not None)
    a.has_mur = int(ops.mur is not None)
    a.dtmu = ops.dtmu
    for b in range(3):
        for side in range(2):
            a.mur_c[2 * b + side] = ops.mur[b][side] if ops.mur else 0.0
    return a


def bind(lib, prefix: str) -> None:
    """Declare the C functions every persistent stepper library exports."""
    _i = ctypes.c_int
    fn = getattr(lib, f"{prefix}_args_size")
    fn.argtypes, fn.restype = [], _i
    fn = getattr(lib, f"{prefix}_grid_blocks")
    fn.argtypes, fn.restype = [ctypes.POINTER(_i)], _i
    fn = getattr(lib, f"{prefix}_plan")
    fn.argtypes, fn.restype = [_P, _i, ctypes.POINTER(_i)], _i
    fn = getattr(lib, f"{prefix}_error_string")
    fn.argtypes, fn.restype = [_i], ctypes.c_char_p


def check(lib, prefix: str, code: int, what: str) -> None:
    if code != 0:
        msg = getattr(lib, f"{prefix}_error_string")(code).decode()
        raise RuntimeError(f"CUDA kernel {what} failed: {msg} ({code})")


# plans by (library, device, shape, boundary, form, batch): a plan depends
# on nothing else (each boundary has kernels of its own, whose occupancy may
# differ), and a query costs an occupancy call per form
_PLANS: Dict[tuple, Plan] = {}


def plan(lib, prefix: str, ops: YeeOperands, args_addr: int,
         form: Optional[str], what: str, batch: int = 0) -> Plan:
    """The library's plan for ``ops``, packed at ``args_addr``: ``form``
    None lets the shape decide, else "resident" or "streamed" (the
    resident form raises where it does not fit). ``batch`` B > 0 plans the
    batched kernels for B variants (the library's ``*_batch_plan``)."""
    if form is not None and form not in FORMS:
        raise ValueError(f"form must be one of {FORMS} or None, got {form!r}")
    key = (prefix, str(ops.device), tuple(ops.shape), ops.pml is not None,
           ops.mur is not None, form, batch)
    if key not in _PLANS:
        from .fdtd_cuda import device_guard

        with device_guard(ops.device):  # the occupancy of ops' card
            _PLANS[key] = _query(lib, prefix, args_addr, form, what, batch)
    return _PLANS[key]


def _query(lib, prefix: str, args_addr: int, form: Optional[str],
           what: str, batch: int) -> Plan:
    request = -1 if form is None else FORMS.index(form)
    out = (ctypes.c_int * 4)()
    if batch:
        code = getattr(lib, f"{prefix}_batch_plan")(args_addr, request, batch,
                                                    out)
    else:
        code = getattr(lib, f"{prefix}_plan")(args_addr, request, out)
    if code == 1 and form == "resident":  # cudaErrorInvalidValue
        raise ValueError(f"{what}: the resident form does not fit this shape "
                         f"on this card ({code})")
    check(lib, prefix, code, f"{what} plan")
    cells, blocks, smem, threads = out
    return Plan(form=FORMS[cells > 0], cells_per_thread=cells, blocks=blocks,
                threads=threads, smem_bytes=smem)


def grid_blocks(lib, prefix: str, what: str) -> int:
    """Blocks the card keeps resident at once for the streamed form."""
    out = ctypes.c_int(0)
    code = getattr(lib, f"{prefix}_grid_blocks")(ctypes.byref(out))
    check(lib, prefix, code, f"{what} occupancy query")
    return out.value
