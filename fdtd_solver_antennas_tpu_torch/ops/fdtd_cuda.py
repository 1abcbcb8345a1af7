"""The chunk stepper's kernels: CUDA launches and their plain PyTorch twins.

Counterpart of ``fdtd_solver_antennas_tpu/ops/fdtd_pallas.py``. The TPU
kernel ``build_pallas_chunk_stepper`` runs a whole termination chunk
(n_sub probe intervals × D leapfrog steps) in one call and extracts the
probe samples in the kernel. The port computes the same thing with four
kernels from ``csrc/fdtd_chunk.cu``, launched by the engine's chunk loop
(``ops/fdtd.py``):

- :func:`h_update`: H half-step, with the six ψ_h recursions under CPML;
- :func:`e_update`: E half-step into the other E buffer, with ca/cb, the
  six ψ_e recursions and the port-source FMA ``src·s(t)``;
- :func:`mur_faces`: the first-order MUR walls of one axis;
- :func:`probe_gather`: port V/I and Huygens-face samples as one weighted
  gather, written to one row of the staging buffer.

Each wrapper runs the kernel for CUDA tensors and the plain PyTorch twin
beside it (``*_plain``) for CPU tensors; any other device raises. A
kernel error raises; nothing falls back. ``launches`` counts the kernel
launches of each wrapper, so a run can show it went through the kernels.
"""

from __future__ import annotations

import ctypes
import dataclasses
from types import SimpleNamespace
from typing import Dict, Optional, Tuple

import torch

PSI_KEYS = ("xy", "xz", "yz", "yx", "zx", "zy")
KERNELS = ("h_update", "e_update", "mur_faces", "probe_gather")

# kernel launches per wrapper; only the wrappers' CUDA branches add to it
launches: Dict[str, int] = dict.fromkeys(KERNELS, 0)


def reset_launch_counts() -> None:
    for k in KERNELS:
        launches[k] = 0


@dataclasses.dataclass
class YeeOperands:
    """What a leapfrog step reads and never writes, on one device.

    1-D tensors are per-axis profiles (length of that axis); 3-D tensors
    have ``shape``. ``grid_shape`` places the MUR wall planes. The probe
    table holds flat indices into the stack ``[Ex Ey Ez Hx Hy Hz]``.
    """

    shape: Tuple[int, int, int]
    grid_shape: Tuple[int, int, int]
    dtmu: float
    inv_p: Tuple[torch.Tensor, ...]
    inv_d: Tuple[torch.Tensor, ...]
    ca: Tuple[torch.Tensor, ...]
    cb: Tuple[torch.Tensor, ...]
    src: Tuple[Optional[torch.Tensor], ...]
    mur: Optional[Tuple[Tuple[float, float], ...]]
    pml: Optional[Dict[str, Tuple[torch.Tensor, ...]]]  # bh ch be ce
    probe_idx: torch.Tensor  # (rows, k) int32
    probe_w: torch.Tensor  # (rows, k) float32

    @property
    def device(self) -> torch.device:
        return self.ca[0].device


@dataclasses.dataclass
class YeeState:
    """The fields a step advances. ``e[parity]`` is the current E;
    ``e_update`` writes ``e[1 - parity]`` and :func:`leapfrog_step` flips
    ``parity``. ψ tuples follow :data:`PSI_KEYS` and are empty without
    CPML. The kernels update the tensors in place and pack their pointers
    once per (operands, state) pair, so a state's tensors are never
    swapped for others."""

    e: list  # [(Ex, Ey, Ez), (Ex, Ey, Ez)]
    h: Tuple[torch.Tensor, ...]
    psi_e: Tuple[torch.Tensor, ...] = ()
    psi_h: Tuple[torch.Tensor, ...] = ()
    parity: int = 0
    _cargs: object = None

    @property
    def fields(self) -> Tuple[torch.Tensor, ...]:
        return (*self.e[self.parity], *self.h)


def new_state(shape, device, pml: bool) -> YeeState:
    def z():
        return torch.zeros(shape, dtype=torch.float32, device=device)

    psi = (lambda: tuple(z() for _ in PSI_KEYS)) if pml else (lambda: ())
    return YeeState(
        e=[(z(), z(), z()), (z(), z(), z())],
        h=(z(), z(), z()),
        psi_e=psi(),
        psi_h=psi(),
    )


# ---------------------------------------------------------------------------
# plain PyTorch twins (the CPU path, and the reference on the card)
# ---------------------------------------------------------------------------

def _bvec(v: torch.Tensor, axis: int) -> torch.Tensor:
    shape = [1, 1, 1]
    shape[axis] = -1
    return v.view(shape)


def _fdiff(a: torch.Tensor, dim: int) -> torch.Tensor:
    """a[i+1] − a[i]; the neighbour past the last index reads as 0."""
    return torch.diff(a, dim=dim, append=torch.zeros_like(a.narrow(dim, 0, 1)))


def _bdiff(a: torch.Tensor, dim: int) -> torch.Tensor:
    """a[i] − a[i−1]; the neighbour before index 0 reads as 0."""
    return torch.diff(a, dim=dim, prepend=torch.zeros_like(a.narrow(dim, 0, 1)))


def h_update_plain(ops: YeeOperands, st: YeeState) -> None:
    Ex, Ey, Ez = st.e[st.parity]
    Hx, Hy, Hz = st.h
    ipx, ipy, ipz = (_bvec(ops.inv_p[a], a) for a in range(3))
    dEz_y = _fdiff(Ez, 1) * ipy
    dEy_z = _fdiff(Ey, 2) * ipz
    dEx_z = _fdiff(Ex, 2) * ipz
    dEz_x = _fdiff(Ez, 0) * ipx
    dEy_x = _fdiff(Ey, 0) * ipx
    dEx_y = _fdiff(Ex, 1) * ipy
    if ops.pml is not None:
        b = [_bvec(ops.pml["bh"][a], a) for a in range(3)]
        c = [_bvec(ops.pml["ch"][a], a) for a in range(3)]
        pxy, pxz, pyz, pyx, pzx, pzy = st.psi_h
        pxy.copy_(b[1] * pxy + c[1] * dEz_y)
        pxz.copy_(b[2] * pxz + c[2] * dEy_z)
        pyz.copy_(b[2] * pyz + c[2] * dEx_z)
        pyx.copy_(b[0] * pyx + c[0] * dEz_x)
        pzx.copy_(b[0] * pzx + c[0] * dEy_x)
        pzy.copy_(b[1] * pzy + c[1] * dEx_y)
        Hx.sub_(ops.dtmu * ((dEz_y + pxy) - (dEy_z + pxz)))
        Hy.sub_(ops.dtmu * ((dEx_z + pyz) - (dEz_x + pyx)))
        Hz.sub_(ops.dtmu * ((dEy_x + pzx) - (dEx_y + pzy)))
    else:
        Hx.sub_(ops.dtmu * (dEz_y - dEy_z))
        Hy.sub_(ops.dtmu * (dEx_z - dEz_x))
        Hz.sub_(ops.dtmu * (dEy_x - dEx_y))


def e_update_plain(ops: YeeOperands, st: YeeState, s: float) -> None:
    E = st.e[st.parity]
    En = st.e[1 - st.parity]
    Hx, Hy, Hz = st.h
    idx, idy, idz = (_bvec(ops.inv_d[a], a) for a in range(3))
    dHz_y = _bdiff(Hz, 1) * idy
    dHy_z = _bdiff(Hy, 2) * idz
    dHx_z = _bdiff(Hx, 2) * idz
    dHz_x = _bdiff(Hz, 0) * idx
    dHy_x = _bdiff(Hy, 0) * idx
    dHx_y = _bdiff(Hx, 1) * idy
    if ops.pml is not None:
        b = [_bvec(ops.pml["be"][a], a) for a in range(3)]
        c = [_bvec(ops.pml["ce"][a], a) for a in range(3)]
        pxy, pxz, pyz, pyx, pzx, pzy = st.psi_e
        pxy.copy_(b[1] * pxy + c[1] * dHz_y)
        pxz.copy_(b[2] * pxz + c[2] * dHy_z)
        pyz.copy_(b[2] * pyz + c[2] * dHx_z)
        pyx.copy_(b[0] * pyx + c[0] * dHz_x)
        pzx.copy_(b[0] * pzx + c[0] * dHy_x)
        pzy.copy_(b[1] * pzy + c[1] * dHx_y)
        curl = ((dHz_y + pxy) - (dHy_z + pxz),
                (dHx_z + pyz) - (dHz_x + pyx),
                (dHy_x + pzx) - (dHx_y + pzy))
    else:
        curl = (dHz_y - dHy_z, dHx_z - dHz_x, dHy_x - dHx_y)
    for m in range(3):
        torch.add(ops.ca[m] * E[m], ops.cb[m] * curl[m], out=En[m])
        if ops.src[m] is not None:
            En[m].add_(ops.src[m] * s)


def mur_faces_plain(ops: YeeOperands, st: YeeState, axis: int) -> None:
    Eo = st.e[st.parity]
    En = st.e[1 - st.parity]
    q = ops.grid_shape[axis]
    for side, (wall, nb) in enumerate(((0, 1), (q - 1, q - 2))):
        c = ops.mur[axis][side]
        for comp in range(3):
            if comp == axis:
                continue
            new = Eo[comp].select(axis, nb) + c * (
                En[comp].select(axis, nb) - Eo[comp].select(axis, wall))
            En[comp].select(axis, wall).copy_(new)


def probe_gather_plain(ops: YeeOperands, st: YeeState, out: torch.Tensor) -> None:
    flat = torch.cat([f.reshape(-1) for f in st.fields])
    out.copy_((flat[ops.probe_idx.long()] * ops.probe_w).sum(-1))


# ---------------------------------------------------------------------------
# CUDA launches
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p


class _YeeArgs(ctypes.Structure):
    """Field-for-field mirror of ``struct YeeArgs`` in csrc/fdtd_chunk.cu."""

    _fields_ = [
        ("e", _P * 6), ("h", _P * 3), ("psi_e", _P * 6), ("psi_h", _P * 6),
        ("ca", _P * 3), ("cb", _P * 3), ("src", _P * 3),
        ("inv_p", _P * 3), ("inv_d", _P * 3),
        ("bh", _P * 3), ("ch", _P * 3), ("be", _P * 3), ("ce", _P * 3),
        ("probe_idx", _P), ("probe_w", _P),
        ("nx", ctypes.c_int), ("ny", ctypes.c_int), ("nz", ctypes.c_int),
        ("qx", ctypes.c_int), ("qy", ctypes.c_int), ("qz", ctypes.c_int),
        ("has_pml", ctypes.c_int),
        ("probe_rows", ctypes.c_int), ("probe_k", ctypes.c_int),
        ("dtmu", ctypes.c_float), ("mur_c", ctypes.c_float * 6),
    ]


_lib = None


def _library():
    """Build (first use) and bind the kernel library."""
    global _lib
    if _lib is None:
        from . import _build

        lib = _build.load("fdtd_chunk")
        lib.fdtd_args_size.argtypes = []
        lib.fdtd_args_size.restype = ctypes.c_int
        lib.fdtd_error_string.argtypes = [ctypes.c_int]
        lib.fdtd_error_string.restype = ctypes.c_char_p
        lib.fdtd_h_update.argtypes = [_P, ctypes.c_int, _P]
        lib.fdtd_e_update.argtypes = [_P, ctypes.c_int, ctypes.c_float, _P]
        lib.fdtd_mur_faces.argtypes = [_P, ctypes.c_int, ctypes.c_int, _P]
        lib.fdtd_probe_gather.argtypes = [_P, ctypes.c_int, _P, _P]
        for fn in (lib.fdtd_h_update, lib.fdtd_e_update,
                   lib.fdtd_mur_faces, lib.fdtd_probe_gather):
            fn.restype = ctypes.c_int
        if lib.fdtd_args_size() != ctypes.sizeof(_YeeArgs):
            raise RuntimeError(
                f"YeeArgs layout mismatch: C {lib.fdtd_args_size()} bytes, "
                f"ctypes {ctypes.sizeof(_YeeArgs)}")
        _lib = lib
    return _lib


def _check(lib, code: int, what: str) -> None:
    if code != 0:
        msg = lib.fdtd_error_string(code).decode()
        raise RuntimeError(f"CUDA kernel {what} failed: {msg} ({code})")


def _ptr(t: Optional[torch.Tensor], shape, dtype=torch.float32, dev=None) -> int:
    """Device pointer of a contiguous tensor of the expected shape/dtype."""
    if t is None:
        return 0
    if t.device != dev or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(
            f"kernel operand must be a contiguous {dtype} tensor on {dev}, "
            f"got {t.dtype} on {t.device} (contiguous={t.is_contiguous()})")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"kernel operand shape {tuple(t.shape)} != {shape}")
    return t.data_ptr()


def _cuda_args(ops: YeeOperands, st: YeeState) -> int:
    """Address of the packed kernel arguments of (ops, st), built once per
    pair and kept on the state (the struct must outlive every launch)."""
    cached = st._cargs
    if cached is not None and cached[0] is ops:
        return cached[2]
    dev = ops.device
    shp = tuple(ops.shape)
    if ops.mur is not None and min(ops.grid_shape) < 3:
        raise ValueError(f"MUR needs >= 3 planes per axis, grid {ops.grid_shape}")
    a = _YeeArgs()
    for p in range(2):
        for m in range(3):
            a.e[3 * p + m] = _ptr(st.e[p][m], shp, dev=dev)
    for m in range(3):
        a.h[m] = _ptr(st.h[m], shp, dev=dev)
        a.ca[m] = _ptr(ops.ca[m], shp, dev=dev)
        a.cb[m] = _ptr(ops.cb[m], shp, dev=dev)
        a.src[m] = _ptr(ops.src[m], shp, dev=dev)
        a.inv_p[m] = _ptr(ops.inv_p[m], (shp[m],), dev=dev)
        a.inv_d[m] = _ptr(ops.inv_d[m], (shp[m],), dev=dev)
    if ops.pml is not None:
        for m in range(3):
            for key in ("bh", "ch", "be", "ce"):
                getattr(a, key)[m] = _ptr(ops.pml[key][m], (shp[m],), dev=dev)
        for m in range(6):
            a.psi_e[m] = _ptr(st.psi_e[m], shp, dev=dev)
            a.psi_h[m] = _ptr(st.psi_h[m], shp, dev=dev)
    rows, k = ops.probe_idx.shape
    a.probe_idx = _ptr(ops.probe_idx, (rows, k), torch.int32, dev)
    a.probe_w = _ptr(ops.probe_w, (rows, k), dev=dev)
    a.nx, a.ny, a.nz = shp
    a.qx, a.qy, a.qz = ops.grid_shape
    a.has_pml = int(ops.pml is not None)
    a.probe_rows, a.probe_k = rows, k
    a.dtmu = ops.dtmu
    for b in range(3):
        for side in range(2):
            a.mur_c[2 * b + side] = ops.mur[b][side] if ops.mur else 0.0
    st._cargs = (ops, a, ctypes.addressof(a))
    return st._cargs[2]


def _on_cuda(t: torch.Tensor) -> bool:
    """True for CUDA tensors, False for CPU tensors; other devices raise."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain path for device {t.device}")


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def h_update(ops: YeeOperands, st: YeeState) -> None:
    """H half-step in place (and ψ_h under CPML)."""
    if not _on_cuda(st.h[0]):
        return h_update_plain(ops, st)
    lib = _library()
    args = _cuda_args(ops, st)
    _check(lib, lib.fdtd_h_update(args, st.parity, _stream(ops.device)),
           "h_update")
    launches["h_update"] += 1


def e_update(ops: YeeOperands, st: YeeState, s: float) -> None:
    """E half-step from ``e[parity]`` into ``e[1 - parity]`` with the
    source sample ``s`` (and ψ_e under CPML)."""
    if not _on_cuda(st.h[0]):
        return e_update_plain(ops, st, s)
    lib = _library()
    args = _cuda_args(ops, st)
    _check(lib, lib.fdtd_e_update(args, st.parity, float(s),
                                  _stream(ops.device)), "e_update")
    launches["e_update"] += 1


def mur_faces(ops: YeeOperands, st: YeeState, axis: int) -> None:
    """First-order MUR on both walls of ``axis``, into ``e[1 - parity]``."""
    if ops.mur is None:
        raise ValueError("mur_faces on a simulation without MUR walls")
    if not _on_cuda(st.h[0]):
        return mur_faces_plain(ops, st, axis)
    lib = _library()
    args = _cuda_args(ops, st)
    _check(lib, lib.fdtd_mur_faces(args, st.parity, int(axis),
                                   _stream(ops.device)), "mur_faces")
    launches["mur_faces"] += 1


def probe_gather(ops: YeeOperands, st: YeeState, out: torch.Tensor) -> None:
    """Every probe row of the current fields into ``out`` (one row of the
    staging buffer, length ``probe_idx.shape[0]``)."""
    if not _on_cuda(st.h[0]):
        return probe_gather_plain(ops, st, out)
    lib = _library()
    args = _cuda_args(ops, st)
    ptr = _ptr(out, (ops.probe_idx.shape[0],), dev=ops.device)
    _check(lib, lib.fdtd_probe_gather(args, st.parity, ptr,
                                      _stream(ops.device)), "probe_gather")
    launches["probe_gather"] += 1


# the same four entry points, always on the plain path (for comparing the
# kernels against their twins on the card)
plain = SimpleNamespace(
    h_update=h_update_plain,
    e_update=e_update_plain,
    mur_faces=mur_faces_plain,
    probe_gather=probe_gather_plain,
)
kernels = SimpleNamespace(
    h_update=h_update,
    e_update=e_update,
    mur_faces=mur_faces,
    probe_gather=probe_gather,
)


def leapfrog_step(impl, ops: YeeOperands, st: YeeState, s: float) -> None:
    """One leapfrog iteration: H, then E with the source sample ``s``, then
    the MUR walls in the order x, y, z; the new E becomes current."""
    impl.h_update(ops, st)
    impl.e_update(ops, st, s)
    if ops.mur is not None:
        for axis in range(3):
            impl.mur_faces(ops, st, axis)
    st.parity ^= 1
