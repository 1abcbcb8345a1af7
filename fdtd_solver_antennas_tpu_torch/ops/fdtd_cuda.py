"""The chunk stepper's kernels: CUDA launches and their plain PyTorch twins.

Counterpart of ``fdtd_solver_antennas_tpu/ops/fdtd_pallas.py``. The TPU
kernel ``build_pallas_chunk_stepper`` (K1) runs a whole termination chunk
(n_sub probe intervals × D leapfrog steps) in one call and extracts the
probe samples in the kernel. So does the port:

- :func:`chunk_steps`: one chunk in one cooperative launch of
  ``csrc/fdtd_chunk.cu``'s ``chunk_steps_kernel`` (an H pass and an E
  pass a step, with ca/cb, the port-source FMA ``src·wf[n0 + j·D + s]``
  and the MUR walls fused in, or the twelve ψ recursions under CPML; 2
  grid barriers a step; the probe gather after each interval), in the
  storage form :func:`chunk_launch_plan` picks from the shape
  (``ops/persist.py``). The engine's chunk loop (``ops/fdtd.py``) calls
  it once per chunk.
- :func:`chunk_steps_batch`: the same chunk for B design variants of one
  grid in one cooperative launch (the TPU kernel under ``jax.vmap``,
  which the JAX package's geometry sweeps run): a :class:`YeeBatch` of
  (B, X, Y, Z) fields, ca/cb of that shape (:func:`batch_operands`),
  everything else shared, a mask of the variants that step; in the
  resident or streamed form of ``chunk_batch_kernel``, or, where the
  batch spills the L2 under MUR or PEC (:func:`marches`), the marched form
  of ``csrc/fdtd_chunk_march.cu`` (``ops/chunk_march.py``). The engine's
  batched loop (``ops/fdtd.py::run_batched``) calls it once per chunk in
  chunk mode.
- :func:`probe_gather_batch`: the probe rows of every active variant of a
  :class:`YeeBatch` in one launch, the batched stream stepper's gather
  (``ops/fdtd_stream.py::stream_steps_batch``), once per probe interval.

The first design's per-step kernels stay, each one launch:

- :func:`h_update`: H half-step, with the six ψ_h recursions under CPML;
- :func:`e_update`: E half-step into the other E buffer, with ca/cb, the
  six ψ_e recursions and the port-source FMA ``src·s(t)``;
- :func:`mur_faces`: the first-order MUR walls of one axis, at the planes
  :meth:`YeeOperands.mur_walls` gives (a whole grid's, or where the global
  walls fall in a rank's slab or block);
- :func:`e_update_mur`: :func:`e_update` and the three :func:`mur_faces`
  in one launch, the walls of all three axes fused into the E update, bit
  for bit what the four launches write (the explicit path's walk runs it
  on a rank's block wherever no MUR wall straddles the rank, and
  ``e_update`` and ``mur_faces`` where one does);
- :func:`probe_gather`: port V/I and Huygens-face samples, a weighted
  gather over the :class:`ProbeTable` (one thread a row, the table read
  term-major), written to one row of the staging buffer (the stream and
  the explicit paths sample with it between their launches).

:data:`step_kernels` is the engine's entry points with a ``chunk_steps``
that runs a chunk through those, step by step (five launches a step under
MUR): the first design's route, kept to time beside :func:`chunk_steps`.

Each wrapper runs the kernel for CUDA tensors and the plain PyTorch twin
beside it (``*_plain``) for CPU tensors; any other device raises. A
failed plan, build or launch raises; nothing falls back. Every launch
runs on its tensors' device, through :func:`launch`, and every plan or
occupancy query under :func:`device_guard`, whatever the calling
thread's current device is. ``launches``
counts the kernel launches of each wrapper, so a run can show it went
through the kernels, and ``launches_by_form`` the ``chunk_steps`` and
``chunk_steps_batch`` launches by storage form.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
from types import SimpleNamespace
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from . import persist

PSI_KEYS = ("xy", "xz", "yz", "yx", "zx", "zy")
KERNELS = ("h_update", "e_update", "e_update_mur", "mur_faces", "probe_gather",
           "chunk_steps", "chunk_steps_batch", "probe_gather_batch")

# kernel launches per wrapper; only the wrappers' CUDA branches add to it
launches: Dict[str, int] = dict.fromkeys(KERNELS, 0)
# the chunk_steps and chunk_steps_batch launches by storage form
# (``persist.FORMS``)
launches_by_form: Dict[str, int] = dict.fromkeys(persist.FORMS, 0)


def reset_launch_counts() -> None:
    for k in KERNELS:
        launches[k] = 0
    for k in persist.FORMS:
        launches_by_form[k] = 0


# the probe table's blocks of rows, in the staging buffer's order
PROBE_BLOCKS = ("port_v", "port_i", "face_e", "face_h")
MAX_PROBE_CELLS = 2**28  # cell << 3 | component stays a non-negative int32


@dataclasses.dataclass
class ProbeTable:
    """Every probe row as a weighted gather over the stack
    ``[Ex Ey Ez Hx Hy Hz]``, in the four blocks of :data:`PROBE_BLOCKS`
    (port V, port I, face E, face H; rows in that order, as the staging
    buffer and ``ProbeDFT`` see them), each of its own width.

    Block b has ``rows[b]`` rows of ``k[b]`` terms, stored term-major:
    term m of row r at ``offsets[b] + m·rows[b] + r`` of ``code`` and
    ``w``, so the m-th terms of neighbouring rows lie side by side. A code
    is ``cell << 3 | component``: the cell's flat index into one
    (Px, Py, Pz) array and the array's place in the stack. Rows shorter
    than their block pad with weight 0: port V's rows differ in length,
    and so do port I's where an MSL port's third I row has no terms (all
    its k terms pad). ``meta`` holds the blocks' layout for the kernels, on the
    same device: ``row_starts``, ``k`` and ``offsets`` as int32.
    """

    code: torch.Tensor  # (entries,) int32
    w: torch.Tensor  # (entries,) float32
    rows: Tuple[int, ...]
    k: Tuple[int, ...]
    meta: torch.Tensor = dataclasses.field(init=False)  # (3·blocks + 1,) int32

    def __post_init__(self):
        self.meta = torch.tensor(self.row_starts + tuple(self.k) + self.offsets,
                                 dtype=torch.int32, device=self.code.device)

    @classmethod
    def from_blocks(cls, blocks, n_cells: int, device="cpu") -> "ProbeTable":
        """The table of ``blocks``, one ``(idx, w)`` pair of (rows, k)
        arrays per block of :data:`PROBE_BLOCKS`, ``idx`` a flat index
        into the stack (component·n_cells + cell)."""
        if len(blocks) != len(PROBE_BLOCKS):
            raise ValueError(f"{len(blocks)} probe blocks, not "
                             f"{len(PROBE_BLOCKS)}")
        if n_cells >= MAX_PROBE_CELLS:
            raise ValueError(f"{n_cells} cells: too many for the probe "
                             f"table's codes (< {MAX_PROBE_CELLS})")
        codes, ws, rows, ks = [], [], [], []
        for idx, w in blocks:
            idx = np.asarray(idx, np.int64)
            w = np.asarray(w, np.float32)
            if idx.ndim != 2 or idx.shape != w.shape:
                raise ValueError(f"probe block {idx.shape} with weights "
                                 f"{w.shape}: want two equal (rows, k)")
            if idx.size and (idx.min() < 0 or idx.max() >= 6 * n_cells):
                raise ValueError("probe index outside the six-field stack")
            comp, cell = np.divmod(idx, n_cells)
            codes.append(((cell << 3) | comp).T.ravel())
            ws.append(w.T.ravel())
            rows.append(idx.shape[0])
            ks.append(idx.shape[1])
        code = np.concatenate(codes).astype(np.int32)
        if code.size >= 2**31:
            raise ValueError(f"{code.size} probe table entries: too many")
        return cls(code=torch.from_numpy(code).to(device),
                   w=torch.from_numpy(np.concatenate(ws)).to(device),
                   rows=tuple(rows), k=tuple(ks))

    @classmethod
    def empty(cls, device="cpu") -> "ProbeTable":
        """No probe rows."""
        none = np.zeros((0, 0), np.int64)
        return cls.from_blocks([(none, none)] * len(PROBE_BLOCKS), 1, device)

    @property
    def n_rows(self) -> int:
        return sum(self.rows)

    @property
    def row_starts(self) -> Tuple[int, ...]:
        """Block b's rows are ``[row_starts[b], row_starts[b + 1])``."""
        return tuple(int(x) for x in np.cumsum((0,) + self.rows))

    @property
    def offsets(self) -> Tuple[int, ...]:
        """Block b's first entry in ``code`` and ``w``."""
        return tuple(int(x) for x in np.cumsum(
            (0,) + tuple(r * k for r, k in zip(self.rows, self.k)))[:-1])

    @property
    def nbytes(self) -> int:
        """Bytes of the entries: codes and weights."""
        return (self.code.numel() * self.code.element_size()
                + self.w.numel() * self.w.element_size())

    def blocks(self):
        """``(first row, rows, k, code, w)`` per block, ``code`` and
        ``w`` as (k, rows) views."""
        for r0, off, rows, k in zip(self.row_starts, self.offsets, self.rows,
                                    self.k):
            yield (r0, rows, k, self.code[off:off + k * rows].view(k, rows),
                   self.w[off:off + k * rows].view(k, rows))

    @staticmethod
    def flat_index(code: torch.Tensor, n_cells: int) -> torch.Tensor:
        """``code`` as int64 flat indices into the stack."""
        return (code & 7).long() * n_cells + (code >> 3).long()


@dataclasses.dataclass
class YeeOperands:
    """What a leapfrog step reads and never writes, on one device.

    1-D tensors are per-axis profiles (length of that axis); 3-D tensors
    have ``shape``. ``grid_shape`` places the MUR wall planes of a whole
    grid (:meth:`mur_walls`). ``probes`` is the probe table over the stack
    ``[Ex Ey Ez Hx Hy Hz]``.
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
    probes: ProbeTable
    # A rank's x-slab (``ops/fdtd_shard.py``): the slab rows of the MUR x
    # walls, global rows 0 and Qx−1, which may lie outside the slab. None
    # for a whole grid, whose x walls sit at rows 0 and grid_shape[0]−1.
    mur_x_rows: Optional[Tuple[int, int]] = None
    # A rank's x-y block (the explicit path's walk split along y too): the
    # block's planes of the MUR y walls, as ``mur_x_rows``. None when y is
    # whole.
    mur_y_rows: Optional[Tuple[int, int]] = None

    @property
    def device(self) -> torch.device:
        return self.ca[0].device

    def mur_walls(self, axis: int) -> Tuple[int, int]:
        """The planes of the two MUR walls of ``axis`` in this array's own
        indices: ``mur_x_rows`` / ``mur_y_rows`` on a slab or block (a wall
        outside ``[0, shape[axis])`` is on another rank), else 0 and
        ``grid_shape[axis] − 1``."""
        rows = (self.mur_x_rows, self.mur_y_rows, None)[axis]
        return rows if rows is not None else (0, self.grid_shape[axis] - 1)


@dataclasses.dataclass
class YeeState:
    """The fields a step advances. ``e[parity]`` is the current E;
    ``e_update`` writes ``e[1 - parity]`` and :func:`leapfrog_step` flips
    ``parity``. ψ tuples follow :data:`PSI_KEYS` and are empty without
    CPML. These kernels update the tensors in place and pack their
    pointers once per (operands, state) pair. The stream stepper
    (``ops/fdtd_stream.py``) writes a second set of tensors, points the
    state at it and drops the packed pointers."""

    e: list  # [(Ex, Ey, Ez), (Ex, Ey, Ez)]
    h: Tuple[torch.Tensor, ...]
    psi_e: Tuple[torch.Tensor, ...] = ()
    psi_h: Tuple[torch.Tensor, ...] = ()
    parity: int = 0
    _cargs: object = None
    _stream: object = None  # the stream stepper's second field set
    _shard: object = None  # the shard stepper's packed arguments
    _steps: object = None  # the interval stepper's packed arguments
    _chunk: object = None  # chunk_steps' packed arguments

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


@dataclasses.dataclass
class YeeBatch:
    """The fields of B design variants of one grid, each tensor
    (B, X, Y, Z) with variant b at index b (layout as :class:`YeeState`).
    ``parity[b]`` is the E buffer that holds variant b's current E: a
    frozen variant keeps the buffer it froze in while the others step
    on. The batched stream stepper (``ops/fdtd_stream.py``) also writes
    H and ψ to a second set, ``h1``, ``psi_e1`` and ``psi_h1`` (empty
    until its first launch makes them); ``hset[b]`` is the set (0 or 1)
    that holds variant b's H and ψ. :meth:`variant` gives a
    :class:`YeeState` of views of one variant's current tensors."""

    e: list  # [(Ex, Ey, Ez), (Ex, Ey, Ez)], each (B, X, Y, Z)
    h: Tuple[torch.Tensor, ...]
    psi_e: Tuple[torch.Tensor, ...] = ()
    psi_h: Tuple[torch.Tensor, ...] = ()
    parity: list = dataclasses.field(default_factory=list)
    h1: Tuple[torch.Tensor, ...] = ()
    psi_e1: Tuple[torch.Tensor, ...] = ()
    psi_h1: Tuple[torch.Tensor, ...] = ()
    hset: list = dataclasses.field(default_factory=list)
    _chunk: object = None  # chunk_steps_batch's packed arguments
    _mask: object = None  # (host mask, its int32 copy on the device)
    _stream: object = None  # stream_steps_batch's packed arguments
    _march: object = None  # the marched form's packed arguments

    def __post_init__(self):
        if not self.hset:
            self.hset = [0] * self.batch

    @property
    def batch(self) -> int:
        return self.h[0].shape[0]

    def h_set(self, q: int) -> Tuple[Tuple[torch.Tensor, ...], ...]:
        """``(H, ψ_e, ψ_h)`` of set ``q``."""
        return ((self.h, self.psi_e, self.psi_h) if q == 0
                else (self.h1, self.psi_e1, self.psi_h1))

    def variant(self, b: int) -> YeeState:
        """Variant ``b`` as a state of views (its updates land here)."""
        h, psi_e, psi_h = self.h_set(self.hset[b])
        return YeeState(
            e=[tuple(t[b] for t in self.e[0]), tuple(t[b] for t in self.e[1])],
            h=tuple(t[b] for t in h),
            psi_e=tuple(t[b] for t in psi_e),
            psi_h=tuple(t[b] for t in psi_h),
            parity=self.parity[b],
        )

    def fields(self) -> Tuple[torch.Tensor, ...]:
        """Every variant's current (Ex, Ey, Ez, Hx, Hy, Hz), each
        (B, X, Y, Z), E from the variant's own buffer and H from its own
        set (new tensors)."""
        def pick(flags, a, b):
            on = torch.tensor(flags, dtype=torch.bool,
                              device=self.h[0].device).view(-1, 1, 1, 1)
            return tuple(torch.where(on, y, x) for x, y in zip(a, b))

        h = pick(self.hset, self.h, self.h1) if self.h1 else self.h
        return (*pick(self.parity, self.e[0], self.e[1]), *h)


def new_batch_state(shape, device, pml: bool, batch: int) -> YeeBatch:
    """Zero fields (and ψ under CPML) for ``batch`` variants of ``shape``."""
    if batch < 1:
        raise ValueError(f"batch={batch}: want at least one variant")
    st = new_state((batch, *shape), device, pml)
    return YeeBatch(e=st.e, h=st.h, psi_e=st.psi_e, psi_h=st.psi_h,
                    parity=[0] * batch)


def batch_operands(ops: YeeOperands, ca, cb) -> YeeOperands:
    """``ops`` with the per-variant coefficients ``ca`` and ``cb`` (three
    (B, X, Y, Z) tensors each, one per E component); everything else, the
    source stamps and the probe table included, is shared."""
    ca, cb = tuple(ca), tuple(cb)
    want = tuple(ops.shape)
    for t in (*ca, *cb):
        if t.dim() != 4 or tuple(t.shape[1:]) != want or t.shape[0] != ca[0].shape[0]:
            raise ValueError(f"batched ca/cb {tuple(t.shape)}: want (B, *{want})")
    return dataclasses.replace(ops, ca=ca, cb=cb)


def one_set(st: YeeBatch, live, what: str) -> Tuple[int, int]:
    """``(parity, hset)`` shared by the variants ``live``: a batched
    launch reads one E buffer and one H set. Raises where they differ."""
    sets = {(st.parity[b], st.hset[b]) for b in live}
    if len(sets) != 1:
        raise ValueError(f"{what}: active variants at (E buffer, H set) "
                         f"{sorted(sets)}; one launch reads one")
    return sets.pop()


def variant_operands(ops: YeeOperands, b: int) -> YeeOperands:
    """The operands of variant ``b`` of batched operands (views)."""
    return dataclasses.replace(ops, ca=tuple(t[b] for t in ops.ca),
                               cb=tuple(t[b] for t in ops.cb))


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
    """The MUR walls of ``axis`` at ``ops.mur_walls(axis)``: a wall outside
    the array is skipped, a neighbour outside it reads 0."""
    Eo = st.e[st.parity]
    En = st.e[1 - st.parity]
    dim = ops.shape[axis]
    for side, wall in enumerate(ops.mur_walls(axis)):
        if not 0 <= wall < dim:
            continue
        nb = wall - 1 if side else wall + 1
        c = ops.mur[axis][side]
        for comp in range(3):
            if comp == axis:
                continue
            if 0 <= nb < dim:
                eo_nb, en_nb = Eo[comp].select(axis, nb), En[comp].select(axis, nb)
            else:
                eo_nb = en_nb = torch.zeros_like(Eo[comp].select(axis, wall))
            new = eo_nb + c * (en_nb - Eo[comp].select(axis, wall))
            En[comp].select(axis, wall).copy_(new)


def e_update_mur_plain(ops: YeeOperands, st: YeeState, s: float) -> None:
    """:func:`e_update_plain`, then (MUR) :func:`mur_faces_plain` for x, y
    and z."""
    e_update_plain(ops, st, s)
    if ops.mur is not None:
        for axis in range(3):
            mur_faces_plain(ops, st, axis)


def probe_gather_plain(ops: YeeOperands, st: YeeState, out: torch.Tensor) -> None:
    """Block by block, each row's k terms summed m = 0 .. k−1, one
    rounding each, in the kernels' order."""
    t = ops.probes
    flat = torch.cat([f.reshape(-1) for f in st.fields])
    terms = flat[t.flat_index(t.code, flat.numel() // 6)] * t.w
    for r0, off, rows, k in zip(t.row_starts, t.offsets, t.rows, t.k):
        acc = torch.zeros(rows, dtype=out.dtype, device=out.device)
        for m in range(k):
            acc = acc + terms[off + m * rows:off + (m + 1) * rows]
        out[r0:r0 + rows].copy_(acc)


def probe_gather_batch_plain(ops: YeeOperands, st: YeeBatch, out: torch.Tensor,
                             active) -> None:
    """:func:`probe_gather_plain` of every active variant into ``out[b]``."""
    for b, on in enumerate(_active_mask(active, st.batch)):
        if on:
            probe_gather_plain(ops, st.variant(b), out[b])


def _check_window(n_wf: int, n0: int, n_sub: int, D: int) -> None:
    """A chunk reads the samples [n0, n0 + n_sub·D) of ``n_wf``."""
    if n_sub < 1 or D < 1 or n0 < 0:
        raise ValueError(f"chunk_steps: n_sub={n_sub}, D={D}, n0={n0}")
    if n0 + n_sub * D > n_wf:
        raise ValueError(f"chunk_steps: samples [{n0}, {n0 + n_sub * D}) "
                         f"past the waveform's {n_wf}")


def _chunk_samples(wf, n0: int, n_sub: int, D: int) -> list:
    """The source samples of one chunk, ``wf[n0 : n0 + n_sub·D]``."""
    _check_window(len(wf), n0, n_sub, D)
    part = wf[n0:n0 + n_sub * D]
    return part.tolist() if torch.is_tensor(part) else [float(x) for x in part]


def _steps_then_gathers(impl, ops: YeeOperands, st: YeeState, wf, n0: int,
                        n_sub: int, D: int, bufs: torch.Tensor) -> None:
    """A chunk step by step: per interval, D :func:`leapfrog_step` calls
    with ``impl``, then ``impl.probe_gather`` into ``bufs[j]``."""
    samples = _chunk_samples(wf, n0, n_sub, D)
    for j in range(n_sub):
        for s in samples[j * D:(j + 1) * D]:
            leapfrog_step(impl, ops, st, s)
        impl.probe_gather(ops, st, bufs[j])


def chunk_steps_plain(ops: YeeOperands, st: YeeState, wf, n0: int, n_sub: int,
                      D: int, bufs: torch.Tensor) -> None:
    """One chunk with the plain twins: per interval j, D leapfrog steps
    with the source sample ``wf[n0 + j·D + s]`` at step s, then the probe
    gather into ``bufs[j]``."""
    _steps_then_gathers(plain, ops, st, wf, n0, n_sub, D, bufs)


def _active_mask(active, batch: int) -> Tuple[bool, ...]:
    """``active`` (B booleans or ints, a sequence or a tensor) as a host
    tuple of booleans."""
    if torch.is_tensor(active):
        active = active.tolist()
    act = tuple(bool(a) for a in active)
    if len(act) != batch:
        raise ValueError(f"active mask of {len(act)} for {batch} variants")
    return act


def chunk_steps_batch_plain(ops: YeeOperands, st: YeeBatch, wf, n0: int,
                            n_sub: int, D: int, bufs: torch.Tensor,
                            active) -> None:
    """One chunk of every active variant with the plain twins:
    :func:`chunk_steps_plain` on the variant's views (its own parity), its
    samples into ``bufs[b]``. A frozen variant's tensors, samples and
    parity stay as they are."""
    for b, on in enumerate(_active_mask(active, st.batch)):
        if on:
            vs = st.variant(b)
            chunk_steps_plain(variant_operands(ops, b), vs, wf, n0, n_sub, D,
                              bufs[b])
            st.parity[b] = vs.parity


# ---------------------------------------------------------------------------
# CUDA launches
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p


_NB = len(PROBE_BLOCKS)


class _ProbeTable(ctypes.Structure):
    """Field-for-field mirror of ``struct ProbeTable`` in csrc/fdtd_chunk.cu."""

    _fields_ = [("code", _P), ("w", _P), ("meta", _P), ("rows", ctypes.c_int)]


class _YeeArgs(ctypes.Structure):
    """Field-for-field mirror of ``struct YeeArgs`` in csrc/fdtd_chunk.cu."""

    _fields_ = [
        ("e", _P * 6), ("h", _P * 3), ("psi_e", _P * 6), ("psi_h", _P * 6),
        ("ca", _P * 3), ("cb", _P * 3), ("src", _P * 3),
        ("inv_p", _P * 3), ("inv_d", _P * 3),
        ("bh", _P * 3), ("ch", _P * 3), ("be", _P * 3), ("ce", _P * 3),
        ("probes", _ProbeTable),
        ("nx", ctypes.c_int), ("ny", ctypes.c_int), ("nz", ctypes.c_int),
        ("has_pml", ctypes.c_int),
        ("dtmu", ctypes.c_float), ("mur_c", ctypes.c_float * 6),
        ("mur_wall", ctypes.c_int * 6),
    ]


class _GatherBatchArgs(ctypes.Structure):
    """Field-for-field mirror of ``struct GatherBatchArgs`` in csrc/fdtd_chunk.cu."""

    _fields_ = [("f", _P * 6), ("probes", _ProbeTable), ("active", _P),
                ("batch", ctypes.c_int), ("cells", ctypes.c_int),
                ("out_stride", ctypes.c_longlong), ("out", _P)]


class _ChunkArgs(ctypes.Structure):
    """Field-for-field mirror of ``struct ChunkArgs`` in csrc/fdtd_chunk.cu."""

    _fields_ = [("o", persist.PersistOps), ("probes", _ProbeTable)]


_lib = None
_PREFIX = "fdtd_chunk"


def _library():
    """Build (first use) and bind the kernel library."""
    global _lib
    if _lib is None:
        from . import _build

        _i = ctypes.c_int
        lib = _build.load("fdtd_chunk")
        persist.bind(lib, _PREFIX)
        for fn in (lib.fdtd_args_size, lib.fdtd_chunk_args_size,
                   lib.fdtd_probe_table_size, lib.fdtd_gather_batch_args_size):
            fn.argtypes = []
            fn.restype = ctypes.c_int
        lib.fdtd_chunk_steps.argtypes = [_P, _i, _P, _i, _i, _i, _P, _i, _i, _P]
        lib.fdtd_chunk_steps.restype = _i
        lib.fdtd_chunk_batch_plan.argtypes = [_P, _i, _i, ctypes.POINTER(_i)]
        lib.fdtd_chunk_batch_plan.restype = _i
        lib.fdtd_chunk_batch_steps.argtypes = [_P, _i, _P, _i, _i, _i, _P, _P,
                                               _i, _i, _i, _P]
        lib.fdtd_chunk_batch_steps.restype = _i
        lib.fdtd_h_update.argtypes = [_P, ctypes.c_int, _P]
        lib.fdtd_e_update.argtypes = [_P, ctypes.c_int, ctypes.c_float, _P]
        lib.fdtd_e_update_mur.argtypes = [_P, ctypes.c_int, ctypes.c_float, _P]
        lib.fdtd_mur_faces.argtypes = [_P, ctypes.c_int, ctypes.c_int, _P]
        lib.fdtd_probe_gather.argtypes = [_P, ctypes.c_int, _P, _P]
        lib.fdtd_probe_gather_batch.argtypes = [_P, _P]
        for fn in (lib.fdtd_h_update, lib.fdtd_e_update,
                   lib.fdtd_e_update_mur, lib.fdtd_mur_faces,
                   lib.fdtd_probe_gather,
                   lib.fdtd_probe_gather_batch):
            fn.restype = ctypes.c_int
        for name, c_size, py in (
                ("YeeArgs", lib.fdtd_args_size(), _YeeArgs),
                ("ChunkArgs", lib.fdtd_chunk_args_size(), _ChunkArgs),
                ("GatherBatchArgs", lib.fdtd_gather_batch_args_size(),
                 _GatherBatchArgs),
                ("ProbeTable", lib.fdtd_probe_table_size(), _ProbeTable)):
            if c_size != ctypes.sizeof(py):
                raise RuntimeError(f"{name} layout mismatch: C {c_size} bytes, "
                                   f"ctypes {ctypes.sizeof(py)}")
        _lib = lib
    return _lib


def _check(lib, code: int, what: str) -> None:
    persist.check(lib, _PREFIX, code, what)


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


def _probe_args(t: ProbeTable, dev) -> _ProbeTable:
    """The packed probe table: its entries, weights and block layout
    (device arrays) and its rows."""
    p = _ProbeTable()
    p.code = _ptr(t.code, (t.code.numel(),), torch.int32, dev)
    p.w = _ptr(t.w, (t.code.numel(),), dev=dev)
    p.meta = _ptr(t.meta, (3 * _NB + 1,), torch.int32, dev)
    p.rows = t.n_rows
    return p


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
    a.probes = _probe_args(ops.probes, dev)
    a.nx, a.ny, a.nz = shp
    a.has_pml = int(ops.pml is not None)
    a.dtmu = ops.dtmu
    for b in range(3):  # no wall (-1) without MUR
        for side, wall in enumerate(ops.mur_walls(b)):
            a.mur_c[2 * b + side] = ops.mur[b][side] if ops.mur else 0.0
            a.mur_wall[2 * b + side] = wall if ops.mur else -1
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
    """The raw handle of ``dev``'s current stream."""
    return torch._C._cuda_getCurrentRawStream(dev.index)


def launch(dev: torch.device, fn, *args):
    """``fn(*args, stream)``: a library call that launches on ``dev``'s
    current stream, made with ``dev`` the calling thread's current device
    (the libraries launch on the CUDA runtime's current device, and a new
    thread starts on device 0). Where ``dev`` is already current, as on
    the thread that made the tensors, that costs one query of the current
    device and no context; otherwise the call runs inside
    ``torch.cuda.device(dev)``, which gives the caller its device back."""
    if torch._C._cuda_getDevice() == dev.index:
        return fn(*args, _stream(dev))
    with torch.cuda.device(dev):
        return fn(*args, _stream(dev))


_NO_GUARD = contextlib.nullcontext()


def device_guard(dev: torch.device):
    """The context a plan or occupancy query on ``dev`` runs in (the
    libraries answer for the calling thread's current device): for a CUDA
    ``dev`` other than the thread's current device ``torch.cuda.device(dev)``,
    which makes ``dev`` current inside and gives the caller its device back
    on exit; otherwise (the same device, or the CPU) a context that does
    nothing."""
    if (dev.type != "cuda" or dev.index is None
            or torch.cuda.current_device() == dev.index):
        return _NO_GUARD
    return torch.cuda.device(dev)


def h_update(ops: YeeOperands, st: YeeState) -> None:
    """H half-step in place (and ψ_h under CPML)."""
    if not _on_cuda(st.h[0]):
        return h_update_plain(ops, st)
    lib = _library()
    args = _cuda_args(ops, st)
    _check(lib, launch(ops.device, lib.fdtd_h_update, args, st.parity),
           "h_update")
    launches["h_update"] += 1


def e_update(ops: YeeOperands, st: YeeState, s: float) -> None:
    """E half-step from ``e[parity]`` into ``e[1 - parity]`` with the
    source sample ``s`` (and ψ_e under CPML)."""
    if not _on_cuda(st.h[0]):
        return e_update_plain(ops, st, s)
    lib = _library()
    args = _cuda_args(ops, st)
    _check(lib, launch(ops.device, lib.fdtd_e_update, args, st.parity,
                       float(s)), "e_update")
    launches["e_update"] += 1


def e_update_mur(ops: YeeOperands, st: YeeState, s: float) -> None:
    """:func:`e_update` and then, under MUR, :func:`mur_faces` for x, y
    and z, in one launch of ``e_update_mur_kernel``: the walls at
    ``ops.mur_walls`` fused into the E update, bit for bit the four
    launches' result (without MUR the launch is ``e_update_kernel``'s; on
    a CPU tensor :func:`e_update_mur_plain`)."""
    if not _on_cuda(st.h[0]):
        return e_update_mur_plain(ops, st, s)
    lib = _library()
    args = _cuda_args(ops, st)
    _check(lib, launch(ops.device, lib.fdtd_e_update_mur, args, st.parity,
                       float(s)), "e_update_mur")
    launches["e_update_mur"] += 1


def mur_faces(ops: YeeOperands, st: YeeState, axis: int) -> None:
    """First-order MUR on both walls of ``axis`` (at
    ``ops.mur_walls(axis)``), into ``e[1 - parity]``."""
    if ops.mur is None:
        raise ValueError("mur_faces on a simulation without MUR walls")
    if not _on_cuda(st.h[0]):
        return mur_faces_plain(ops, st, axis)
    lib = _library()
    args = _cuda_args(ops, st)
    _check(lib, launch(ops.device, lib.fdtd_mur_faces, args, st.parity,
                       int(axis)), "mur_faces")
    launches["mur_faces"] += 1


def probe_gather(ops: YeeOperands, st: YeeState, out: torch.Tensor) -> None:
    """Every probe row of the current fields into ``out`` (one row of the
    staging buffer, length ``probes.n_rows``)."""
    if not _on_cuda(st.h[0]):
        return probe_gather_plain(ops, st, out)
    ptr = _ptr(out, (ops.probes.n_rows,), dev=ops.device)
    if ops.probes.n_rows == 0:
        return None  # nothing to launch
    lib = _library()
    args = _cuda_args(ops, st)
    _check(lib, launch(ops.device, lib.fdtd_probe_gather, args, st.parity,
                       ptr), "probe_gather")
    launches["probe_gather"] += 1


def probe_gather_batch(ops: YeeOperands, st: YeeBatch, out: torch.Tensor,
                       active) -> None:
    """Every probe row of every variant b with ``active[b]`` into
    ``out[b]`` (``out``: (B, probe rows), each row contiguous, as a
    staging buffer's ``bufs[:, j]``); a frozen variant's row stays as it
    is. On a CUDA tensor one launch of ``probe_gather_batch_kernel`` (every
    active variant at the same E buffer and H set, :func:`one_set`); on a
    CPU tensor :func:`probe_gather_batch_plain`."""
    B, rows = st.batch, ops.probes.n_rows
    if tuple(out.shape) != (B, rows) or (rows > 1 and out.stride(1) != 1):
        raise ValueError(f"probe_gather_batch: out {tuple(out.shape)} != "
                         f"(B, probe rows) = {(B, rows)} with contiguous rows")
    act = _active_mask(active, B)
    if not _on_cuda(st.h[0]):
        return probe_gather_batch_plain(ops, st, out, act)
    live = [b for b in range(B) if act[b]]
    if not live or rows == 0:
        return None  # nothing to launch
    p, q = one_set(st, live, "probe_gather_batch")
    dev = ops.device
    if out.device != dev or out.dtype != torch.float32:
        raise ValueError(f"probe_gather_batch: out must be float32 on {dev}")
    shp = (B, *ops.shape)
    a = _GatherBatchArgs()
    for m, t in enumerate((*st.e[p], *st.h_set(q)[0])):
        a.f[m] = _ptr(t, shp, dev=dev)
    a.probes = _probe_args(ops.probes, dev)
    a.active = _ptr(_device_mask(st, act), (B,), torch.int32, dev)
    a.batch, a.cells = B, int(np.prod(ops.shape))
    a.out_stride, a.out = out.stride(0), out.data_ptr()
    lib = _library()
    _check(lib, launch(dev, lib.fdtd_probe_gather_batch, ctypes.addressof(a)),
           "probe_gather_batch")
    launches["probe_gather_batch"] += 1


def _batch(st) -> int:
    """B for a :class:`YeeBatch`, 0 for a :class:`YeeState`."""
    return st.batch if isinstance(st, YeeBatch) else 0


def _chunk_args(ops: YeeOperands, st) -> _ChunkArgs:
    """The packed ``chunk_steps`` (or, for a :class:`YeeBatch`,
    ``chunk_steps_batch``) arguments of (ops, st), built once per pair and
    kept on the state; the kernel updates the state's tensors in place, so
    the pointers stay valid across launches."""
    cached = st._chunk
    if cached is not None and cached[0] is ops:
        return cached[1]
    a = _ChunkArgs()
    a.o = persist.pack(ops, st, (0, ops.grid_shape[0] - 1), batch=_batch(st))
    a.probes = _probe_args(ops.probes, ops.device)
    st._chunk = (ops, a)
    return a


def marches(ops: YeeOperands, batch: int) -> bool:
    """Whether ``chunk_steps_batch``'s plan takes the marched form for
    ``batch`` variants of ``ops`` by itself: under MUR or PEC, where the
    batch's working set (``ops/fdtd.py::working_set_bytes`` times B)
    exceeds the L2 (``ops/fdtd.py::L2_BYTES``). ``chip_smoke.py`` phase
    16 times both forms at the 8-variant sweep in one call and fails
    where the plan picks the slower (``PERF.md``)."""
    from . import fdtd

    n_src = sum(s is not None for s in ops.src)
    return (ops.pml is None
            and batch * fdtd.working_set_bytes(ops.shape, n_src, False)
            > fdtd.L2_BYTES)


def chunk_launch_plan(ops: YeeOperands, st, form: Optional[str] = None):
    """The storage form, blocks × threads and shared bytes ``chunk_steps``
    launches with for (ops, st): ``form`` None lets the shape pick (the
    resident form where the operands fit on chip), else "resident" or
    "streamed" (the resident form raises where it does not fit). For a
    :class:`YeeBatch` of B variants, ``chunk_steps_batch``'s plan: the
    marched form (a ``chunk_march.MarchPlan``) where :func:`marches` says
    so or ``form`` is "marched" (which raises under CPML), else the
    resident form only where each variant's equal share of the blocks the
    card holds keeps its cells on chip, else the streamed form (a
    ``persist.Plan``)."""
    batch = _batch(st)
    if form == "marched" and not batch:
        raise ValueError("chunk_steps: the marched form is chunk_steps_batch's "
                         "alone")
    if batch and (form == "marched" or (form is None and marches(ops, batch))):
        from . import chunk_march

        return chunk_march.plan(ops, batch)
    a = _chunk_args(ops, st)
    return persist.plan(_library(), _PREFIX, ops, ctypes.addressof(a), form,
                        "chunk_steps_batch" if batch else "chunk_steps",
                        batch=batch)


def chunk_steps(ops: YeeOperands, st: YeeState,
                wf: Union[torch.Tensor, Sequence[float]], n0: int, n_sub: int,
                D: int, bufs: torch.Tensor, *, form: Optional[str] = None) -> None:
    """One termination chunk: ``n_sub`` probe intervals of ``D`` leapfrog
    steps from ``e[parity]``, the source sample of step s of interval j at
    ``wf[n0 + j·D + s]``, interval j's probe samples into ``bufs[j]``
    (``bufs``: ``(n_sub, probe rows)``). On a CUDA tensor one launch of
    ``chunk_steps_kernel``, ``wf`` a float32 tensor on the device (the
    whole run's samples, read in place); on a CPU tensor
    :func:`chunk_steps_plain`. Updates the state's tensors in place and
    sets ``st.parity`` to the E buffer that holds the result. ``form``
    forces a storage form (:func:`chunk_launch_plan`); the CPU runs the
    plain twin whatever it says."""
    rows = ops.probes.n_rows
    if tuple(bufs.shape) != (n_sub, rows):
        raise ValueError(f"chunk_steps: bufs {tuple(bufs.shape)} != "
                         f"(n_sub, probe rows) = {(n_sub, rows)}")
    if not _on_cuda(st.h[0]):
        return chunk_steps_plain(ops, st, wf, n0, n_sub, D, bufs)
    _check_window(len(wf), n0, n_sub, D)
    lib = _library()
    a = _chunk_args(ops, st)
    plan = chunk_launch_plan(ops, st, form)
    wf = torch.as_tensor(wf, dtype=torch.float32, device=ops.device)
    code = launch(
        ops.device, lib.fdtd_chunk_steps, ctypes.addressof(a), st.parity,
        _ptr(wf, (len(wf),), dev=ops.device), n0, n_sub, D,
        _ptr(bufs, (n_sub, rows), dev=ops.device), plan.cells_per_thread,
        plan.blocks)
    _check(lib, code, "chunk_steps")
    launches["chunk_steps"] += 1
    launches_by_form[plan.form] += 1
    st.parity ^= (n_sub * D) & 1


def _device_mask(st: YeeBatch, act: Tuple[bool, ...]) -> torch.Tensor:
    """The mask as int32 on the state's device, copied only when it
    changed (the copy is ordered on the stream behind earlier launches)."""
    if st._mask is None or st._mask[0] != act:
        dev = st.h[0].device
        t = st._mask[1] if st._mask is not None else torch.empty(
            len(act), dtype=torch.int32, device=dev)
        t.copy_(torch.tensor(act, dtype=torch.int32))
        st._mask = (act, t)
    return st._mask[1]


def chunk_steps_batch(ops: YeeOperands, st: YeeBatch,
                      wf: Union[torch.Tensor, Sequence[float]], n0: int,
                      n_sub: int, D: int, bufs: torch.Tensor, active, *,
                      form: Optional[str] = None) -> None:
    """One termination chunk of every variant b with ``active[b]``: as
    :func:`chunk_steps`, for B = ``st.batch`` variants of one grid
    (``ops`` from :func:`batch_operands`), variant b's samples into
    ``bufs[b]`` (``bufs``: ``(B, n_sub, probe rows)``). Every variant is
    driven by the same source samples ``wf``. A frozen variant is neither
    stepped nor sampled, and keeps its parity and H set. On a CUDA tensor
    one launch in the form :func:`chunk_launch_plan` gives (``form``
    forces one): ``chunk_batch_kernel`` (resident or streamed: each
    active variant's parity flips with every step, its H stays in its
    set, which must be the first) or the marched form
    (``ops/chunk_march.py``: each active variant's E buffer and H set end
    where its last round wrote them). Every active variant must be at the
    same E buffer and H set, as they are when the variants that stop stay
    stopped. On a CPU tensor :func:`chunk_steps_batch_plain`."""
    B, rows = st.batch, ops.probes.n_rows
    if tuple(bufs.shape) != (B, n_sub, rows):
        raise ValueError(f"chunk_steps_batch: bufs {tuple(bufs.shape)} != "
                         f"(B, n_sub, probe rows) = {(B, n_sub, rows)}")
    act = _active_mask(active, B)
    if not _on_cuda(st.h[0]):
        return chunk_steps_batch_plain(ops, st, wf, n0, n_sub, D, bufs, act)
    _check_window(len(wf), n0, n_sub, D)
    live = [b for b in range(B) if act[b]]
    if not live:
        return None  # nothing to step
    p, q = one_set(st, live, "chunk_steps_batch")
    plan = chunk_launch_plan(ops, st, form)
    mask = _device_mask(st, act)
    dev = ops.device
    wf = torch.as_tensor(wf, dtype=torch.float32, device=dev)
    if plan.form == "marched":
        from . import chunk_march

        chunk_march.chunk_steps(ops, st, wf, n0, n_sub, D, bufs, act, plan,
                                mask)
        launches["chunk_steps_batch"] += 1
        launches_by_form[plan.form] += 1
        return None
    if q:
        raise ValueError("chunk_steps_batch: the active variants' H lies in "
                         "the second set, which only the marched form and "
                         "the stream stepper step from")
    lib = _library()
    a = _chunk_args(ops, st)
    code = launch(
        dev, lib.fdtd_chunk_batch_steps, ctypes.addressof(a), p,
        _ptr(wf, (len(wf),), dev=dev), n0, n_sub, D,
        _ptr(bufs, (B, n_sub, rows), dev=dev),
        _ptr(mask, (B,), torch.int32, dev), B, plan.cells_per_thread,
        plan.blocks)
    _check(lib, code, "chunk_steps_batch")
    launches["chunk_steps_batch"] += 1
    launches_by_form[plan.form] += 1
    for b in live:
        st.parity[b] ^= (n_sub * D) & 1


def chunk_by_steps(ops: YeeOperands, st: YeeState, wf, n0: int, n_sub: int,
                   D: int, bufs: torch.Tensor) -> None:
    """:func:`chunk_steps` through the per-step kernels: per interval, D
    launches each of ``h_update``, ``e_update`` and (MUR) three of
    ``mur_faces``, then one ``probe_gather`` (the plain twins on the
    CPU). The first design's route, for timing beside the chunk kernel."""
    _steps_then_gathers(kernels, ops, st, wf, n0, n_sub, D, bufs)


# The engine's entry points: always on the plain path (for comparing the
# kernels against their twins on the card), through the kernels (CUDA
# tensors; the plain twins on the CPU), and through the kernels with a
# chunk run step by step.
plain = SimpleNamespace(
    h_update=h_update_plain,
    e_update=e_update_plain,
    e_update_mur=e_update_mur_plain,
    mur_faces=mur_faces_plain,
    probe_gather=probe_gather_plain,
    chunk_steps=chunk_steps_plain,
    chunk_steps_batch=chunk_steps_batch_plain,
    probe_gather_batch=probe_gather_batch_plain,
)
kernels = SimpleNamespace(
    h_update=h_update,
    e_update=e_update,
    e_update_mur=e_update_mur,
    mur_faces=mur_faces,
    probe_gather=probe_gather,
    chunk_steps=chunk_steps,
    chunk_steps_batch=chunk_steps_batch,
    probe_gather_batch=probe_gather_batch,
)
step_kernels = SimpleNamespace(**{**vars(kernels), "chunk_steps": chunk_by_steps})


def leapfrog_step(impl, ops: YeeOperands, st: YeeState, s: float) -> None:
    """One leapfrog iteration: H, then E with the source sample ``s``, then
    the MUR walls in the order x, y, z; the new E becomes current."""
    impl.h_update(ops, st)
    impl.e_update(ops, st, s)
    if ops.mur is not None:
        for axis in range(3):
            impl.mur_faces(ops, st, axis)
    st.parity ^= 1
