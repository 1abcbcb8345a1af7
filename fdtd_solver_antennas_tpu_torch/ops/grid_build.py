"""The Yee grid's build on the device: the material raster and Ca/Cb.

Replaces no TPU kernel: the JAX package rasterizes the scene on the host
(``ops/voxelize.py`` on the native core) and assembles the float64 update
coefficients there, then uploads them; the port keeps that build as its
reference (``ops/fdtd.py::host_coeffs``). ``ops/fdtd.py::
build_simulation`` builds the same float32 ``ca_*``/``cb_*`` here
instead, on the simulation's device, bit for bit:

- :func:`pack_scene` packs the scene into one flat :class:`GridTable`, in
  the order the host voxelizer resolves it: the material primitives in
  ascending (priority, insertion) order with ε and κ, the PEC primitives
  with their priority, the conductive sheets in descending priority with
  σ_s and their normal axis; each a record of its inflated local bounds
  (``_pack_box``'s) or its plane rows, its rigid transform and its index
  window on every point set the host tests it on (cells, Ex, Ey and Ez
  edges: ``_poly_window``'s, or the whole grid where the host tests every
  point); the lumped ports' added conductivities as (component, index
  box, σ) folds in the host's order; the grid's line, cell-centre and
  dual-spacing vectors.
- :func:`paint_cells`: one launch of ``csrc/grid_build.cu``'s
  ``paint_cells_kernel``, the cell-centred ε_r and σ (float64).
- :func:`edge_coeffs`: one launch of ``edge_coeffs_kernel`` over the
  three components, Ca and Cb (float32, the padded shape, zero in the pad
  cells).

Each wrapper launches the kernel for a table on a CUDA device and runs
the plain PyTorch twin beside it (``*_plain``) for one on the CPU, so a
CPU build runs the twins; they walk the table as the kernels do, in the
same float64 operations in the same order, so their outputs are the
kernels' bit for bit, and test a primitive only where it can hold a
point (a box's per-axis bounds, a rotated box's world bounds). A failed
build or launch raises; nothing falls back. ``launches`` counts the
kernel launches.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from ..models.scene import ConductiveSheet, ConvexPolyhedron, Material, PEC
from ..physics import EPS0
from .fdtd_cuda import _on_cuda, launch
from .voxelize import (_SHEET_TOL_MM, _edge_axes, _pack_box, _poly_window,
                       sheet_normal_axis)

KERNELS = ("paint_cells", "edge_coeffs")

# kernel launches per wrapper; only the wrappers' CUDA branches add to it
launches: Dict[str, int] = dict.fromkeys(KERNELS, 0)

# the table's records (csrc/grid_build.cu reads them; keep in step)
REC_D = 24  # doubles a primitive: lo hi rot org trn (_pack_box's), val0 val1
REC_I = 32  # ints a primitive: kind has_rot plane_row n_planes prio n_axis
WIN = 8  # the int of the first window: 4 point sets × (lo, hi) × 3 axes
FOLD_I = 8  # ints a port fold: component, (lo, hi) × 3
POLY_TOL = 1e-9  # ConvexPolyhedron.contains's tolerance, as the host calls it
COMPONENTS = ("ex", "ey", "ez")
NEG = -(2 ** 31)  # the host's int32 "no primitive" priority
BACKGROUND_EPS = 1.0  # ε_r where no material lies (voxelize's default)


def reset_launch_counts() -> None:
    for k in KERNELS:
        launches[k] = 0


@dataclasses.dataclass
class GridTable:
    """The packed scene (see the module's docstring): ``f64`` the records'
    doubles, the plane rows, the folds' σ and the axis vectors; ``i32``
    the records' ints and the folds. ``q`` the grid's lines a axis;
    ``*_off`` where each part starts in its array."""

    f64: torch.Tensor
    i32: torch.Tensor
    q: Tuple[int, int, int]
    n_mat: int
    n_pec: int
    n_sheet: int
    n_fold: int
    planes_off: int
    fold_off: int
    fold_ioff: int
    lines_off: Tuple[int, int, int]
    cpad_off: Tuple[int, int, int]
    dual_off: Tuple[int, int, int]
    carve: bool

    def to(self, device) -> "GridTable":
        return dataclasses.replace(self, f64=self.f64.to(device),
                                   i32=self.i32.to(device))

    def rec(self, m: int) -> torch.Tensor:
        return self.f64[m * REC_D:(m + 1) * REC_D]

    def irec(self, m: int) -> list:
        return self.i32[m * REC_I:(m + 1) * REC_I].tolist()

    def window(self, m: int, point_set: int):
        """Primitive ``m``'s index window on point set 0 (cells) or 1 + c
        (component c's edges) as three slices, None where it is empty."""
        w = self.irec(m)[WIN + 6 * point_set:WIN + 6 * point_set + 6]
        if w[1] <= w[0] or w[3] <= w[2] or w[5] <= w[4]:
            return None
        return slice(w[0], w[1]), slice(w[2], w[3]), slice(w[4], w[5])

    def vec(self, kind: str, axis: int) -> torch.Tensor:
        """An axis vector: ``lines``, ``cpad`` (the cell centres, the last
        repeated) or ``dual`` (the dual spacings, m), ``q[axis]`` long."""
        off = getattr(self, kind + "_off")[axis]
        return self.f64[off:off + self.q[axis]]


def _window(prim, axes, pad: float) -> list:
    sl = _poly_window(prim, *axes, pad=pad)
    if sl is None:
        return [0] * 6
    return [v for s in sl for v in (s.start, s.stop)]


def _full(lengths) -> list:
    return [v for n in lengths for v in (0, n)]


def pack_scene(scene, grid, ports: Sequence = ()) -> GridTable:
    """The scene and the port folds as a :class:`GridTable` on the CPU.

    ``ports``: the lumped ports' ``ops.fdtd.PortRuntime`` in the order the
    host adds their ``sigma_p`` on their edges ``sl`` (an int or a slice
    an axis) of component ``axis``. The windows follow the host's branches:
    the material cells are tested everywhere where the native core paints
    them (no polyhedron among the materials), else in ``_poly_window``
    padded by the sheet tolerance; PEC boxes on every edge, PEC polyhedra
    in their window; material edges (the carve rule) and sheets in the
    window padded by the sheet tolerance."""
    ordered = sorted(enumerate(scene.boxes), key=lambda t: (t[1].priority, t[0]))
    mats = [b for _, b in ordered if isinstance(b.prop, Material)]
    pecs = [b for _, b in ordered if isinstance(b.prop, PEC)]
    sheets = [b for _, b in ordered if isinstance(b.prop, ConductiveSheet)]
    for b in sheets:
        if isinstance(b, ConvexPolyhedron):
            raise ValueError(
                "ConductiveSheet on a ConvexPolyhedron is not supported "
                "(the subcell thin-sheet model needs the box's degenerate "
                "axis); use a Box — axis-aligned or rotated")
    sheets = sorted(sheets, key=lambda b: b.priority, reverse=True)
    carve = bool(pecs) and bool(mats) and (
        max(b.priority for b in mats) > min(b.priority for b in pecs))
    has_mat_poly = any(isinstance(b, ConvexPolyhedron) for b in mats)

    q = tuple(int(n) for n in grid.shape)
    cell_axes = tuple(grid.centers(n) for n in "xyz")
    edge_axes = [_edge_axes(grid, c) for c in COMPONENTS]
    cells_all = _full(n - 1 for n in q)
    edges_all = _full(q)
    no_cells = [0] * 6

    recs_d, recs_i, planes = [], [], []
    for role, prims in (("mat", mats), ("pec", pecs), ("sheet", sheets)):
        for b in prims:
            poly = isinstance(b, ConvexPolyhedron)
            d = np.zeros(REC_D, np.float64)
            i = np.zeros(REC_I, np.int32)
            if poly:
                n = np.asarray(b.planes, float)
                rows = np.concatenate([n[:, :3], (n[:, 3] + POLY_TOL)[:, None]],
                                      axis=1)
                i[0], i[2], i[3] = 1, len(planes), len(rows)
                planes.extend(rows)
                if b.rotation is not None:
                    d[6:15] = np.asarray(b.rotation, float).ravel()
                d[15:18] = b.rotation_origin
                d[18:21] = b.translation
            else:
                d[:21] = _pack_box(b)[:21]
            i[1] = int(b.rotation is not None)
            i[4] = b.priority
            if role == "mat":
                d[21], d[22] = b.prop.epsilon, b.prop.kappa
                cells = (_window(b, cell_axes, _SHEET_TOL_MM) if has_mat_poly
                         else cells_all)
                edges = [_window(b, ax, _SHEET_TOL_MM) for ax in edge_axes]
            elif role == "pec":
                cells = no_cells
                edges = [_window(b, ax, POLY_TOL) if poly else edges_all
                         for ax in edge_axes]
            else:
                d[21] = b.prop.sigma_s
                i[5] = sheet_normal_axis(b)
                cells = no_cells
                edges = [_window(b, ax, _SHEET_TOL_MM) for ax in edge_axes]
            i[WIN:] = cells + [v for e in edges for v in e]
            recs_d.append(d)
            recs_i.append(i)

    fold_d, fold_i = [], []
    for prt in ports:
        rec = [int(prt.axis)]
        for a, s in enumerate(prt.sl):
            if isinstance(s, slice):
                lo, hi, _ = s.indices(q[a])
            else:
                lo, hi = int(s), int(s) + 1
            rec += [lo, hi]
        fold_i.append(rec + [0] * (FOLD_I - len(rec)))
        fold_d.append(float(prt.sigma_p))

    n_prim = len(recs_d)
    parts = [np.asarray(recs_d, np.float64).reshape(-1),
             np.asarray(planes, np.float64).reshape(-1),
             np.asarray(fold_d, np.float64)]
    planes_off = n_prim * REC_D
    fold_off = planes_off + 4 * len(planes)
    off = fold_off + len(fold_d)
    vec_off = {}
    for kind, vecs in (
            ("lines", [grid.x, grid.y, grid.z]),
            ("cpad", [edge_axes[a][a] for a in range(3)]),
            ("dual", [grid.dual_deltas_m(n) for n in "xyz"])):
        vec_off[kind] = []
        for v in vecs:
            v = np.asarray(v, np.float64)
            vec_off[kind].append(off)
            parts.append(v)
            off += len(v)
    f64 = np.concatenate(parts)
    i32 = np.concatenate([np.asarray(recs_i, np.int32).reshape(-1),
                          np.asarray(fold_i, np.int32).reshape(-1)])
    return GridTable(
        f64=torch.from_numpy(f64), i32=torch.from_numpy(i32), q=q,
        n_mat=len(mats), n_pec=len(pecs), n_sheet=len(sheets),
        n_fold=len(fold_d), planes_off=planes_off, fold_off=fold_off,
        fold_ioff=n_prim * REC_I, lines_off=tuple(vec_off["lines"]),
        cpad_off=tuple(vec_off["cpad"]), dual_off=tuple(vec_off["dual"]),
        carve=carve)


# ---------------------------------------------------------------------------
# plain PyTorch twins
# ---------------------------------------------------------------------------

def _world_window(r: torch.Tensor, axes, w):
    """Window ``w`` narrowed to the world bounds of the rotated box record
    ``r``: its inflated local corners taken back to the world, padded by
    the sheet tolerance, far above the rounding of either transform; so
    every point the box holds lies inside (None where none can)."""
    rec = r.cpu().numpy()
    corners = np.array([[x, y, z] for x in (rec[0], rec[3])
                        for y in (rec[1], rec[4]) for z in (rec[2], rec[5])])
    o = rec[15:18]
    world = (corners - o) @ rec[6:15].reshape(3, 3).T + o + rec[18:21]
    lo = world.min(axis=0) - _SHEET_TOL_MM
    hi = world.max(axis=0) + _SHEET_TOL_MM
    out = []
    for a in range(3):
        v = axes[a]
        i0 = int(torch.searchsorted(v, v.new_tensor(lo[a])))
        i1 = int(torch.searchsorted(v, v.new_tensor(hi[a]), right=True))
        i0, i1 = max(i0, w[a].start), min(i1, w[a].stop)
        if i1 <= i0:
            return None
        out.append(slice(i0, i1))
    return tuple(out)


def _holds(t: GridTable, m: int, axes, w):
    """Where primitive ``m`` holds the points of the axis vectors ``axes``
    (a point set's three, full length) inside its index window ``w``: a
    window and the mask over it, or None where it holds none. The
    kernel's ``contains``, operation for operation, where it can hold a
    point: an unrotated box is tested a axis, and its window narrowed to
    where all three tests pass, a rotated box's to its world bounds
    (outside them the mask is false)."""
    r = t.rec(m)
    kind, has_rot, row, n_planes = t.irec(m)[:4]
    if kind == 0 and has_rot:
        w = _world_window(r, axes, w)
        if w is None:
            return None
    p = [axes[a][w[a]] - r[18 + a] for a in range(3)]
    if kind == 0 and not has_rot:
        ok = [(p[a] >= r[a]) & (p[a] <= r[3 + a]) for a in range(3)]
        at = [o.nonzero().view(-1) for o in ok]
        if any(len(i) == 0 for i in at):
            return None
        lo = [int(i[0]) for i in at]
        hi = [int(i[-1]) + 1 for i in at]
        w = tuple(slice(w[a].start + lo[a], w[a].start + hi[a])
                  for a in range(3))
        ok = [o[l:h] for o, l, h in zip(ok, lo, hi)]
        return w, (ok[0].view(-1, 1, 1) & ok[1].view(1, -1, 1)
                   & ok[2].view(1, 1, -1))
    p0, p1, p2 = p[0].view(-1, 1, 1), p[1].view(1, -1, 1), p[2].view(1, 1, -1)
    if has_rot:
        q0, q1, q2 = p0 - r[15], p1 - r[16], p2 - r[17]
        p0 = q0 * r[6] + q1 * r[9] + q2 * r[12] + r[15]
        p1 = q0 * r[7] + q1 * r[10] + q2 * r[13] + r[16]
        p2 = q0 * r[8] + q1 * r[11] + q2 * r[14] + r[17]
    if kind == 0:
        inside = ((p0 >= r[0]) & (p0 <= r[3]) & (p1 >= r[1]) & (p1 <= r[4])
                  & (p2 >= r[2]) & (p2 <= r[5]))
    else:
        pl = t.f64[t.planes_off + 4 * row:t.planes_off + 4 * (row + n_planes)]
        inside = None
        for n in range(n_planes):
            ok = (p0 * pl[4 * n] + p1 * pl[4 * n + 1]
                  + p2 * pl[4 * n + 2]) <= pl[4 * n + 3]
            inside = ok if inside is None else inside & ok
    return w, inside.expand(*(s.stop - s.start for s in w))


def paint_cells_plain(t: GridTable) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cell-centred ε_r and σ (float64, (qx−1, qy−1, qz−1)): the last
    material primitive in the table's order that holds a cell's centre."""
    shape = tuple(n - 1 for n in t.q)
    axes = [t.vec("cpad", a)[:shape[a]] for a in range(3)]
    eps = torch.full(shape, BACKGROUND_EPS, dtype=torch.float64,
                     device=t.f64.device)
    sigma = torch.zeros_like(eps)
    for m in range(t.n_mat):
        w = t.window(m, 0)
        held = None if w is None else _holds(t, m, axes, w)
        if held is None:
            continue
        w, inside = held
        r = t.rec(m)
        eps[w].masked_fill_(inside, r[21])
        sigma[w].masked_fill_(inside, r[22])
    return eps, sigma


def _max_prio(t: GridTable, prims, c: int, axes) -> torch.Tensor:
    """The highest priority among ``prims`` holding each c-edge (NEG
    where none does). The table lists them in ascending priority, so the
    last that holds an edge has the highest."""
    prio = torch.full(t.q, NEG, dtype=torch.int32, device=t.f64.device)
    for m in prims:
        w = t.window(m, 1 + c)
        held = None if w is None else _holds(t, m, axes, w)
        if held is not None:
            prio[held[0]].masked_fill_(held[1], t.irec(m)[4])
    return prio


def edge_raster_plain(t: GridTable, c: int):
    """Component ``c``'s PEC mask and its sheets' added σ (None where no
    sheet adds any), over the grid's (qx, qy, qz) edges: ``voxelize``'s
    ``pec_*`` and ``sheet_sigma_*``."""
    axes = [t.vec("cpad" if a == c else "lines", a) for a in range(3)]
    pec_prio = _max_prio(t, range(t.n_mat, t.n_mat + t.n_pec), c, axes)
    pec = pec_prio > NEG
    if t.carve:
        pec &= pec_prio >= _max_prio(t, range(t.n_mat), c, axes)
    add = torch.zeros(t.q, dtype=torch.float64, device=t.f64.device)
    claimed = torch.zeros(t.q, dtype=torch.bool, device=t.f64.device)
    s0 = t.n_mat + t.n_pec
    for m in range(s0, s0 + t.n_sheet):
        na = t.irec(m)[5]
        w = t.window(m, 1 + c)
        held = None if na == c or w is None else _holds(t, m, axes, w)
        if held is None:
            continue
        w, inside = held
        inside = inside & ~claimed[w]
        ni = torch.arange(w[na].start, w[na].stop, device=t.f64.device)
        dn = t.vec("dual", na)[ni.clamp_max(t.q[na] - 1)]
        add[w] = torch.where(inside, t.rec(m)[21] / dn.view(
            [-1 if a == na else 1 for a in range(3)]), add[w])
        claimed[w] |= inside
    return pec, (add if bool(add.ne(0).any()) else None)


def _node_average(cells: torch.Tensor, c: int) -> torch.Tensor:
    """``cell_to_edge_average`` of the cells onto component ``c``'s edges,
    in its rounding order: 0.5·(0.5·(A + B) + 0.5·(C + D)), the inner
    pairs along the lower transverse axis. The cells are padded by
    replication (one before and one after each transverse axis, one after
    the component's), so each of the four neighbours is a slice."""
    pad = []
    for a in (2, 1, 0):  # F.pad takes the last axis first
        pad += [0, 1] if a == c else [1, 1]
    P = torch.nn.functional.pad(cells[None, None], pad, mode="replicate")[0, 0]
    u, v = [a for a in range(3) if a != c]

    def at(su, sv):
        sl = [slice(None)] * 3
        sl[u] = slice(su, su + cells.shape[u] + 1)
        sl[v] = slice(sv, sv + cells.shape[v] + 1)
        return P[tuple(sl)]

    avg = (at(0, 0) + at(1, 0)).mul_(0.5)
    avg.add_((at(0, 1) + at(1, 1)).mul_(0.5))
    return avg.mul_(0.5)


def edge_coeffs_plain(t: GridTable, eps: torch.Tensor, sigma: torch.Tensor,
                      dt: float, mur: bool,
                      padded_shape) -> Dict[str, torch.Tensor]:
    """``ca_*``/``cb_*`` (float32, ``padded_shape``, zero in the pad
    cells) from the cells :func:`paint_cells_plain` painted: the host
    build's arithmetic (``ops/fdtd.py::host_coeffs``) in its order, in
    place where an operand is not needed again."""
    dev = t.f64.device
    dt_t = torch.tensor(dt, dtype=torch.float64, device=dev)
    folds = t.i32[t.fold_ioff:t.fold_ioff + FOLD_I * t.n_fold].view(-1, FOLD_I)
    out = {}
    for c, comp in enumerate(COMPONENTS):
        pec, add = edge_raster_plain(t, c)
        eps_a = _node_average(eps, c).mul_(EPS0)
        sig = _node_average(sigma, c)
        if add is not None:
            sig.add_(add)
        for f, fr in enumerate(folds.tolist()):
            if fr[0] == c:
                sl = tuple(slice(fr[1 + 2 * a], fr[2 + 2 * a]) for a in range(3))
                sig[sl] += t.f64[t.fold_off + f]
        beta = sig.mul_(dt).div_(eps_a * 2.0)  # σ·dt / (2ε)
        one_plus = beta + 1.0
        ca = beta.neg_().add_(1.0).div_(one_plus)  # (1 − β) / (1 + β)
        cb = torch.div(dt_t, eps_a, out=eps_a).div_(one_plus)  # (dt/ε)/(1 + β)
        trail = [slice(None)] * 3
        trail[c] = t.q[c] - 1
        ca[tuple(trail)] = 0.0
        cb[tuple(trail)] = 0.0
        for b in (a for a in range(3) if a != c):
            for idx in (0, t.q[b] - 1):
                plane = [slice(None)] * 3
                plane[b] = idx
                cb[tuple(plane)] = 0.0
                ca[tuple(plane)] = 1.0 if mur else 0.0
        ca.masked_fill_(pec, 0.0)
        cb.masked_fill_(pec, 0.0)
        for pre, arr in (("ca_", ca), ("cb_", cb)):
            arr = arr.to(torch.float32)
            if tuple(padded_shape) != t.q:
                full = torch.zeros(tuple(padded_shape), dtype=torch.float32,
                                   device=dev)
                full[:t.q[0], :t.q[1], :t.q[2]] = arr
                arr = full
            out[pre + comp] = arr
    return out


# ---------------------------------------------------------------------------
# CUDA launches
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I3 = ctypes.c_int * 3


class _GridBuildArgs(ctypes.Structure):
    """Field-for-field mirror of ``struct GridBuildArgs`` in
    csrc/grid_build.cu."""

    _fields_ = [
        ("tab", _P), ("itab", _P), ("eps", _P), ("sigma", _P),
        ("ca", _P * 3), ("cb", _P * 3), ("q", _I3), ("p", _I3),
        ("n_mat", ctypes.c_int), ("n_pec", ctypes.c_int),
        ("n_sheet", ctypes.c_int), ("n_fold", ctypes.c_int),
        ("planes_off", ctypes.c_int), ("fold_off", ctypes.c_int),
        ("fold_ioff", ctypes.c_int), ("lines_off", _I3), ("cpad_off", _I3),
        ("dual_off", _I3), ("carve", ctypes.c_int), ("mur", ctypes.c_int),
        ("background_eps", ctypes.c_double), ("dt", ctypes.c_double),
        ("eps0", ctypes.c_double),
    ]


_lib = None


def _library():
    """Build (first use) and bind the kernel library."""
    global _lib
    if _lib is None:
        from . import _build

        lib = _build.load("grid_build")
        lib.grid_build_args_size.argtypes = []
        lib.grid_build_args_size.restype = ctypes.c_int
        lib.grid_build_error_string.argtypes = [ctypes.c_int]
        lib.grid_build_error_string.restype = ctypes.c_char_p
        for fn in (lib.grid_paint_cells, lib.grid_edge_coeffs):
            fn.argtypes = [_P, _P]
            fn.restype = ctypes.c_int
        if lib.grid_build_args_size() != ctypes.sizeof(_GridBuildArgs):
            raise RuntimeError(
                f"GridBuildArgs layout mismatch: C {lib.grid_build_args_size()}"
                f" bytes, ctypes {ctypes.sizeof(_GridBuildArgs)}")
        _lib = lib
    return _lib


def _check(lib, code: int, what: str) -> None:
    if code != 0:
        msg = lib.grid_build_error_string(code).decode()
        raise RuntimeError(f"CUDA kernel {what} failed: {msg} ({code})")


def _tensor_ptr(x: torch.Tensor, dtype, numel: int, dev) -> int:
    if (x.device != dev or x.dtype != dtype or not x.is_contiguous()
            or x.numel() != numel):
        raise ValueError(
            f"kernel operand must be a contiguous {dtype} tensor of {numel} "
            f"elements on {dev}, got {x.dtype} ({x.numel()}) on {x.device}")
    return x.data_ptr()


def _args(t: GridTable, eps, sigma) -> _GridBuildArgs:
    dev = t.f64.device
    cells = int(np.prod([n - 1 for n in t.q]))
    a = _GridBuildArgs()
    a.tab = _tensor_ptr(t.f64, torch.float64, t.f64.numel(), dev)
    a.itab = _tensor_ptr(t.i32, torch.int32, t.i32.numel(), dev)
    a.eps = _tensor_ptr(eps, torch.float64, cells, dev)
    a.sigma = _tensor_ptr(sigma, torch.float64, cells, dev)
    a.q[:] = t.q
    a.n_mat, a.n_pec, a.n_sheet, a.n_fold = (t.n_mat, t.n_pec, t.n_sheet,
                                             t.n_fold)
    a.planes_off, a.fold_off, a.fold_ioff = (t.planes_off, t.fold_off,
                                             t.fold_ioff)
    a.lines_off[:], a.cpad_off[:], a.dual_off[:] = (t.lines_off, t.cpad_off,
                                                    t.dual_off)
    a.carve = int(t.carve)
    a.background_eps = BACKGROUND_EPS
    a.eps0 = EPS0
    return a


def paint_cells(t: GridTable) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cell-centred ε_r and σ of the table's scene, on the table's device
    (the kernel on a card, :func:`paint_cells_plain` on the CPU)."""
    if not _on_cuda(t.f64):
        return paint_cells_plain(t)
    lib = _library()
    dev = t.f64.device
    shape = tuple(n - 1 for n in t.q)
    eps = torch.empty(shape, dtype=torch.float64, device=dev)
    sigma = torch.empty_like(eps)
    a = _args(t, eps, sigma)
    _check(lib, launch(dev, lib.grid_paint_cells, ctypes.addressof(a)),
           "paint_cells")
    launches["paint_cells"] += 1
    return eps, sigma


def edge_coeffs(t: GridTable, eps: torch.Tensor, sigma: torch.Tensor,
                dt: float, mur: bool,
                padded_shape) -> Dict[str, torch.Tensor]:
    """``ca_*``/``cb_*`` (float32, ``padded_shape``) from the cells
    :func:`paint_cells` painted, on the table's device (the kernel on a
    card, :func:`edge_coeffs_plain` on the CPU)."""
    padded_shape = tuple(int(n) for n in padded_shape)
    if any(p < q for p, q in zip(padded_shape, t.q)):
        raise ValueError(f"padded shape {padded_shape} below the grid {t.q}")
    if not _on_cuda(t.f64):
        return edge_coeffs_plain(t, eps, sigma, dt, mur, padded_shape)
    lib = _library()
    dev = t.f64.device
    out = {pre + comp: torch.empty(padded_shape, dtype=torch.float32,
                                   device=dev)
           for pre in ("ca_", "cb_") for comp in COMPONENTS}
    a = _args(t, eps, sigma)
    for c, comp in enumerate(COMPONENTS):
        a.ca[c] = out["ca_" + comp].data_ptr()
        a.cb[c] = out["cb_" + comp].data_ptr()
    a.p[:] = padded_shape
    a.dt = float(dt)
    a.mur = int(bool(mur))
    _check(lib, launch(dev, lib.grid_edge_coeffs, ctypes.addressof(a)),
           "edge_coeffs")
    launches["edge_coeffs"] += 1
    return out
