"""Voxelizer: declarative scene → material arrays on the staggered Yee grid.

A frozen copy of the port's NumPy voxelizer (its ``native=False`` path),
so the reference rasterizes each scene itself. Produces:

- ``eps_r`` / ``sigma`` on primary cells (paint-by-priority, cell centers),
- boolean PEC masks on Ex/Ey/Ez edge locations (edge-midpoint containment,
  with degenerate box axes inflated so zero-thickness sheets — the patch and
  ground metallization — capture the edges lying in their plane),
- per-edge added conductivity of finite-conductivity sheets.

Everything here runs once on the host at prepare time; the output feeds
the reference's coefficient assembly (``build.py``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .mesh import YeeGrid
from .scene import (
    Box,
    ConductiveSheet,
    ConvexPolyhedron,
    Material,
    PEC,
    Scene,
)

# Inflation (mm) applied to degenerate box axes so edges lying exactly in a
# zero-thickness sheet's plane test as contained despite float rounding.
_SHEET_TOL_MM = 1e-6


@dataclass
class VoxelizedScene:
    """Raster output; edge arrays have the grid shape (Px, Py, Pz), the
    cell-centered material arrays (Px-1, Py-1, Pz-1).

    ``sheet_sigma_*`` are per-edge *added* conductivities (S/m) from
    finite-conductivity metallization (:class:`ConductiveSheet`); ``None``
    when the scene has no lossy metal."""

    eps_r: np.ndarray
    sigma: np.ndarray
    pec_ex: np.ndarray
    pec_ey: np.ndarray
    pec_ez: np.ndarray
    sheet_sigma_ex: np.ndarray | None = None
    sheet_sigma_ey: np.ndarray | None = None
    sheet_sigma_ez: np.ndarray | None = None


def _inflated_bounds(box: Box):
    lo, hi = box.lo.copy(), box.hi.copy()
    for ax in range(3):
        if hi[ax] - lo[ax] < _SHEET_TOL_MM:
            lo[ax] -= _SHEET_TOL_MM
            hi[ax] += _SHEET_TOL_MM
        else:
            lo[ax] -= 1e-9
            hi[ax] += 1e-9
    return lo, hi


def _inflated_contains(box: Box, pts: np.ndarray) -> np.ndarray:
    """Containment with degenerate axes inflated by a sheet tolerance."""
    local = box.to_local(pts)
    lo, hi = _inflated_bounds(box)
    return np.all((local >= lo) & (local <= hi), axis=-1)


def _grid_fingerprint(grid: YeeGrid):
    """Content key of the point caches: changing a grid's lines in place
    (or swapping them) must invalidate the cached points."""
    return tuple(
        (len(v), float(v[0]), float(v[-1]), float(np.sum(v)))
        for v in (grid.x, grid.y, grid.z)
    )


def _grid_cache(grid: YeeGrid) -> dict:
    """Per-grid memo dict, invalidated when the line content changes."""
    key = _grid_fingerprint(grid)
    entry = getattr(grid, "_vox_cache", None)
    if entry is None or entry[0] != key:
        entry = (key, {})
        object.__setattr__(grid, "_vox_cache", entry)
    return entry[1]


def _edge_midpoints(grid: YeeGrid, component: str) -> np.ndarray:
    """World-frame midpoints (mm) of all E-edge slots, (Px, Py, Pz, 3),
    cached per grid content (a sweep voxelizes many variants onto one
    grid)."""
    cache = _grid_cache(grid)
    if component not in cache:
        cache[component] = _axes_to_points(*_edge_axes(grid, component))
    return cache[component]


def _edge_axes(grid: YeeGrid, component: str):
    """Per-axis coordinate vectors (mm) of the E-edge slot midpoints.

    Invalid trailing slots (e.g. Ex at i = Px−1) sit at the last valid
    coordinate; the coefficient assembly zeroes them anyway."""
    x, y, z = grid.x, grid.y, grid.z

    def centers_padded(lines: np.ndarray) -> np.ndarray:
        c = 0.5 * (lines[:-1] + lines[1:])
        return np.concatenate([c, c[-1:]])  # pad trailing slot

    if component == "ex":
        return centers_padded(x), y, z
    if component == "ey":
        return x, centers_padded(y), z
    if component == "ez":
        return x, y, centers_padded(z)
    raise ValueError(component)


def _axes_to_points(xs, ys, zs) -> np.ndarray:
    """(len(xs), len(ys), len(zs), 3) coordinate array via broadcast fill."""
    pts = np.empty((len(xs), len(ys), len(zs), 3), np.float64)
    pts[..., 0] = np.asarray(xs, float)[:, None, None]
    pts[..., 1] = np.asarray(ys, float)[None, :, None]
    pts[..., 2] = np.asarray(zs, float)[None, None, :]
    return pts


def _poly_window(poly, xs, ys, zs, pad: float = 1e-9):
    """Index-slice window of the primitive's world AABB on the given
    per-axis coordinate vectors, or None when it misses the grid."""
    if isinstance(poly, ConvexPolyhedron) and np.all(
        np.asarray(poly.bounds_hi, float) == np.asarray(poly.bounds_lo, float)
    ):
        # bounds never set (the dataclass default): a degenerate AABB
        # would drop the whole solid, so test the full grid instead
        return (slice(0, len(xs)), slice(0, len(ys)), slice(0, len(zs)))
    c = poly.world_corners()
    lo, hi = c.min(axis=0) - pad, c.max(axis=0) + pad
    sls = []
    for a, v in enumerate((xs, ys, zs)):
        i0 = int(np.searchsorted(v, lo[a], side="left"))
        i1 = int(np.searchsorted(v, hi[a], side="right"))
        if i1 <= i0:
            return None
        sls.append(slice(i0, i1))
    return tuple(sls)


def _poly_contains_windowed(poly, xs, ys, zs, out_or: np.ndarray) -> None:
    """OR the polyhedron's containment mask into ``out_or`` touching only
    the AABB window."""
    sl = _poly_window(poly, xs, ys, zs)
    if sl is None:
        return
    sub = _axes_to_points(xs[sl[0]], ys[sl[1]], zs[sl[2]])
    out_or[sl] |= poly.contains(sub)


def voxelize(scene: Scene, grid: YeeGrid,
             background_eps: float = 1.0) -> VoxelizedScene:
    """Rasterize the scene. Boxes are painted in ascending priority order
    (stable), so the highest priority (and latest insertion among equals)
    wins — matching CSXCAD overlap resolution."""
    Px, Py, Pz = grid.shape
    cache = _grid_cache(grid)
    cell_pts = cache.get("cells")
    if cell_pts is None:
        cell_pts = _axes_to_points(
            grid.centers("x"), grid.centers("y"), grid.centers("z")
        )
        cache["cells"] = cell_pts

    eps = np.full((Px - 1, Py - 1, Pz - 1), background_eps, dtype=np.float64)
    sigma = np.zeros_like(eps)

    ordered = sorted(
        enumerate(scene.boxes), key=lambda t: (t[1].priority, t[0])
    )
    mat_boxes = [b for _, b in ordered if isinstance(b.prop, Material)]
    pec_boxes = [b for _, b in ordered if isinstance(b.prop, PEC)]
    sheet_boxes = [b for _, b in ordered if isinstance(b.prop, ConductiveSheet)]
    for b in sheet_boxes:
        if isinstance(b, ConvexPolyhedron):
            raise ValueError(
                "ConductiveSheet on a ConvexPolyhedron is not supported "
                "(the subcell thin-sheet model needs the box's degenerate "
                "axis); use a Box — axis-aligned or rotated"
            )

    ccx, ccy, ccz = (grid.centers(n) for n in "xyz")
    for box in mat_boxes:
        sl = _poly_window(box, ccx, ccy, ccz, pad=_SHEET_TOL_MM)
        if sl is None:
            continue
        sub = cell_pts[sl]
        if isinstance(box, ConvexPolyhedron):
            mask = box.contains(sub)
        else:
            mask = _inflated_contains(box, sub)
        eps[sl][mask] = box.prop.epsilon
        sigma[sl][mask] = box.prop.kappa

    pec = {}
    pec_plain = [b for b in pec_boxes if not isinstance(b, ConvexPolyhedron)]
    pec_polys = [b for b in pec_boxes if isinstance(b, ConvexPolyhedron)]
    # CSXCAD resolves overlaps per point by priority across ALL property
    # types: a higher-priority material (e.g. an air box carving an
    # aperture) removes lower-priority metal. That only matters when some
    # material outranks some PEC — the common case (metal on top) keeps
    # the fast boolean path below.
    carve = bool(pec_boxes) and bool(mat_boxes) and (
        max(b.priority for b in mat_boxes)
        > min(b.priority for b in pec_boxes)
    )
    for comp in ("ex", "ey", "ez"):
        axes = _edge_axes(grid, comp)
        pts = _edge_midpoints(grid, comp)
        if carve:
            # per-edge priority resolution: paint in ascending priority
            # (assignment == max), PEC wins ties (insertion convention)
            NEG = np.iinfo(np.int32).min
            pec_prio = np.full(pts.shape[:-1], NEG, np.int32)
            mat_prio = np.full(pts.shape[:-1], NEG, np.int32)
            for box in pec_boxes:
                if isinstance(box, ConvexPolyhedron):
                    sl = _poly_window(box, *axes)
                    if sl is None:
                        continue
                    sub = _axes_to_points(
                        axes[0][sl[0]], axes[1][sl[1]], axes[2][sl[2]])
                    mm = box.contains(sub)
                    pec_prio[sl][mm] = np.maximum(
                        pec_prio[sl][mm], box.priority)
                else:
                    mm = _inflated_contains(box, pts)
                    pec_prio[mm] = np.maximum(pec_prio[mm], box.priority)
            for box in mat_boxes:
                sl = _poly_window(box, *axes, pad=_SHEET_TOL_MM)
                if sl is None:
                    continue
                sub = _axes_to_points(
                    axes[0][sl[0]], axes[1][sl[1]], axes[2][sl[2]])
                if isinstance(box, ConvexPolyhedron):
                    mm = box.contains(sub)
                else:
                    mm = _inflated_contains(box, sub)
                mat_prio[sl][mm] = np.maximum(
                    mat_prio[sl][mm], box.priority)
            pec[comp] = (pec_prio > NEG) & (pec_prio >= mat_prio)
            continue
        m = np.zeros(pts.shape[:-1], dtype=bool)
        for box in pec_plain:
            # only the box's window can hold its edges (the copy's one
            # change: the port's NumPy twin tests every edge)
            sl = _poly_window(box, *axes, pad=2 * _SHEET_TOL_MM)
            if sl is not None:
                m[sl] |= _inflated_contains(box, pts[sl])
        for poly in pec_polys:
            _poly_contains_windowed(poly, *axes, out_or=m)
        pec[comp] = m

    # --- finite-conductivity sheets → per-edge added conductivity --------
    # An in-plane E edge inside a sheet gets σ_s/Δn, the sheet conductance
    # spread over the dual cell's extent normal to the sheet (standard
    # subcell thin-sheet averaging). The normal is the box's degenerate
    # local axis (dominant rotated axis for transformed instances).
    sheets = {"ex": None, "ey": None, "ez": None}
    if sheet_boxes:
        dual = {a: grid.dual_deltas_m("xyz"[a]) for a in range(3)}
        comp_axis = {"ex": 0, "ey": 1, "ez": 2}
        for comp in ("ex", "ey", "ez"):
            add = np.zeros((Px, Py, Pz), np.float64)
            claimed = np.zeros((Px, Py, Pz), bool)
            axes = _edge_axes(grid, comp)
            # highest priority first: an edge inside several overlapping
            # sheets belongs to exactly ONE (CSXCAD semantics)
            for box in sorted(
                sheet_boxes, key=lambda b: b.priority, reverse=True
            ):
                ext = box.hi - box.lo
                n_axis = int(np.argmin(ext))
                if box.rotation is not None:
                    n_local = np.zeros(3)
                    n_local[n_axis] = 1.0
                    n_world = np.asarray(box.rotation, float) @ n_local
                    n_axis = int(np.argmax(np.abs(n_world)))
                if comp_axis[comp] == n_axis:
                    continue  # normal component carries no sheet current
                sl = _poly_window(box, *axes, pad=_SHEET_TOL_MM)
                if sl is None:
                    continue
                sub = _axes_to_points(
                    axes[0][sl[0]], axes[1][sl[1]], axes[2][sl[2]])
                m = _inflated_contains(box, sub) & ~claimed[sl]
                if not m.any():
                    continue
                # Δn at each edge: dual spacing along the normal axis,
                # indexed by the edge's position on that axis
                dn = dual[n_axis]
                ni = np.arange(sl[n_axis].start, sl[n_axis].stop)
                ni = np.minimum(ni, len(dn) - 1)
                shape = [1, 1, 1]
                shape[n_axis] = -1
                dn_w = np.broadcast_to(
                    dn[ni].reshape(shape), m.shape)
                add[sl][m] += box.prop.sigma_s / dn_w[m]
                claimed[sl][m] = True
            sheets[comp] = add if add.any() else None

    # Materials stay float64 end to end: the Ca/Cb assembly rounds to
    # float32 only at the very end (ops/fdtd.py).
    return VoxelizedScene(
        eps_r=eps,
        sigma=sigma,
        pec_ex=pec["ex"],
        pec_ey=pec["ey"],
        pec_ez=pec["ez"],
        sheet_sigma_ex=sheets["ex"],
        sheet_sigma_ey=sheets["ey"],
        sheet_sigma_ez=sheets["ez"],
    )


def cell_to_edge_average(cell: np.ndarray, component: str) -> np.ndarray:
    """Average a cell-centered quantity onto E-edge locations.

    An Ex edge at (x_{i+1/2}, y_j, z_k) is shared by the up-to-4 cells
    (i, j−1..j, k−1..k); the standard material average for the staggered
    grid. Output has the grid shape (Px, Py, Pz) with trailing invalid
    slots filled by replication (masked out later). The dtype follows the
    input.
    """
    dtype = np.float32 if cell.dtype == np.float32 else np.float64
    cell = np.ascontiguousarray(cell, dtype)

    def avg_along(a: np.ndarray, axis: int) -> np.ndarray:
        # node values = mean of adjacent cells; ends replicate.
        pad = [(0, 0)] * 3
        pad[axis] = (1, 1)
        ap = np.pad(a, pad, mode="edge")
        sl_lo = [slice(None)] * 3
        sl_hi = [slice(None)] * 3
        sl_lo[axis] = slice(0, a.shape[axis] + 1)
        sl_hi[axis] = slice(1, a.shape[axis] + 2)
        return 0.5 * (ap[tuple(sl_lo)] + ap[tuple(sl_hi)])

    def pad_trailing(a: np.ndarray, axis: int) -> np.ndarray:
        pad = [(0, 0)] * 3
        pad[axis] = (0, 1)
        return np.pad(a, pad, mode="edge")

    if component == "ex":
        out = avg_along(avg_along(cell, 1), 2)  # (nx, ny+1, nz+1)
        return pad_trailing(out, 0)
    if component == "ey":
        out = avg_along(avg_along(cell, 0), 2)
        return pad_trailing(out, 1)
    if component == "ez":
        out = avg_along(avg_along(cell, 0), 1)
        return pad_trailing(out, 2)
    raise ValueError(component)
