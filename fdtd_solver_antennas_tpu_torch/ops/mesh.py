"""Graded rectilinear Yee-mesh builder.

A copy of ``fdtd_solver_antennas_tpu/ops/mesh.py`` (NumPy only). The
replacement for the CSXCAD mesh API the reference drives through
``GetGrid``/``AddLine``/``SmoothMeshLines(ratio=1.4)``/``AddEdges2Grid``
(reference: ``solver_fdtd_openems_fixed.py:177-217``,
``solver_fdtd_openems_microstrip.py:224-335``). Output is a set of per-axis
mesh-line arrays; the FDTD layer turns them into broadcastable
inverse-spacing coefficient vectors, so the non-uniform mesh costs nothing
extra inside the update kernel.

Semantics reproduced:
- fixed lines are always kept (box bounds, ports, substrate discretization);
- ``metal_edge_res`` applies the openEMS "1/3 inside, 2/3 outside" rule at
  metal edges;
- smoothing fills every gap so adjacent spacings stay below ``max_res``
  with a neighbor-to-neighbor grading ratio ≤ 1.4.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

_AXES = ("x", "y", "z")


def _dedupe(lines: np.ndarray, tol: float) -> np.ndarray:
    """Sort and merge lines closer than ``tol`` (keep the first of a run)."""
    lines = np.sort(np.asarray(lines, dtype=float))
    if lines.size == 0:
        return lines
    keep = [lines[0]]
    for v in lines[1:]:
        if v - keep[-1] > tol:
            keep.append(v)
    return np.array(keep)


def _grade_gap(
    gap: float,
    d_left: Optional[float],
    d_right: Optional[float],
    max_res: float,
    ratio: float,
) -> List[float]:
    """Spacings filling ``gap`` with geometric grading from both ends.

    Each spacing ≤ ``max_res``; the first/last grow from the neighboring
    spacing by at most ``ratio`` per cell; the whole profile is scaled to
    fit the gap exactly (scaling down only, which preserves the ratio
    bound). Mirrors what ``SmoothMeshLines('all', res, 1.4)`` produces.
    """
    if gap <= max_res * 1.0001 and (d_left is None or gap <= d_left * ratio) and (
        d_right is None or gap <= d_right * ratio
    ):
        return [gap]
    dl = max_res if d_left is None else min(d_left, max_res)
    dr = max_res if d_right is None else min(d_right, max_res)
    n = max(1, int(np.ceil(gap / max_res)))
    for _ in range(10_000):
        # Capacity profile: ramp up from both ends, capped at max_res.
        prof = np.minimum(
            np.minimum(
                dl * ratio ** np.arange(1, n + 1),
                dr * ratio ** np.arange(n, 0, -1),
            ),
            max_res,
        )
        total = prof.sum()
        if total >= gap:
            return list(prof * (gap / total))
        n += 1
    raise RuntimeError("mesh grading failed to converge")


def smooth_mesh_lines(
    lines: Sequence[float],
    max_res: float,
    ratio: float = 1.4,
    tol_frac: float = 1e-6,
) -> np.ndarray:
    """Fill gaps between fixed lines (``SmoothMeshLines`` analog)."""
    lines = np.asarray(sorted(set(float(v) for v in lines)))
    if lines.size < 2:
        return lines
    span = lines[-1] - lines[0]
    lines = _dedupe(lines, tol=max(span * tol_frac, 1e-12))
    gaps = np.diff(lines)

    out = [lines[0]]
    # Two-pass: first compute all per-gap spacings with neighbor context.
    spacings: List[List[float]] = []
    for gi, g in enumerate(gaps):
        d_left = min(spacings[gi - 1][-1], gaps[gi - 1]) if gi > 0 else None
        d_right = gaps[gi + 1] if gi + 1 < len(gaps) else None
        if d_right is not None:
            d_right = min(d_right, max_res)
        spacings.append(_grade_gap(float(g), d_left, d_right, max_res, ratio))
    for start, segs in zip(lines[:-1], spacings):
        acc = start
        for s in segs[:-1]:
            acc += s
            out.append(acc)
        out.append(start + sum(segs))
    return _dedupe(np.array(out), tol=max(span * tol_frac, 1e-12))


@dataclass
class YeeGrid:
    """Per-axis mesh lines (mm) plus derived spacings.

    ``lines[a]`` has P_a entries → P_a − 1 primary cells. Primary spacings
    ``d`` live on cells; dual spacings ``dd`` live on nodes (average of the
    two adjacent primary spacings; half-cells at the ends).
    """

    x: np.ndarray
    y: np.ndarray
    z: np.ndarray
    unit: float = 1e-3  # mm → m, matching mesh.SetDeltaUnit(1e-3)

    @property
    def lines(self) -> Dict[str, np.ndarray]:
        return {"x": self.x, "y": self.y, "z": self.z}

    @property
    def shape(self) -> Tuple[int, int, int]:
        return (len(self.x), len(self.y), len(self.z))

    @property
    def num_cells(self) -> int:
        return (len(self.x) - 1) * (len(self.y) - 1) * (len(self.z) - 1)

    def deltas_m(self, axis: str) -> np.ndarray:
        """Primary spacings in meters, length P_a − 1."""
        return np.diff(self.lines[axis]) * self.unit

    def dual_deltas_m(self, axis: str) -> np.ndarray:
        """Dual (node-centered) spacings in meters, length P_a."""
        d = self.deltas_m(axis)
        dd = np.empty(len(d) + 1)
        dd[0] = d[0] / 2
        dd[-1] = d[-1] / 2
        dd[1:-1] = 0.5 * (d[:-1] + d[1:])
        return dd

    def centers(self, axis: str) -> np.ndarray:
        """Primary cell centers (mm), length P_a − 1."""
        ln = self.lines[axis]
        return 0.5 * (ln[:-1] + ln[1:])

    def min_delta_m(self) -> float:
        return min(self.deltas_m(a).min() for a in _AXES)

    def courant_dt(self, safety: float = 0.999) -> float:
        """CFL timestep bound for the non-uniform mesh (vacuum speed)."""
        from ..physics import C0

        inv2 = sum(1.0 / self.deltas_m(a).min() ** 2 for a in _AXES)
        return safety / (C0 * np.sqrt(inv2))


@dataclass
class MeshBuilder:
    """Accumulates fixed lines per axis, then smooths into a ``YeeGrid``."""

    unit: float = 1e-3
    fixed: Dict[str, List[float]] = field(
        default_factory=lambda: {a: [] for a in _AXES}
    )

    def add_line(self, axis: str, values: Iterable[float] | float) -> None:
        vals = np.atleast_1d(np.asarray(values, dtype=float))
        self.fixed[axis].extend(float(v) for v in vals)

    def add_metal_edges(
        self,
        lo: Sequence[float],
        hi: Sequence[float],
        dirs: str = "xy",
        metal_edge_res: Optional[float] = None,
    ) -> None:
        """openEMS ``AddEdges2Grid`` analog for an axis-aligned metal box.

        With ``metal_edge_res`` set, applies the 1/3-inside / 2/3-outside
        rule: at the lower edge c lines at c − 2r/3 and c + r/3; at the
        upper edge c lines at c − r/3 and c + 2r/3. Without it, snaps lines
        to the edges (what the reference does for the ground plane,
        fixed.py:210).
        """
        for ai, axis in enumerate(_AXES):
            if axis not in dirs:
                continue
            # normalize: unordered bounds would flip the 1/3-inside /
            # 2/3-outside rule to the wrong sides of each edge
            a, b = sorted((float(lo[ai]), float(hi[ai])))
            if metal_edge_res is None or abs(b - a) < 1e-12:
                self.add_line(axis, [a] if abs(b - a) < 1e-12 else [a, b])
                continue
            r = float(metal_edge_res)
            self.add_line(axis, [a - 2 * r / 3, a + r / 3, b - r / 3, b + 2 * r / 3])

    def build(self, max_res: float, ratio: float = 1.4) -> YeeGrid:
        smoothed = {
            a: smooth_mesh_lines(self.fixed[a], max_res, ratio) for a in _AXES
        }
        return YeeGrid(
            x=smoothed["x"], y=smoothed["y"], z=smoothed["z"], unit=self.unit
        )
