"""Declarative scene model, the replacement for CSXCAD.

A copy of ``fdtd_solver_antennas_tpu/models/scene.py`` (NumPy only), so the
port imports nothing of the JAX package.

The reference builds geometry through the CSXCAD C++ bindings
(``ContinuousStructure`` / ``AddMetal`` / ``AddMaterial`` / ``AddBox`` /
``AddTransform``, e.g. ``solver_fdtd_openems_fixed.py:189-210`` and
``solver_fdtd_openems_microstrip_multi_3d.py:334-456``). Here a scene is a
plain, immutable list of axis-aligned boxes with optional rigid transforms,
painted onto the Yee grid by ``ops.voxelize`` (priority order preserved).

Units: the scene is in *mm* to match the reference's drawing unit
(``mesh.SetDeltaUnit(1e-3)``); the solver layer converts to SI when
building update coefficients.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np


def _rigid_to_local(pts, rotation, rotation_origin, translation):
    """World → local for the shared rigid transform (translation, then
    rotation about ``rotation_origin``); one definition keeps Box and
    ConvexPolyhedron (and the native C++ and CUDA mirrors' contract) in
    sync. The row-vector product ``(pts − o) @ R + o`` is summed element
    by element, ``((q0·R0j + q1·R1j) + q2·R2j) + oj``, the order the
    native core (``native/voxelize.cpp``) and the card's grid build
    (``csrc/grid_build.cu``) use, so all three round alike whatever BLAS
    the host has."""
    pts = np.asarray(pts, float) - np.asarray(translation, float)
    if rotation is not None:
        o = np.asarray(rotation_origin, float)
        R = np.asarray(rotation, float)
        q = pts - o
        pts = np.stack([
            q[..., 0] * R[0, j] + q[..., 1] * R[1, j] + q[..., 2] * R[2, j]
            + o[j] for j in range(3)], axis=-1)
    return pts


def _rigid_to_world(pts, rotation, rotation_origin, translation):
    """Local → world: inverse of :func:`_rigid_to_local`."""
    pts = np.asarray(pts, float)
    if rotation is not None:
        o = np.asarray(rotation_origin, float)
        pts = (pts - o) @ np.asarray(rotation, float).T + o
    return pts + np.asarray(translation, float)


@dataclass(frozen=True)
class Material:
    """Lossy dielectric: relative permittivity + conductivity (S/m)."""

    name: str
    epsilon: float = 1.0
    kappa: float = 0.0  # electric conductivity, S/m


@dataclass(frozen=True)
class PEC:
    """Perfect electric conductor (openEMS ``AddMetal`` analog)."""

    name: str


@dataclass(frozen=True)
class ConductiveSheet:
    """Finite-conductivity zero-thickness metallization.

    ``sigma_s`` is the sheet conductance σ·t_eff in S (inverse of the
    sheet resistance R_s). The voxelizer spreads it over the dual cell as
    an added edge conductivity σ_s/Δn on the sheet's *in-plane* E edges,
    so conductor (ohmic) loss enters the power balance physically —
    beyond the reference, whose openEMS scenes model all metal as PEC.
    Use :func:`fdtd_solver_antennas_tpu_torch.physics.sheet_conductance` to get
    σ·t_eff with the skin-depth cap at the design frequency.
    """

    name: str
    sigma_s: float  # sheet conductance σ·t_eff, S (per square)


@dataclass(frozen=True)
class Box:
    """Axis-aligned box primitive (before transform), in mm.

    ``rotation`` is an optional 3×3 world rotation applied about
    ``rotation_origin`` followed by ``translation`` — the analog of
    CSXCAD ``AddTransform('RotateAxis'/'Translate')`` chains used by the
    multi-patch solver (reference: multi_3d.py:41-57 row-vector convention
    ``world = local @ (Rz·Ry·Rx)ᵀ + T``).
    """

    prop: object  # Material or PEC
    start: Tuple[float, float, float]
    stop: Tuple[float, float, float]
    priority: int = 0
    rotation: Optional[np.ndarray] = None  # 3x3
    rotation_origin: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    translation: Tuple[float, float, float] = (0.0, 0.0, 0.0)

    @property
    def lo(self) -> np.ndarray:
        return np.minimum(np.asarray(self.start, float), np.asarray(self.stop, float))

    @property
    def hi(self) -> np.ndarray:
        return np.maximum(np.asarray(self.start, float), np.asarray(self.stop, float))

    def is_transformed(self) -> bool:
        return self.rotation is not None or any(t != 0.0 for t in self.translation)

    def world_corners(self) -> np.ndarray:
        """All 8 corners after rotation+translation, shape (8, 3)."""
        lo, hi = self.lo, self.hi
        corners = np.array(
            [[x, y, z] for x in (lo[0], hi[0]) for y in (lo[1], hi[1]) for z in (lo[2], hi[2])]
        )
        return self.to_world(corners)

    def to_world(self, pts: np.ndarray) -> np.ndarray:
        """Local (mm) points → world (mm). pts: (..., 3)."""
        return _rigid_to_world(
            pts, self.rotation, self.rotation_origin, self.translation)

    def to_local(self, pts: np.ndarray) -> np.ndarray:
        """World (mm) points → local box frame (mm)."""
        return _rigid_to_local(
            pts, self.rotation, self.rotation_origin, self.translation)

    def contains(self, pts: np.ndarray, tol: float = 1e-9) -> np.ndarray:
        """Boolean mask: world points inside (or on) the transformed box."""
        local = self.to_local(pts)
        lo, hi = self.lo - tol, self.hi + tol
        return np.all((local >= lo) & (local <= hi), axis=-1)


@dataclass(frozen=True)
class ConvexPolyhedron:
    """Convex solid as an intersection of half-spaces n̂·x ≤ d (mm).

    Extends the box-only CSXCAD-style scene with slanted geometry (horn
    flare walls, wedges). Supports the same rigid transform fields as
    ``Box`` so instances can be placed/rotated.
    """

    prop: object  # Material or PEC
    planes: np.ndarray  # (n, 4): rows [nx, ny, nz, d] meaning n̂·x ≤ d
    priority: int = 0
    rotation: Optional[np.ndarray] = None
    rotation_origin: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    translation: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    # axis-aligned local bounds for meshing/world-bounds purposes
    bounds_lo: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    bounds_hi: Tuple[float, float, float] = (0.0, 0.0, 0.0)

    def to_local(self, pts: np.ndarray) -> np.ndarray:
        return _rigid_to_local(
            pts, self.rotation, self.rotation_origin, self.translation)

    def contains(self, pts: np.ndarray, tol: float = 1e-9) -> np.ndarray:
        """Boolean mask: world points inside every half-space. Each
        n̂·x is summed element by element, ``(n0·x + n1·y) + n2·z``, as
        the card's grid build (``csrc/grid_build.cu``) sums it, so both
        round alike whatever BLAS the host has."""
        local = self.to_local(pts)
        n = np.asarray(self.planes, float)
        lim = n[:, 3] + tol
        inside = np.ones(local.shape[:-1], bool)
        for p in range(len(n)):
            inside &= (local[..., 0] * n[p, 0] + local[..., 1] * n[p, 1]
                       + local[..., 2] * n[p, 2]) <= lim[p]
        return inside

    def world_corners(self) -> np.ndarray:
        lo = np.asarray(self.bounds_lo, float)
        hi = np.asarray(self.bounds_hi, float)
        corners = np.array(
            [[x, y, z] for x in (lo[0], hi[0]) for y in (lo[1], hi[1])
             for z in (lo[2], hi[2])]
        )
        return _rigid_to_world(
            corners, self.rotation, self.rotation_origin, self.translation)


def make_plate(corners: np.ndarray, thickness: float, prop, priority: int = 10,
               **transform) -> ConvexPolyhedron:
    """Thin plate through a planar quad: the plate plane ± thickness/2
    clipped by the four edge planes. ``corners`` (4, 3) in winding order.
    Used for slanted PEC walls (horn flares)."""
    c = np.asarray(corners, float)
    n = np.cross(c[1] - c[0], c[2] - c[0])
    n = n / np.linalg.norm(n)
    d0 = float(n @ c[0])
    planes = [
        np.concatenate([n, [d0 + thickness / 2]]),
        np.concatenate([-n, [-(d0 - thickness / 2)]]),
    ]
    center = c.mean(axis=0)
    for i in range(4):
        a, b = c[i], c[(i + 1) % 4]
        edge_n = np.cross(b - a, n)
        edge_n = edge_n / max(np.linalg.norm(edge_n), 1e-30)
        # orient outward (away from the quad center)
        if edge_n @ (center - a) > 0:
            edge_n = -edge_n
        planes.append(np.concatenate([edge_n, [float(edge_n @ a)]]))
    lo = c.min(axis=0) - thickness
    hi = c.max(axis=0) + thickness
    return ConvexPolyhedron(
        prop=prop, planes=np.stack(planes), priority=priority,
        bounds_lo=tuple(lo), bounds_hi=tuple(hi), **transform,
    )


@dataclass(frozen=True)
class LumpedPortSpec:
    """Lumped resistive port across a grid edge span.

    Equivalent of ``FDTD.AddLumpedPort(id, R, start, stop, dir, excite,
    priority, edges2grid)`` (reference: solver_fdtd_openems_fixed.py:215).
    ``direction`` in {'x','y','z'}; ``excite`` is the voltage amplitude
    (0 disables the source, leaving a passive load).
    """

    port_id: int
    resistance: float
    start: Tuple[float, float, float]
    stop: Tuple[float, float, float]
    direction: str = "z"
    excite: float = 1.0
    priority: int = 5


@dataclass(frozen=True)
class MSLPortSpec:
    """Microstrip-line port: distributed plane excitation + traveling-wave
    probes at a measurement plane.

    The reference ships an MSL path but force-disables it in favor of the
    lumped port (``use_msl = False``, multi_3d.py:458-467); this framework
    implements it for real. ``prop_axis`` is the propagation direction
    ('x'|'y'); the strip runs at height ``height_mm`` above the ground
    plane (z = 0), centered at ``strip_center_mm`` with ``strip_width_mm``
    across the transverse axis. ``exc_pos_mm``/``meas_pos_mm`` are the
    excitation and measurement plane coordinates along ``prop_axis``;
    ``z0_ohm`` is the line's characteristic impedance used for the
    incident/reflected wave split.
    """

    port_id: int
    prop_axis: str  # 'x' | 'y'
    strip_center_mm: float
    strip_width_mm: float
    height_mm: float
    exc_pos_mm: float
    meas_pos_mm: float
    z0_ohm: float = 50.0
    excite: float = 1.0


@dataclass(frozen=True)
class NF2FFBoxSpec:
    """Near-field recording box (``FDTD.CreateNF2FFBox()`` analog).

    If bounds are None the solver places it a few cells inside the outer
    boundary, matching openEMS's default placement.
    """

    start: Optional[Tuple[float, float, float]] = None
    stop: Optional[Tuple[float, float, float]] = None


@dataclass
class Scene:
    """A complete simulation scene: primitives + ports + NF2FF box (mm)."""

    boxes: List[Box] = field(default_factory=list)
    ports: List[LumpedPortSpec] = field(default_factory=list)
    msl_ports: List[MSLPortSpec] = field(default_factory=list)
    nf2ff: Optional[NF2FFBoxSpec] = None

    def add_msl_port(self, spec: "MSLPortSpec") -> "MSLPortSpec":
        self.msl_ports.append(spec)
        return spec

    def add_metal_box(
        self, name: str, start: Sequence[float], stop: Sequence[float],
        priority: int = 10, **kw,
    ) -> Box:
        box = Box(PEC(name), tuple(start), tuple(stop), priority=priority, **kw)
        self.boxes.append(box)
        return box

    def add_conductive_sheet(
        self, name: str, sigma_s: float, start: Sequence[float],
        stop: Sequence[float], priority: int = 10, **kw,
    ) -> Box:
        """Finite-conductivity metallization (sheet conductance σ·t_eff, S).

        The box should be degenerate (zero extent) along the sheet normal,
        like the PEC sheets the reference draws for patch/ground metal.
        """
        box = Box(
            ConductiveSheet(name, float(sigma_s)),
            tuple(start), tuple(stop), priority=priority, **kw,
        )
        self.boxes.append(box)
        return box

    def add_material_box(
        self, name: str, epsilon: float, kappa: float,
        start: Sequence[float], stop: Sequence[float], priority: int = 0, **kw,
    ) -> Box:
        box = Box(
            Material(name, epsilon=epsilon, kappa=kappa),
            tuple(start), tuple(stop), priority=priority, **kw,
        )
        self.boxes.append(box)
        return box

    def add_lumped_port(
        self, port_id: int, resistance: float,
        start: Sequence[float], stop: Sequence[float],
        direction: str = "z", excite: float = 1.0, priority: int = 5,
    ) -> LumpedPortSpec:
        port = LumpedPortSpec(
            port_id, resistance, tuple(start), tuple(stop),
            direction=direction, excite=excite, priority=priority,
        )
        self.ports.append(port)
        return port

    def add_polyhedron(self, poly: "ConvexPolyhedron") -> "ConvexPolyhedron":
        self.boxes.append(poly)
        return poly

    def world_bounds(self) -> Tuple[np.ndarray, np.ndarray]:
        """Axis-aligned bounds of all transformed primitives (mm)."""
        if not self.boxes:
            z = np.zeros(3)
            return z, z
        corners = np.concatenate([b.world_corners() for b in self.boxes], axis=0)
        return corners.min(axis=0), corners.max(axis=0)


def rotation_matrix(rx_deg: float, ry_deg: float, rz_deg: float) -> np.ndarray:
    """Combined rotation R = Rz @ Ry @ Rx (degrees), matching the reference's
    multi-patch world transform ``world = local @ (Rz·Ry·Rx)ᵀ + T``
    (reference: multi_3d.py:41-57) when used as ``Box.rotation``."""
    rx, ry, rz = np.deg2rad([rx_deg, ry_deg, rz_deg])
    cx, sx = np.cos(rx), np.sin(rx)
    cy, sy = np.cos(ry), np.sin(ry)
    cz, sz = np.cos(rz), np.sin(rz)
    Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return Rz @ Ry @ Rx
