"""Coefficients, ports, Huygens faces and the source, worked out again.

A frozen copy of the arithmetic of the port's
``ops/fdtd.py::build_simulation`` for what the configurations use:
lumped ports (their resistance folded into the edge conductivity, the
Piket-May formulation), ca/cb per E component with the outer walls and the
PEC masks, MUR wall coefficients, the Huygens box's faces and the Gaussian
source. No padding: the arrays have the grid's shape.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

from .mesh import YeeGrid
from .physics import C0, EPS0
from .scene import Scene
from .source import gaussian_excitation, source_active_steps
from .voxelize import cell_to_edge_average, voxelize

_AXIS_OF = {"x": 0, "y": 1, "z": 2}


@dataclasses.dataclass
class Port:
    """A lumped port on the grid: its E column, source column and the
    four H terms of its current loop."""

    axis: int
    sl: Tuple
    dl_m: np.ndarray
    src_col: np.ndarray
    i_terms: List[Tuple[int, Tuple[int, int, int], float]]  # (H comp, idx, w)


@dataclasses.dataclass
class Face:
    """One Huygens face: the plane index ``m`` along ``axis`` and the
    (u, v) index window, geometry for the transform."""

    name: str
    axis: int
    m: int
    u_axis: int
    v_axis: int
    u0: int
    u1: int
    v0: int
    v1: int
    normal: np.ndarray
    centers_m: np.ndarray
    areas_m2: np.ndarray


@dataclasses.dataclass
class RefSim:
    grid: YeeGrid
    dt: float
    ca: Tuple[np.ndarray, ...]
    cb: Tuple[np.ndarray, ...]
    src: Dict[int, np.ndarray]  # E component → source stamp
    inv_p: Tuple[np.ndarray, ...]
    inv_d: Tuple[np.ndarray, ...]
    mur: Tuple[Tuple[float, float], ...]
    ports: List[Port]
    faces: List[Face]
    waveform: np.ndarray
    n_source_steps: int
    decim_max: int  # the largest probe decimation the sampling allows


def _port(spec, grid: YeeGrid, sigma_edges) -> Port:
    axis = _AXIS_OF[spec.direction]
    t_axes = [a for a in range(3) if a != axis]
    lines = [grid.x, grid.y, grid.z]

    def nearest(ax, val):
        return int(np.argmin(np.abs(lines[ax] - val)))

    start = np.asarray(spec.start, float)
    stop = np.asarray(spec.stop, float)
    ti = [nearest(a, start[a]) for a in t_axes]
    e0 = nearest(axis, min(start[axis], stop[axis]))
    e1 = nearest(axis, max(start[axis], stop[axis]))
    n_edges = max(1, e1 - e0)
    dl = (np.diff(lines[axis]) * grid.unit)[e0:e0 + n_edges]
    dd = [grid.dual_deltas_m("xyz"[a]) for a in range(3)]
    area = dd[t_axes[0]][ti[0]] * dd[t_axes[1]][ti[1]]
    sl = [None, None, None]
    sl[axis] = slice(e0, e0 + n_edges)
    sl[t_axes[0]] = ti[0]
    sl[t_axes[1]] = ti[1]
    sl = tuple(sl)
    sigma_edges["e" + spec.direction][sl] += dl.sum() / (spec.resistance * area)

    u, v = (axis + 1) % 3, (axis + 2) % 3
    idx = [0, 0, 0]
    idx[axis] = e0 + n_edges // 2
    for a, t in zip(t_axes, ti):
        idx[a] = t
    for a in (u, v):
        if idx[a] < 1:
            raise ValueError("lumped port on the grid boundary")

    def at(ax, off):
        t2 = list(idx)
        t2[ax] += off
        return tuple(t2)

    dv, du = float(dd[v][idx[v]]), float(dd[u][idx[u]])
    # Ampère loop over the dual face: ΔH_v·dd_v − ΔH_u·dd_u
    i_terms = [(v, at(u, 0), dv), (v, at(u, -1), -dv),
               (u, at(v, 0), -du), (u, at(v, -1), du)]
    return Port(axis=axis, sl=sl, dl_m=dl, src_col=None, i_terms=i_terms)


def _faces(grid: YeeGrid, m: int) -> List[Face]:
    Q = grid.shape
    lo = {a: m for a in range(3)}
    hi = {a: Q[a] - 1 - m for a in range(3)}
    lines_m = [grid.x * grid.unit, grid.y * grid.unit, grid.z * grid.unit]
    d_m = [np.diff(l) for l in lines_m]
    ctr = [0.5 * (l[:-1] + l[1:]) for l in lines_m]
    faces = []
    for axis in range(3):
        ua, va = [a for a in range(3) if a != axis]
        u0, u1, v0, v1 = lo[ua], hi[ua], lo[va], hi[va]
        dA = np.outer(d_m[ua][u0:u1], d_m[va][v0:v1])
        for side, mm in (("lo", lo[axis]), ("hi", hi[axis])):
            normal = np.zeros(3)
            normal[axis] = -1.0 if side == "lo" else 1.0
            pts = np.zeros((u1 - u0, v1 - v0, 3))
            pts[..., axis] = lines_m[axis][mm]
            pts[..., ua] = ctr[ua][u0:u1][:, None]
            pts[..., va] = ctr[va][v0:v1][None, :]
            faces.append(Face(f"{'xyz'[axis]}_{side}", axis, mm, ua, va,
                              u0, u1, v0, v1, normal, pts, dA))
    return faces


def build(scene: Scene, grid: YeeGrid, *, f0: float, fc: float,
          boundary: str, n_steps_max: int, courant: float = 0.95,
          nf_margin_cells: int = 4) -> RefSim:
    """Voxelize ``scene`` on ``grid`` and build what a run steps with."""
    if not boundary.upper().startswith("MUR"):
        raise ValueError(f"the reference builds MUR runs only, not {boundary}")
    dt = grid.courant_dt(courant)
    vox = voxelize(scene, grid)
    sigma_edges = {c: cell_to_edge_average(vox.sigma, c)
                   for c in ("ex", "ey", "ez")}
    for comp, sheet in (("ex", vox.sheet_sigma_ex), ("ey", vox.sheet_sigma_ey),
                        ("ez", vox.sheet_sigma_ez)):
        if sheet is not None:
            sigma_edges[comp] = sigma_edges[comp] + sheet
    eps_edges = {c: cell_to_edge_average(vox.eps_r, c) * EPS0
                 for c in ("ex", "ey", "ez")}
    ports = [_port(p, grid, sigma_edges) for p in scene.ports]

    pec = {"ex": vox.pec_ex, "ey": vox.pec_ey, "ez": vox.pec_ez}
    ca_l, cb_l = [], []
    for comp, d_axis in (("ex", 0), ("ey", 1), ("ez", 2)):
        eps_a, sig_a = eps_edges[comp], sigma_edges[comp]
        beta = sig_a * dt / (2.0 * eps_a)
        ca = (1.0 - beta) / (1.0 + beta)
        cb = (dt / eps_a) / (1.0 + beta)
        sl = [slice(None)] * 3
        sl[d_axis] = -1
        ca[tuple(sl)] = 0.0
        cb[tuple(sl)] = 0.0
        for b_axis in (a for a in range(3) if a != d_axis):
            for i in (0, grid.shape[b_axis] - 1):
                slb = [slice(None)] * 3
                slb[b_axis] = i
                cb[tuple(slb)] = 0.0
                ca[tuple(slb)] = 1.0  # MUR: the wall carries its own update
        ca[pec[comp]] = 0.0
        cb[pec[comp]] = 0.0
        ca_l.append(ca.astype(np.float32))
        cb_l.append(cb.astype(np.float32))

    dd = [grid.dual_deltas_m("xyz"[a]) for a in range(3)]
    src: Dict[int, np.ndarray] = {}
    for prt, spec in zip(ports, scene.ports):
        cb_col = cb_l[prt.axis][prt.sl]
        t_axes = [a for a in range(3) if a != prt.axis]
        probe_idx = prt.i_terms[0][1]
        area = dd[t_axes[0]][probe_idx[t_axes[0]]] * dd[t_axes[1]][probe_idx[t_axes[1]]]
        unit = (cb_col / (spec.resistance * area)).astype(np.float32)
        prt.src_col = (unit * spec.excite).astype(np.float32)
        mat = src.setdefault(prt.axis, np.zeros(grid.shape, np.float32))
        mat[prt.sl] += prt.src_col

    inv_p, inv_d = [], []
    for name in "xyz":
        d = grid.deltas_m(name)
        ip = np.zeros(len(d) + 1, np.float32)
        ip[:len(d)] = 1.0 / d
        inv_p.append(ip)
        inv_d.append((1.0 / grid.dual_deltas_m(name)).astype(np.float32))
    mur = []
    for name in "xyz":
        d = grid.deltas_m(name)
        mur.append((float(np.float32((C0 * dt - d[0]) / (C0 * dt + d[0]))),
                    float(np.float32((C0 * dt - d[-1]) / (C0 * dt + d[-1])))))

    n_src = source_active_steps(f0, fc, dt)
    waveform = gaussian_excitation(f0, fc, dt, max(int(n_steps_max), n_src))
    return RefSim(
        grid=grid, dt=dt, ca=tuple(ca_l), cb=tuple(cb_l), src=src,
        inv_p=tuple(inv_p), inv_d=tuple(inv_d), mur=tuple(mur), ports=ports,
        faces=_faces(grid, nf_margin_cells), waveform=waveform,
        n_source_steps=n_src,
        decim_max=max(1, int(1.0 / (2.5 * (f0 + fc) * dt))),
    )

