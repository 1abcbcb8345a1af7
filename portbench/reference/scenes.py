"""The two kinds of scene the benchmark's jobs build, worked out again.

Frozen copies of the port's scene code, cut to what the configurations
use:

- :func:`design_scene`: the multi-antenna designer's scene (patches and
  pyramidal horns, rotated and translated, one lumped port each), with its
  mesh, step budget and far-field grid (the port's
  ``solvers/multi_patch_3d.py::prepare_multi_patch_3d``);
- :func:`sweep_scenes`: the canonical patch's geometry sweep, every
  variant's whole scene on the union grid of all of them (the port's
  ``solvers/sweep.py::prepare_patch_geometry_sweep``, without its delta
  path: the reference voxelizes each variant in full).

Every number comes from a configuration file and a traffic file
(``portbench/configs``, ``portbench/traffic``) and the job's draw.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import numpy as np

from .mesh import MeshBuilder, YeeGrid
from .physics import C0, design_patch_for_frequency, substrate_conductivity
from .scene import PEC, Box, Scene, make_plate, rotation_matrix
from .source import source_active_steps

PPW_MAP_10 = {
    1: 12.0, 2: 16.0, 3: 20.0, 4: 25.0, 5: 32.0,
    6: 40.0, 7: 50.0, 8: 65.0, 9: 80.0, 10: 100.0,
}
NRTS_MAP = {6: 50_000, 7: 70_000, 8: 100_000, 9: 130_000, 10: 160_000}
CHECK_EVERY = 500  # steps between energy checks (the port's default)
COURANT = 0.95


@dataclasses.dataclass
class RunSpec:
    """One simulation as the reference builds it."""

    scene: Scene
    grid: YeeGrid
    f0: float
    fc: float
    boundary: str
    n_steps_max: int
    end_criteria: float
    port_freqs_hz: np.ndarray
    nf_freqs_hz: np.ndarray
    theta: Optional[np.ndarray] = None  # degrees
    phi: Optional[np.ndarray] = None
    nf_center: Optional[np.ndarray] = None  # meters


# ---------------------------------------------------------------------------
# the designer's scene
# ---------------------------------------------------------------------------

def _si_mm(mm: float) -> float:
    """A length in mm through meters and back, as the port's parameter
    classes hold it (the round trip can move the last bit)."""
    return (float(mm) * 1e-3) * 1e3


def patch_dims_mm(p: dict) -> Tuple[float, float, float]:
    """(W, L, h) in mm: the stated sizes, else the TM10 design."""
    f = p["frequency_ghz"] * 1e9
    h_m = p["h_mm"] * 1e-3
    if p.get("W_mm") and p.get("L_mm"):
        return _si_mm(p["W_mm"]), _si_mm(p["L_mm"]), h_m * 1e3
    L_m, W_m, _ = design_patch_for_frequency(f, p["er"], h_m)
    return W_m * 1e3, L_m * 1e3, h_m * 1e3


def microstrip_width(freq_hz: float, eps_r: float, h_m: float,
                     z0: float = 50.0) -> float:
    """Microstrip width for a target Z0 (Wheeler's synthesis)."""
    if z0 < 44.0:
        A = (z0 / 60.0) * math.sqrt((eps_r + 1.0) / 2.0) + (
            (eps_r - 1.0) / (eps_r + 1.0)
        ) * (0.23 + 0.11 / eps_r)
        w_h = 8.0 * math.exp(A) / (math.exp(2.0 * A) - 2.0)
    else:
        B = 377.0 * math.pi / (2.0 * z0 * math.sqrt(eps_r))
        w_h = (2.0 / math.pi) * (
            B - 1.0 - math.log(2.0 * B - 1.0)
            + ((eps_r - 1.0) / (2.0 * eps_r))
            * (math.log(B - 1.0) + 0.39 - 0.61 / eps_r)
        )
    return w_h * h_m


def _patch_local_geometry(p: dict, feed_line_length_mm: float,
                          margin_mm: float):
    """Local boxes and port line of one patch instance, in mm."""
    fd = p.get("feed_direction", "-X").upper()
    patch_W, patch_L, h = patch_dims_mm(p)
    fw = microstrip_width(p["frequency_ghz"] * 1e9, p["er"],
                          p["h_mm"] * 1e-3) * 1e3
    margin, fl = float(margin_mm), float(feed_line_length_mm)
    if fd in ("+X", "-X"):
        sub_W, sub_L = patch_W + 2 * margin + fl, patch_L + 2 * margin
    else:
        sub_W, sub_L = patch_W + 2 * margin, patch_L + 2 * margin + fl
    if fd == "-X":
        feed_lo, feed_hi = [-sub_W / 2, -fw / 2, h], [-patch_W / 2, fw / 2, h]
        fp = (-patch_W / 2, 0.0)
    elif fd == "+X":
        feed_lo, feed_hi = [patch_W / 2, -fw / 2, h], [sub_W / 2, fw / 2, h]
        fp = (patch_W / 2, 0.0)
    elif fd == "-Y":
        feed_lo, feed_hi = [-fw / 2, -sub_L / 2, h], [fw / 2, -patch_L / 2, h]
        fp = (0.0, -patch_L / 2)
    else:
        feed_lo, feed_hi = [-fw / 2, patch_L / 2, h], [fw / 2, sub_L / 2, h]
        fp = (0.0, patch_L / 2)
    boxes = dict(
        substrate=([-sub_W / 2, -sub_L / 2, 0.0], [sub_W / 2, sub_L / 2, h]),
        ground=([-sub_W / 2, -sub_L / 2, 0.0], [sub_W / 2, sub_L / 2, 0.0]),
        patch=([-patch_W / 2, -patch_L / 2, h], [patch_W / 2, patch_L / 2, h]),
        feed=(feed_lo, feed_hi),
    )
    port_line = (np.array([fp[0], fp[1], 0.0]), np.array([fp[0], fp[1], h]))
    return boxes, port_line, h


def horn_local_geometry(hp: dict, mesh_res_mm: float) -> dict:
    """Local-frame horn (axis +z, throat at z = 0): PEC wall boxes, flare
    quads, the feed's port line, wall thickness and key mesh lines (mm)."""
    f0 = hp["frequency_ghz"] * 1e9
    a_m = hp["throat_a_mm"] * 1e-3
    a, b = a_m * 1e3, _si_mm(hp["throat_b_mm"])
    A, B = _si_mm(hp["aperture_A_mm"]), _si_mm(hp["aperture_B_mm"])
    L = _si_mm(hp["length_mm"])
    fcut = C0 / (2.0 * a_m)
    if f0 <= fcut:
        raise ValueError("horn below its TE10 cutoff")
    lam_g = C0 / f0 / math.sqrt(1.0 - (fcut / f0) ** 2) * 1e3
    L_wg = 0.75 * lam_g
    z_feed = -L_wg + 0.25 * lam_g
    t = max(1.0, mesh_res_mm)
    boxes = [
        ([-a / 2 - t, -b / 2 - t, -L_wg], [-a / 2, b / 2 + t, 0]),
        ([a / 2, -b / 2 - t, -L_wg], [a / 2 + t, b / 2 + t, 0]),
        ([-a / 2, -b / 2 - t, -L_wg], [a / 2, -b / 2, 0]),
        ([-a / 2, b / 2, -L_wg], [a / 2, b / 2 + t, 0]),
        ([-a / 2 - t, -b / 2 - t, -L_wg - t], [a / 2 + t, b / 2 + t, -L_wg]),
    ]
    quads = [
        np.array([(a / 2, -b / 2, 0), (a / 2, b / 2, 0),
                  (A / 2, B / 2, L), (A / 2, -B / 2, L)]),
        np.array([(-a / 2, -b / 2, 0), (-a / 2, b / 2, 0),
                  (-A / 2, B / 2, L), (-A / 2, -B / 2, L)]),
        np.array([(-a / 2, b / 2, 0), (a / 2, b / 2, 0),
                  (A / 2, B / 2, L), (-A / 2, B / 2, L)]),
        np.array([(-a / 2, -b / 2, 0), (a / 2, -b / 2, 0),
                  (A / 2, -B / 2, L), (-A / 2, -B / 2, L)]),
    ]
    port_line = (np.array([0.0, -b / 2, z_feed]),
                 np.array([0.0, b / 2, z_feed]))
    mesh_lines = dict(
        x=[-a / 2, a / 2, -A / 2, A / 2, 0.0],
        y=[-b / 2, b / 2, -B / 2, B / 2, 0.0],
        z=[-L_wg - t, -L_wg, 0.0, L, float(z_feed)],
    )
    return dict(boxes=boxes, quads=quads, port_line=port_line, t=t,
                mesh_lines=mesh_lines, L_wg=L_wg, A=A, B=B, L=L)


def _densify_rotated(mb, hull_box, mesh_res, axis, lo, hi):
    corners = hull_box.world_corners()
    lo_w, hi_w = corners.min(axis=0), corners.max(axis=0)
    for a, nm in enumerate("xyz"):
        n_lines = max(3, int(np.ceil((hi_w[a] - lo_w[a]) / (mesh_res / 2))))
        mb.add_line(nm, np.linspace(lo_w[a], hi_w[a], n_lines + 1))
    mb.add_line("xyz"[axis], [lo[axis], hi[axis], 0.5 * (lo + hi)[axis]])


def _port_on_axis(p0, p1, axis):
    mid = 0.5 * (p0 + p1)
    span = abs((p1 - p0)[axis])
    lo, hi = mid.copy(), mid.copy()
    lo[axis] = mid[axis] - span / 2
    hi[axis] = mid[axis] + span / 2
    pol = float(np.sign((p1 - p0)[axis]) or 1.0)
    return lo, hi, pol


def _placement(inst: dict):
    R = rotation_matrix(*inst.get("rot_deg", (0.0, 0.0, 0.0)))
    rotated = not np.allclose(R, np.eye(3), atol=1e-9)
    T = np.asarray(inst.get("center_m", (0.0, 0.0, 0.0)), float) * 1e3
    return R, rotated, T


def design_scene(config: dict, boundary: str, loss_tangent: float) -> RunSpec:
    """The designer's scene of ``config`` with every patch's substrate at
    ``loss_tangent``."""
    c = config["controls"]
    patches, horns = config.get("patches", []), config.get("horns", [])
    freqs = [p["frequency_ghz"] * 1e9 for p in patches + horns]
    f_lo, f_hi = min(freqs), max(freqs)
    if f_lo == f_hi:
        f0, fc = f_hi, f_hi / 2.0
    else:
        f0 = 0.5 * (0.7 * f_lo + 1.3 * f_hi)
        fc = max(0.5 * (1.3 * f_hi - 0.7 * f_lo), f0 / 2.0)
    q = max(1, min(10, int(c["mesh_quality"])))
    mesh_res = C0 / (f0 + fc) / 1e-3 / PPW_MAP_10[q]

    scene = Scene()
    mb = MeshBuilder()
    centers = []
    for idx, p in enumerate(patches):
        boxes, port_line, h = _patch_local_geometry(
            p, c["feed_line_length_mm"], c["element_margin_mm"])
        R, rotated, T = _placement(p)
        centers.append(T)
        kw = dict(rotation=R if rotated else None, translation=tuple(T))
        kappa = substrate_conductivity(p["frequency_ghz"] * 1e9, p["er"],
                                       loss_tangent)
        scene.add_material_box(f"substrate_{idx}", p["er"], kappa,
                               *boxes["substrate"], priority=0, **kw)
        scene.add_metal_box(f"ground_{idx}", *boxes["ground"], priority=10,
                            **kw)
        scene.add_metal_box(f"patch_{idx}", *boxes["patch"], priority=10, **kw)
        scene.add_metal_box(f"feed_{idx}", *boxes["feed"], priority=10, **kw)
        p0 = port_line[0] @ R.T + T
        p1 = port_line[1] @ R.T + T
        axis = int(np.argmax(np.abs(R @ np.array([0.0, 0.0, 1.0]))))
        lo, hi, pol = _port_on_axis(p0, p1, axis)
        scene.add_lumped_port(idx + 1, 50.0, lo, hi, direction="xyz"[axis],
                              excite=pol)
        if not rotated:
            def shifted(b):
                return ([v + t for v, t in zip(b[0], T)],
                        [v + t for v, t in zip(b[1], T)])
            mb.add_metal_edges(*shifted(boxes["patch"]), dirs="xy",
                               metal_edge_res=mesh_res / 2)
            mb.add_metal_edges(*shifted(boxes["ground"]), dirs="xy")
            mb.add_metal_edges(*shifted(boxes["feed"]), dirs="xy",
                               metal_edge_res=mesh_res / 2)
            mb.add_line("z", np.linspace(T[2], T[2] + h, 5))
            mb.add_line("x", [lo[0]])
            mb.add_line("y", [lo[1]])
        else:
            sub = Box(None, boxes["substrate"][0], boxes["substrate"][1],
                      rotation=R, translation=tuple(T))
            _densify_rotated(mb, sub, mesh_res, axis, lo, hi)

    for hidx, hp in enumerate(horns):
        geo = horn_local_geometry(hp, mesh_res)
        R, rotated, T = _placement(hp)
        centers.append(T)
        kw = dict(rotation=R if rotated else None, translation=tuple(T))
        for bi, (blo, bhi) in enumerate(geo["boxes"]):
            scene.add_metal_box(f"horn{hidx}_wg_{bi}", blo, bhi, priority=10,
                                **kw)
        pec = PEC(f"horn{hidx}_flare")
        for quad in geo["quads"]:
            scene.add_polyhedron(make_plate(quad @ R.T + T, geo["t"], pec,
                                            priority=10))
        p0 = geo["port_line"][0] @ R.T + T
        p1 = geo["port_line"][1] @ R.T + T
        axis = int(np.argmax(np.abs(R @ np.array([0.0, 1.0, 0.0]))))
        lo, hi, pol = _port_on_axis(p0, p1, axis)
        scene.add_lumped_port(len(patches) + hidx + 1, 50.0, lo, hi,
                              direction="xyz"[axis], excite=pol)
        if not rotated:
            for nm, vals in geo["mesh_lines"].items():
                off = T["xyz".index(nm)]
                mb.add_line(nm, [v + off for v in vals])
        else:
            ext = max(geo["A"], geo["B"]) / 2
            hull = Box(None, [-ext, -ext, -geo["L_wg"] - geo["t"]],
                       [ext, ext, geo["L"]], rotation=R, translation=tuple(T))
            _densify_rotated(mb, hull, mesh_res, axis, lo, hi)

    lo_b, hi_b = scene.world_bounds()
    if c["simbox_mode"] == "manual":
        mid = 0.5 * (lo_b + hi_b)
        half = np.asarray(c["manual_size_mm"], float) / 2
        box_lo, box_hi = mid - half, mid + half
    else:
        m = np.asarray(c["auto_margin_mm"], float) / 2
        box_lo, box_hi = lo_b - m, hi_b + m
    for a, nm in enumerate("xyz"):
        mb.add_line(nm, [box_lo[a], box_hi[a]])
    grid = mb.build(mesh_res, ratio=1.4)

    nr_ts = NRTS_MAP.get(q, 30_000)
    dt = grid.courant_dt(COURANT)
    nr_ts = max(nr_ts, min(220_000, int(2.2 * source_active_steps(f0, fc, dt))))
    ec_db = max(-80.0, min(-10.0, float(c["end_criteria_db"])))
    t_step = max(0.5, float(c["theta_step_deg"]))
    p_step = max(1.0, float(c["phi_step_deg"]))
    if c["nf_center_mode"] == "centroid":
        nf_center = np.mean(np.stack(centers), axis=0) * 1e-3
    else:
        nf_center = np.zeros(3)
    return RunSpec(
        scene=scene, grid=grid, f0=f0, fc=fc, boundary=boundary,
        n_steps_max=nr_ts, end_criteria=10.0 ** (ec_db / 20.0),
        port_freqs_hz=np.linspace(max(1e8, 0.7 * f_lo), 1.3 * f_hi, 201),
        nf_freqs_hz=np.linspace(max(1e8, 0.7 * f_lo), 1.3 * f_hi, 15),
        theta=np.arange(0.0, 181.0, t_step),
        phi=np.arange(0.0, 360.0 + p_step, p_step),
        nf_center=nf_center,
    )


# ---------------------------------------------------------------------------
# the canonical patch's geometry sweep
# ---------------------------------------------------------------------------

def sweep_variants(config: dict, traffic: dict) -> List[Tuple[float, float]]:
    """(W, L) in mm of each variant: the base plus i steps."""
    return [(config["W_mm"] + traffic["dW_mm"] * i,
             config["L_mm"] + traffic["dL_mm"] * i)
            for i in range(int(traffic["variants"]))]



def sweep_scenes(config: dict, traffic: dict, boundary: str,
                 loss_tangent: float) -> Tuple[List[Scene], RunSpec]:
    """Every variant's whole scene and the union grid they share."""
    f0 = config["frequency_ghz"] * 1e9
    fc = f0 / 2.0
    h = _si_mm(config["h_mm"])
    er = config["er"]
    sub = config["substrate_mm"] / 2
    feed = config["feed_pos_mm"]
    mesh_res = C0 / (f0 + fc) / 1e-3 / config["ppw"]
    dims = [(_si_mm(W), _si_mm(L)) for W, L in sweep_variants(config, traffic)]

    box = config["box_mm"]
    mb = MeshBuilder()
    mb.add_line("x", box["x"])
    mb.add_line("y", box["y"])
    mb.add_line("z", box["z"])
    mb.add_line("z", np.linspace(0.0, h, 5))
    mb.add_line("x", [feed])
    mb.add_line("y", [0.0])
    mb.add_metal_edges([-sub, -sub, 0], [sub, sub, 0], dirs="xy")
    for W, L in dims:
        mb.add_metal_edges([-W / 2, -L / 2, h], [W / 2, L / 2, h], dirs="xy",
                           metal_edge_res=mesh_res / 2)
    grid = mb.build(mesh_res, ratio=1.4)

    kappa = substrate_conductivity(f0, er, loss_tangent)
    scenes = []
    for W, L in dims:
        s = Scene()
        s.add_material_box("substrate", er, kappa, [-sub, -sub, 0.0],
                           [sub, sub, h], priority=0)
        s.add_metal_box("patch", [-W / 2, -L / 2, h], [W / 2, L / 2, h], 10)
        s.add_metal_box("gnd", [-sub, -sub, 0.0], [sub, sub, 0.0], 10)
        s.add_lumped_port(1, 50.0, [feed, 0.0, 0.0], [feed, 0.0, h],
                          direction="z")
        scenes.append(s)
    spec = RunSpec(
        scene=scenes[0], grid=grid, f0=f0, fc=fc, boundary=boundary,
        n_steps_max=int(config["n_steps_max"]),
        end_criteria=float(config["end_criteria"]),
        port_freqs_hz=np.linspace(max(1e8, f0 * 0.5), f0 * 1.5, 201),
        nf_freqs_hz=np.array([f0]),
    )
    return scenes, spec
