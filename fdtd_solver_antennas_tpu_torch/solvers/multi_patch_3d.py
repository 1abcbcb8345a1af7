"""Multi-antenna scene solver on PyTorch: N rotated/translated patches and
pyramidal horns in one FDTD run.

Counterpart of ``fdtd_solver_antennas_tpu/solvers/multi_patch_3d.py``:

- per-instance substrate/ground/patch/feed-strip primitives with full 3D
  rotations (``world = local @ (Rz·Ry·Rx)ᵀ + T``), as oriented boxes;
- horns as PEC waveguide boxes and four flare plates
  (``ConvexPolyhedron``), fed by a lumped port across the guide height;
- one lumped port per instance along the rotated normal's dominant axis,
  all ports excited in phase (the rotated polarity rides in the sign);
- mesh quality → ppw map 1..10, NrTS budget 30k→160k with the
  excitation-length bump capped at 220k, from the actual Courant dt;
- EndCriteria from a dB value clamped to [−80, −10] via 10^(dB/20);
- auto/manual sim box from oriented world bounds;
- NF2FF phase center 'origin' or 'centroid';
- mesh densification over each rotated instance's world bounding box.

Large scenes (the 4.2M-cell mixed patch+horn scene) resolve to the stream
kernel; ``device`` chooses where the run steps: 'cuda' launches the CUDA
kernels, 'cpu' runs their plain PyTorch twins.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional, Sequence, Tuple

import numpy as np

from ..models.params import HornAntennaParams, PatchAntennaParams
from ..models.scene import PEC, Box, Scene, make_plate, rotation_matrix
from ..ops.fdtd import FDTDConfig, build_simulation
from ..ops.mesh import MeshBuilder
from ..ops.source import source_active_steps
from ..physics import C0, design_patch_for_frequency, substrate_conductivity
from ..post.nf2ff import nf2ff_transform, select_face_freqs
from ..post.ports import find_resonance, port_spectra
from ..utils import tracing
from .base import FDTDSolverResult, SolverPrepared, radiation_efficiency
from .horn import horn_local_geometry
from .microstrip import FeedDirection, calculate_microstrip_width

PPW_MAP_10 = {
    1: 12.0, 2: 16.0, 3: 20.0, 4: 25.0, 5: 32.0,
    6: 40.0, 7: 50.0, 8: 65.0, 9: 80.0, 10: 100.0,
}
NRTS_MAP = {6: 50_000, 7: 70_000, 8: 100_000, 9: 130_000, 10: 160_000}


@dataclasses.dataclass
class PatchLike:
    """Duck-typed patch instance: any object with these attributes works
    (the designer's instances do)."""

    name: str
    params: PatchAntennaParams
    center_x_m: float = 0.0
    center_y_m: float = 0.0
    center_z_m: float = 0.0
    feed_direction: FeedDirection = FeedDirection.NEG_X
    rot_x_deg: float = 0.0
    rot_y_deg: float = 0.0
    rot_z_deg: float = 0.0


@dataclasses.dataclass
class HornLike:
    """Duck-typed horn instance."""

    name: str
    params: HornAntennaParams
    center_x_m: float = 0.0
    center_y_m: float = 0.0
    center_z_m: float = 0.0
    rot_x_deg: float = 0.0
    rot_y_deg: float = 0.0
    rot_z_deg: float = 0.0


def _patch_dims_mm(params: PatchAntennaParams) -> Tuple[float, float, float]:
    if params.patch_length_m and params.patch_width_m:
        return params.patch_width_m * 1e3, params.patch_length_m * 1e3, params.h_m * 1e3
    L_m, W_m, _ = design_patch_for_frequency(
        params.frequency_hz, params.eps_r, params.h_m
    )
    return W_m * 1e3, L_m * 1e3, params.h_m * 1e3


def _instance_local_geometry(
    inst: PatchLike, feed_line_length_mm: float, margin_mm: float = 30.0
):
    """Local (unrotated) boxes + port line for one instance, in mm: the
    substrate is the patch + 2×margin + the feed length along the feed
    axis."""
    fd = FeedDirection(inst.feed_direction)
    patch_W, patch_L, h = _patch_dims_mm(inst.params)
    fw = calculate_microstrip_width(
        inst.params.frequency_hz, inst.params.eps_r, inst.params.h_m
    ) * 1e3
    margin, fl = float(margin_mm), float(feed_line_length_mm)
    if fd in (FeedDirection.POS_X, FeedDirection.NEG_X):
        sub_W, sub_L = patch_W + 2 * margin + fl, patch_L + 2 * margin
    else:
        sub_W, sub_L = patch_W + 2 * margin, patch_L + 2 * margin + fl

    if fd == FeedDirection.NEG_X:
        feed_lo, feed_hi = [-sub_W / 2, -fw / 2, h], [-patch_W / 2, fw / 2, h]
        fp = (-patch_W / 2, 0.0)
    elif fd == FeedDirection.POS_X:
        feed_lo, feed_hi = [patch_W / 2, -fw / 2, h], [sub_W / 2, fw / 2, h]
        fp = (patch_W / 2, 0.0)
    elif fd == FeedDirection.NEG_Y:
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
    dims = dict(patch_W=patch_W, patch_L=patch_L, h=h, sub_W=sub_W, sub_L=sub_L,
                feed_width=fw)
    return boxes, port_line, dims


def _densify_rotated(mb, hull_box, mesh_res, axis, lo, hi):
    """Mesh densification over a rotated instance's world AABB at res/2
    plus the port's own lines, shared by the patch and horn loops."""
    corners = hull_box.world_corners()
    lo_w, hi_w = corners.min(axis=0), corners.max(axis=0)
    for a, nm in enumerate("xyz"):
        n_lines = max(3, int(np.ceil((hi_w[a] - lo_w[a]) / (mesh_res / 2))))
        mb.add_line(nm, np.linspace(lo_w[a], hi_w[a], n_lines + 1))
    mb.add_line("xyz"[axis], [lo[axis], hi[axis], 0.5 * (lo + hi)[axis]])


def _port_on_axis(p0, p1, axis):
    """The port line projected onto grid axis ``axis``: (lo, hi, span,
    polarity). The engine normalizes start/stop, so the rotated
    ground→patch direction rides in the excitation sign."""
    mid = 0.5 * (p0 + p1)
    span = abs((p1 - p0)[axis])
    lo, hi = mid.copy(), mid.copy()
    lo[axis] = mid[axis] - span / 2
    hi[axis] = mid[axis] + span / 2
    pol = float(np.sign((p1 - p0)[axis]) or 1.0)
    return lo, hi, span, pol


@tracing.traced("fdtd.prepare")
def prepare_multi_patch_3d(
    patches: Sequence[PatchLike],
    *,
    horns: Sequence[HornLike] = (),
    device="cuda",
    boundary: str = "MUR",
    theta_step_deg: float = 2.0,
    phi_step_deg: float = 5.0,
    mesh_quality: int = 3,
    nf_center_mode: str = "origin",  # 'origin' | 'centroid'
    simbox_mode: str = "auto",  # 'auto' | 'manual'
    auto_margin_mm: Tuple[float, float, float] = (80.0, 80.0, 160.0),
    manual_size_mm: Optional[Tuple[float, float, float]] = None,
    feed_line_length_mm: float = 20.0,
    element_margin_mm: float = 30.0,
    end_criteria_db: float = -25.0,
    verbose: int = 0,
    log_cb: Optional[Callable[[str], None]] = None,
) -> SolverPrepared:
    """Build the scene of every instance and its simulation on ``device``."""
    try:
        if not patches and not horns:
            return SolverPrepared(False, "No antenna instances provided.")

        def _log(msg: str) -> None:
            if log_cb is not None:
                try:
                    log_cb(msg)
                    return
                except Exception:
                    pass
            if verbose:
                print(msg)

        with tracing.span("fdtd.prepare.scene"):  # the scene and its mesh
            freqs = [
                float(inst.params.frequency_hz)
                for inst in list(patches) + list(horns)
            ]
            f_lo, f_hi = min(freqs), max(freqs)
            if f_lo == f_hi:
                f0 = f_hi
                fc = f0 / 2.0
            else:
                # mixed-frequency scene: the excitation band and the analysis
                # sweep cover every instance
                f0 = 0.5 * (0.7 * f_lo + 1.3 * f_hi)
                fc = max(0.5 * (1.3 * f_hi - 0.7 * f_lo), f0 / 2.0)
            q = max(1, min(10, int(mesh_quality)))
            ppw = PPW_MAP_10.get(q, 20.0)
            mesh_res = C0 / (f0 + fc) / 1e-3 / ppw

            scene = Scene()
            mb = MeshBuilder()
            centers = []
            port_axes = []
            top_metal_aabbs = []  # (instance, name, world lo, world hi)
            for idx, inst in enumerate(patches):
                boxes, port_line, dims = _instance_local_geometry(
                    inst, feed_line_length_mm, element_margin_mm
                )
                R = rotation_matrix(inst.rot_x_deg, inst.rot_y_deg, inst.rot_z_deg)
                rotated = not np.allclose(R, np.eye(3), atol=1e-9)
                T = np.array(
                    [inst.center_x_m, inst.center_y_m, inst.center_z_m]
                ) * 1e3  # mm
                centers.append(T)
                kw = dict(rotation=R if rotated else None, translation=tuple(T))

                kappa = substrate_conductivity(
                    inst.params.frequency_hz, inst.params.eps_r,
                    inst.params.loss_tangent,
                )
                scene.add_material_box(
                    f"substrate_{idx}", inst.params.eps_r, kappa, *boxes["substrate"],
                    priority=0, **kw,
                )
                scene.add_metal_box(f"ground_{idx}", *boxes["ground"],
                                    priority=10, **kw)
                b_patch = scene.add_metal_box(
                    f"patch_{idx}", *boxes["patch"], priority=10, **kw)
                b_feed = scene.add_metal_box(
                    f"feed_{idx}", *boxes["feed"], priority=10, **kw)
                for b in (b_patch, b_feed):
                    c = b.world_corners()
                    top_metal_aabbs.append(
                        (idx, b.prop.name, c.min(axis=0), c.max(axis=0)))

                # port along the rotated substrate normal's dominant axis
                p0 = port_line[0] @ R.T + T
                p1 = port_line[1] @ R.T + T
                axis = int(np.argmax(np.abs(R @ np.array([0.0, 0.0, 1.0]))))
                port_axes.append(axis)
                lo, hi, span, pol = _port_on_axis(p0, p1, axis)
                scene.add_lumped_port(
                    idx + 1, 50.0, lo, hi, direction="xyz"[axis], excite=pol
                )
                mid = 0.5 * (lo + hi)
                _log(
                    f"port {idx + 1}: axis {'xyz'[axis]}, span {span:.3f} mm, "
                    f"center ({mid[0]:.1f}, {mid[1]:.1f}, {mid[2]:.1f}) mm"
                )

                if not rotated:
                    mb.add_metal_edges(
                        [b + t for b, t in zip(boxes["patch"][0], T)],
                        [b + t for b, t in zip(boxes["patch"][1], T)],
                        dirs="xy", metal_edge_res=mesh_res / 2,
                    )
                    mb.add_metal_edges(
                        [b + t for b, t in zip(boxes["ground"][0], T)],
                        [b + t for b, t in zip(boxes["ground"][1], T)], dirs="xy",
                    )
                    mb.add_metal_edges(
                        [b + t for b, t in zip(boxes["feed"][0], T)],
                        [b + t for b, t in zip(boxes["feed"][1], T)],
                        dirs="xy", metal_edge_res=mesh_res / 2,
                    )
                    mb.add_line("z", np.linspace(T[2], T[2] + dims["h"], 5))
                    mb.add_line("x", [lo[0]])
                    mb.add_line("y", [lo[1]])
                else:
                    sub_box = Box(
                        None, boxes["substrate"][0], boxes["substrate"][1],
                        rotation=R, translation=tuple(T),
                    )
                    _densify_rotated(mb, sub_box, mesh_res, axis, lo, hi)

            # cross-instance top-metal overlap: a galvanic short between
            # elements reads as absurd coupling, not a failure, so say so
            # (AABB test: exact for unrotated instances, conservative else)
            for ii in range(len(top_metal_aabbs)):
                for jj in range(ii + 1, len(top_metal_aabbs)):
                    ia, na, lo_a, hi_a = top_metal_aabbs[ii]
                    ib, nb, lo_b, hi_b = top_metal_aabbs[jj]
                    if ia == ib:
                        continue
                    if np.all(hi_a >= lo_b - 1e-9) and np.all(hi_b >= lo_a - 1e-9):
                        _log(
                            f"WARNING: metal '{na}' (instance {ia}) overlaps "
                            f"'{nb}' (instance {ib}) — the elements are "
                            f"galvanically connected; increase spacing or "
                            f"shrink element_margin_mm/feed_line_length_mm"
                        )

            for hidx, inst in enumerate(horns):
                geo = horn_local_geometry(inst.params, mesh_res)
                R = rotation_matrix(inst.rot_x_deg, inst.rot_y_deg, inst.rot_z_deg)
                rotated = not np.allclose(R, np.eye(3), atol=1e-9)
                T = np.array(
                    [inst.center_x_m, inst.center_y_m, inst.center_z_m]
                ) * 1e3  # mm
                centers.append(T)
                kw = dict(rotation=R if rotated else None, translation=tuple(T))

                for bi, (blo, bhi) in enumerate(geo["boxes"]):
                    scene.add_metal_box(f"horn{hidx}_wg_{bi}", blo, bhi,
                                        priority=10, **kw)
                pec = PEC(f"horn{hidx}_flare")
                for quad in geo["quads"]:
                    # plates take world-frame corners directly
                    scene.add_polyhedron(
                        make_plate(quad @ R.T + T, geo["t"], pec, priority=10)
                    )

                # feed port along the rotated guide-height (local y) direction
                p0 = geo["port_line"][0] @ R.T + T
                p1 = geo["port_line"][1] @ R.T + T
                axis = int(np.argmax(np.abs(R @ np.array([0.0, 1.0, 0.0]))))
                port_axes.append(axis)
                lo, hi, span, pol = _port_on_axis(p0, p1, axis)
                port_id = len(patches) + hidx + 1
                scene.add_lumped_port(
                    port_id, 50.0, lo, hi, direction="xyz"[axis], excite=pol
                )
                mid = 0.5 * (lo + hi)
                _log(
                    f"port {port_id} (horn): axis {'xyz'[axis]}, "
                    f"span {span:.3f} mm, "
                    f"center ({mid[0]:.1f}, {mid[1]:.1f}, {mid[2]:.1f}) mm"
                )

                if not rotated:
                    for nm, vals in geo["mesh_lines"].items():
                        off = T["xyz".index(nm)]
                        mb.add_line(nm, [v + off for v in vals])
                else:
                    ext = max(geo["A"], geo["B"]) / 2
                    hull = Box(
                        None,
                        [-ext, -ext, -geo["L_wg"] - geo["t"]],
                        [ext, ext, geo["L"]],
                        rotation=R, translation=tuple(T),
                    )
                    _densify_rotated(mb, hull, mesh_res, axis, lo, hi)

            # simulation box
            lo_b, hi_b = scene.world_bounds()
            if simbox_mode == "manual" and manual_size_mm is not None:
                c = 0.5 * (lo_b + hi_b)
                half = np.asarray(manual_size_mm, float) / 2
                box_lo, box_hi = c - half, c + half
            else:
                m = np.asarray(auto_margin_mm, float) / 2
                box_lo, box_hi = lo_b - m, hi_b + m
            for a, nm in enumerate("xyz"):
                mb.add_line(nm, [box_lo[a], box_hi[a]])
            grid = mb.build(mesh_res, ratio=1.4)

        # timestep budget, from the exact dt
        nr_ts = NRTS_MAP.get(q, 30_000)
        dt = grid.courant_dt(0.95)
        exc_steps = source_active_steps(f0, fc, dt)
        nr_ts = max(nr_ts, min(220_000, int(2.2 * exc_steps)))
        ec_db = max(-80.0, min(-10.0, float(end_criteria_db)))
        # amplitude convention 10^(dB/20), compared against an energy
        # ratio (openEMS's EndCriteria contract)
        ec_lin = 10.0 ** (ec_db / 20.0)
        _log(
            f"Mesh q={q} → ppw={ppw:g}, res={mesh_res:.3f} mm, grid {grid.shape} "
            f"({grid.num_cells} cells); NrTS={nr_ts}, EndCriteria {ec_db:g} dB"
        )

        cfg = FDTDConfig(
            n_steps_max=nr_ts, end_criteria=ec_lin, boundary=boundary
        )
        sim = build_simulation(
            scene, grid, f0=f0, fc=fc, cfg=cfg, device=device,
            # the port sweep and the NF2FF rows span every instance's band
            port_freqs_hz=np.linspace(
                max(1e8, 0.7 * f_lo), 1.3 * f_hi, 201),
            nf_freqs_hz=np.linspace(max(1e8, 0.7 * f_lo), 1.3 * f_hi, 15),
        )
        _log(f"engine path: {sim.pallas_mode_reason}")

        t_step = max(0.5, float(theta_step_deg))
        p_step = max(1.0, float(phi_step_deg))
        theta = np.arange(0.0, 181.0, t_step)
        phi = np.arange(0.0, 360.0 + p_step, p_step)
        if nf_center_mode == "centroid":
            nf_center = np.mean(np.stack(centers), axis=0) * 1e-3
        else:
            nf_center = np.zeros(3)

        return SolverPrepared(
            True,
            f"Multi-antenna prepared on {sim.device}: {len(patches)} "
            f"patch(es), {len(horns)} horn(s), grid {grid.shape}",
            sim=sim,
            theta=theta,
            phi=phi,
            nf_center=nf_center,
            diagnostics=dict(
                port_axes=port_axes,
                n_instances=len(patches) + len(horns),
            ),
        )
    except Exception as e:
        return SolverPrepared(False, f"Multi-patch prepare failed: {e}")


def run_prepared_multi_patch_3d(
    prepared: SolverPrepared,
    *,
    frequency_hz: float,
    verbose: int = 1,
    progress_cb=None,
    abort_cb=None,
    run=None,
) -> FDTDSolverResult:
    """Run the scene; full-sphere dBi grid at the first port's resonance.

    ``progress_cb(steps_done, n_steps_max, e_ratio)`` / ``abort_cb()`` are
    forwarded to :meth:`PreparedSimulation.run`. ``run`` replaces
    ``sim.run`` with another runner of the same simulation that returns
    the same output dict, such as ``parallel.build_explicit_run(sim)``;
    the callbacks apply to ``sim.run`` only."""
    try:
        if not prepared.ok or prepared.sim is None:
            return FDTDSolverResult(False, prepared.message)
        sim = prepared.sim

        t_start = time.perf_counter()
        if run is not None:
            out = run()
        else:
            out = sim.run(progress_cb=progress_cb, abort_cb=abort_cb)
        steps = int(out["steps"])
        wall = time.perf_counter() - t_start  # out["uf"] is on the host
        if out.get("aborted"):
            return FDTDSolverResult(
                False,
                f"Run aborted by user at step {steps}/"
                f"{sim.cfg.n_steps_max} ({wall:.1f}s elapsed)",
                diagnostics={"aborted": True, "steps_done": steps,
                             # a valid resume checkpoint
                             "resume_state": out.get("state")},
            )
        mcells = sim.grid.num_cells * steps / wall / 1e6
        if verbose:
            print(f"FDTD done: {steps} steps, {wall:.2f}s, {mcells:.1f} "
                  f"Mcells/s, energy ratio {float(out['e_ratio']):.2e}")

        all_s11 = [
            port_spectra(sim.port_freqs_hz, out["uf"][pi], out["if_"][pi],
                         sim.dft_dt, z_ref=50.0)
            for pi in range(len(sim.ports))
        ]
        f_res, s11_db_res = find_resonance(all_s11[0], frequency_hz)

        fi = int(np.argmin(np.abs(sim.nf_freqs_hz - f_res)))
        theta = np.asarray(prepared.theta)
        phi = np.asarray(prepared.phi)
        ff = nf2ff_transform(
            sim.faces,
            select_face_freqs(out["nf_e"], fi),
            select_face_freqs(out["nf_h"], fi),
            sim.dft_dt,
            sim.nf_freqs_hz[fi : fi + 1],
            theta,
            phi,
            center_m=prepared.nf_center,
            device=sim.device,
        )
        rad_eff, rad_eff_conv = radiation_efficiency(
            ff, all_s11, float(out["e_ratio"])
        )
        return FDTDSolverResult(
            True,
            f"Multi-patch 3D pattern computed on {sim.device}",
            theta=np.deg2rad(theta),
            phi=np.deg2rad(phi),
            intensity=ff.intensity_dbi(0),
            is_dBi=True,
            freq=all_s11[0].freq_hz,
            s11=all_s11[0].s11,
            z_in=all_s11[0].z_in,
            f_res_hz=f_res,
            Dmax=float(ff.Dmax[0]),
            radiated_power_w=float(ff.P_rad[0]),
            radiation_efficiency=rad_eff,
            steps_run=steps,
            wall_time_s=wall,
            mcells_per_s=mcells,
            diagnostics={
                "s11_db_at_res": s11_db_res,
                "s11_all_ports": [sp.s11 for sp in all_s11],
                "nf2ff_freq_hz": float(sim.nf_freqs_hz[fi]),
                "energy_ratio": float(out["e_ratio"]),
                "rad_eff_converged": rad_eff_conv,
                "device": str(sim.device),
            },
        )
    except Exception as e:
        return FDTDSolverResult(False, f"Multi-patch run failed: {e}")


# Reference-parity aliases
prepare_openems_microstrip_multi_3d = prepare_multi_patch_3d
run_prepared_openems_microstrip_multi_3d = run_prepared_multi_patch_3d
