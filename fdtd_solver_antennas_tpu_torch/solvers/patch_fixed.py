"""Canonical 3D patch solver ("fixed" solver parity) on PyTorch.

Counterpart of ``fdtd_solver_antennas_tpu/solvers/patch_fixed.py``: the
reference's tutorial-faithful scene and run budget on the port's engine:

- air box 200×200×150 mm with the z-split at −⅓/+⅔
- 60×60 mm substrate, 4 cells across its thickness
- PEC patch (designed or user L/W) and same-size ground plane
- coax-style lumped port at x = −6 mm, R = 50 Ω, z-directed
- Gaussian excitation f0, fc = f0/2; MUR walls; NrTS 30000, EndCriteria 1e-4
- mesh λ/20 with metal-edge refinement λ/40
- NF2FF θ = 0..178° step 2°, φ = {0°, 90°}, center (0,0,1 mm)

``device`` chooses where the run steps: 'cuda' launches the CUDA kernels,
'cpu' runs their plain PyTorch twins.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..models.params import PatchAntennaParams
from ..models.scene import Scene
from ..ops.fdtd import FDTDConfig, build_simulation, resolve_device
from ..ops.mesh import MeshBuilder
from ..physics import C0, design_patch_for_frequency, substrate_conductivity
from ..post.nf2ff import nf2ff_transform, select_face_freqs
from ..post.ports import find_resonance, port_spectra
from .base import FDTDSolverResult, SolverPrepared, SolverProbe, radiation_efficiency


def probe_fdtd(device="cuda") -> SolverProbe:
    """Capability check: can the engine run on ``device``?"""
    try:
        dev = resolve_device(device)
    except (RuntimeError, ValueError) as e:
        return SolverProbe(False, f"torch device unavailable: {e}", {})
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    api = {"backend": [dev.type], "devices": [f"{dev} ({name})"]}
    return SolverProbe(True, f"torch device ready: {dev} ({name})", api)


def build_patch_scene(params: PatchAntennaParams, lossy_metal: bool = False):
    """The canonical scene and its graded mesh: ``(scene, grid, f0, fc)``."""
    f0 = params.frequency_hz
    fc = f0 / 2.0

    if params.patch_length_m and params.patch_width_m:
        patch_W = params.patch_width_m * 1e3  # x (resonant) dimension, mm
        patch_L = params.patch_length_m * 1e3  # y dimension, mm
    else:
        L_m, W_m, _ = design_patch_for_frequency(f0, params.eps_r, params.h_m)
        patch_W = W_m * 1e3
        patch_L = L_m * 1e3

    h = params.h_m * 1e3
    sub_W = 60.0
    sub_L = 60.0
    substrate_cells = 4
    feed_pos = -6.0
    feed_R = 50.0
    sim_box = np.array([200.0, 200.0, 150.0])
    kappa = substrate_conductivity(f0, params.eps_r, params.loss_tangent)

    scene = Scene()
    scene.add_material_box(
        "substrate", params.eps_r, kappa,
        [-sub_W / 2, -sub_L / 2, 0.0], [sub_W / 2, sub_L / 2, h], priority=0,
    )
    if lossy_metal:
        from ..physics import sheet_conductance

        sig_s = sheet_conductance(
            params.metal.conductivity_s_per_m, params.metal.thickness_m, f0
        )

        def add_metal(name, lo, hi):
            scene.add_conductive_sheet(name, sig_s, lo, hi, priority=10)
    else:
        def add_metal(name, lo, hi):
            scene.add_metal_box(name, lo, hi, priority=10)
    add_metal(
        "patch",
        [-patch_W / 2, -patch_L / 2, h], [patch_W / 2, patch_L / 2, h],
    )
    add_metal(
        "gnd",
        [-sub_W / 2, -sub_L / 2, 0.0], [sub_W / 2, sub_L / 2, 0.0],
    )
    scene.add_lumped_port(
        1, feed_R, [feed_pos, 0.0, 0.0], [feed_pos, 0.0, h],
        direction="z", excite=1.0,
    )

    mesh_res = C0 / (f0 + fc) / 1e-3 / 20.0  # λ/20 in mm
    mb = MeshBuilder()
    mb.add_line("x", [-sim_box[0] / 2, sim_box[0] / 2])
    mb.add_line("y", [-sim_box[1] / 2, sim_box[1] / 2])
    mb.add_line("z", [-sim_box[2] / 3, sim_box[2] * 2 / 3])
    mb.add_metal_edges(
        [-patch_W / 2, -patch_L / 2, h], [patch_W / 2, patch_L / 2, h],
        dirs="xy", metal_edge_res=mesh_res / 2,
    )
    mb.add_metal_edges(
        [-sub_W / 2, -sub_L / 2, 0.0], [sub_W / 2, sub_L / 2, 0.0], dirs="xy"
    )
    mb.add_line("z", np.linspace(0.0, h, substrate_cells + 1))
    mb.add_line("x", [feed_pos])
    mb.add_line("y", [0.0])
    grid = mb.build(mesh_res, ratio=1.4)
    return scene, grid, f0, fc


def prepare_patch_fixed(
    params: PatchAntennaParams,
    *,
    device="cuda",
    verbose: int = 0,
    n_steps_max: int = 30_000,
    end_criteria: float = 1e-4,
    boundary: str = "MUR",
    lossy_metal: bool = False,
) -> SolverPrepared:
    """Build the canonical patch scene and its simulation on ``device``.

    ``lossy_metal=True`` models the patch and ground as finite-conductivity
    sheets of ``params.metal`` instead of PEC.
    """
    try:
        scene, grid, f0, fc = build_patch_scene(params, lossy_metal)
        cfg = FDTDConfig(
            n_steps_max=n_steps_max,
            end_criteria=end_criteria,
            boundary=boundary,
        )
        sim = build_simulation(scene, grid, f0=f0, fc=fc, cfg=cfg,
                               device=device)

        theta = np.arange(0.0, 180.0, 2.0)  # degrees
        phi = np.array([0.0, 90.0])
        nf_center = np.array([0.0, 0.0, 1e-3])  # meters

        if verbose:
            print(f"grid {grid.shape} = {grid.num_cells} cells, dt={sim.dt:.3e}s, "
                  f"device {sim.device}")

        return SolverPrepared(
            True,
            f"fixed solver prepared on {sim.device} (grid {grid.shape}, "
            f"{grid.num_cells} cells)",
            sim=sim,
            theta=theta,
            phi=phi,
            nf_center=nf_center,
        )
    except Exception as e:
        return SolverPrepared(False, f"Fixed solver prepare failed: {e}")


def run_prepared_fixed(
    prepared: SolverPrepared,
    *,
    frequency_hz: float,
    verbose: int = 1,
    progress_cb=None,
    abort_cb=None,
) -> FDTDSolverResult:
    """Run the prepared simulation and extract the dBi pattern grid:
    NF2FF at the resonance, dBi via 20·log10(E/Emax) + 10·log10(Dmax),
    plus the S11 sweep from the port DFTs."""
    try:
        if not prepared.ok or prepared.sim is None:
            return FDTDSolverResult(False, prepared.message)
        sim = prepared.sim

        t_start = time.perf_counter()
        out = sim.run(progress_cb=progress_cb, abort_cb=abort_cb)
        steps = int(out["steps"])
        wall = time.perf_counter() - t_start  # out["uf"] is on the host
        if out.get("aborted"):
            return FDTDSolverResult(
                False,
                f"Run aborted by user at step {steps}/"
                f"{sim.cfg.n_steps_max} ({wall:.1f}s elapsed)",
                diagnostics={"aborted": True, "steps_done": steps},
            )
        mcells = sim.grid.num_cells * steps / wall / 1e6

        if verbose:
            print(
                f"FDTD done: {steps} steps, {wall:.2f}s, {mcells:.1f} Mcells/s, "
                f"energy ratio {float(out['e_ratio']):.2e}"
            )

        spectra = port_spectra(
            sim.port_freqs_hz, out["uf"][0], out["if_"][0],
            sim.dft_dt, z_ref=sim.ports[0].spec.resistance,
        )
        f_res, s11_db = find_resonance(spectra, frequency_hz)

        # NF2FF at the accumulated frequency nearest the resonance
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
        intensity_db = ff.intensity_dbi(0)

        rad_eff, rad_eff_conv = radiation_efficiency(
            ff, spectra, float(out["e_ratio"])
        )
        return FDTDSolverResult(
            True,
            f"FDTD completed on {sim.device}",
            theta=np.deg2rad(theta),
            phi=np.deg2rad(phi),
            intensity=intensity_db,
            is_dBi=True,
            freq=spectra.freq_hz,
            s11=spectra.s11,
            z_in=spectra.z_in,
            f_res_hz=f_res,
            Dmax=float(ff.Dmax[0]),
            radiated_power_w=float(ff.P_rad[0]),
            radiation_efficiency=rad_eff,
            steps_run=steps,
            wall_time_s=wall,
            mcells_per_s=mcells,
            diagnostics={
                "s11_db_at_res": s11_db,
                "nf2ff_freq_hz": float(sim.nf_freqs_hz[fi]),
                "energy_ratio": float(out["e_ratio"]),
                "rad_eff_converged": rad_eff_conv,
                "device": str(sim.device),
            },
        )
    except Exception as e:
        return FDTDSolverResult(False, f"Fixed run failed: {e}")


# Reference-parity aliases (antenna_sim names)
probe_openems_fixed = probe_fdtd
prepare_openems_patch_fixed = prepare_patch_fixed
run_prepared_openems_fixed = run_prepared_fixed
