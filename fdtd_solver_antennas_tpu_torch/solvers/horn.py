"""Pyramidal horn antenna FDTD solver on PyTorch.

Counterpart of ``fdtd_solver_antennas_tpu/solvers/horn.py``. Geometry
(axis +z):

- rectangular waveguide section a×b from z = −L_wg to the throat at z = 0,
  4 PEC walls + back short;
- probe feed: a lumped port across the guide height at λg/4 from the back
  short (standard coax-probe placement), exciting TE10;
- four planar flare plates from throat edges to the A×B aperture at z = L.

``device`` chooses where the run steps: 'cuda' launches the CUDA kernels,
'cpu' runs their plain PyTorch twins.
"""

from __future__ import annotations

import math
import time

import numpy as np

from ..models.params import HornAntennaParams
from ..models.scene import PEC, Scene, make_plate
from ..ops.fdtd import FDTDConfig, build_simulation
from ..ops.mesh import MeshBuilder
from ..physics import C0
from ..post.nf2ff import nf2ff_transform, select_face_freqs
from ..post.ports import find_resonance, port_spectra
from .base import FDTDSolverResult, SolverPrepared, radiation_efficiency


def te10_guide_wavelength(f_hz: float, a_m: float) -> float:
    """TE10 guide wavelength; raises below cutoff (fc = c0/2a)."""
    fc = C0 / (2.0 * a_m)
    if f_hz <= fc:
        raise ValueError(
            f"{f_hz / 1e9:.2f} GHz is below the TE10 cutoff "
            f"{fc / 1e9:.2f} GHz for a={a_m * 1e3:.2f} mm"
        )
    lam0 = C0 / f_hz
    return lam0 / math.sqrt(1.0 - (fc / f_hz) ** 2)


def _fresnel(x: float):
    """Fresnel cosine/sine integrals C(x), S(x) = ∫₀ˣ cos/sin(πu²/2) du,
    by fine-grid trapezoid quadrature (|error| ≲ 1e-7 for |x| ≤ 4)."""
    u = np.linspace(0.0, float(x), 4097)
    return (
        float(np.trapezoid(np.cos(np.pi * u**2 / 2), u)),
        float(np.trapezoid(np.sin(np.pi * u**2 / 2), u)),
    )


def pyramidal_horn_directivity_dbi(params: HornAntennaParams,
                                   f_hz: float | None = None) -> float:
    """Pyramidal-horn directivity with quadratic-phase-error loss
    (Balanis, *Antenna Theory* §13.4, eq. 13-52):
    D_P = (πλ²/(32ab))·D_E·D_H with the E-/H-plane sectoral factors as
    Fresnel-integral expressions of the flare slant radii
    R1 = L·B/(B−b), R2 = L·A/(A−a)."""
    f = float(f_hz if f_hz is not None else params.frequency_hz)
    lam = C0 / f
    A, B = params.aperture_A_m, params.aperture_B_m
    a, b = params.throat_a_m, params.throat_b_m
    L = params.length_m
    if A <= a or B <= b:
        raise ValueError("aperture must exceed the throat in both planes")
    R1 = L * B / (B - b)   # E-plane slant radius (from the flare apex)
    R2 = L * A / (A - a)   # H-plane
    CE, SE = _fresnel(B / math.sqrt(2 * lam * R1))
    DE = 64 * a * R1 / (math.pi * lam * B) * (CE**2 + SE**2)
    u = (math.sqrt(lam * R2) / A + A / math.sqrt(lam * R2)) / math.sqrt(2)
    v = (math.sqrt(lam * R2) / A - A / math.sqrt(lam * R2)) / math.sqrt(2)
    Cu, Su = _fresnel(u)
    Cv, Sv = _fresnel(v)
    DH = 4 * math.pi * b * R2 / (lam * A) * ((Cu - Cv) ** 2 + (Su - Sv) ** 2)
    DP = math.pi * lam**2 / (32 * a * b) * DE * DH
    return float(10 * math.log10(DP))


def horn_local_geometry(params: HornAntennaParams, mesh_res_mm: float):
    """Local-frame (horn axis +z, throat at z=0) geometry parts, in mm.

    Returns a dict with PEC wall ``boxes`` [(lo, hi), …], flare plate
    ``quads`` [(4,3) arrays], the feed ``port_line`` (p0, p1) along local y,
    wall thickness ``t``, and the key mesh coordinates per axis. Shared by
    the horn solver and the multi-instance scene solver.
    """
    f0 = params.frequency_hz
    a = params.throat_a_m * 1e3  # mm, broad (x)
    b = params.throat_b_m * 1e3  # narrow (y)
    A = params.aperture_A_m * 1e3
    B = params.aperture_B_m * 1e3
    L = params.length_m * 1e3

    lam_g = te10_guide_wavelength(f0, params.throat_a_m) * 1e3
    L_wg = 0.75 * lam_g
    z_feed = -L_wg + 0.25 * lam_g
    t = max(1.0, mesh_res_mm)  # wall thickness ≥ one cell (no leaks)

    # waveguide walls (outside the a×b cavity) + back short
    boxes = [
        ([-a / 2 - t, -b / 2 - t, -L_wg], [-a / 2, b / 2 + t, 0]),
        ([a / 2, -b / 2 - t, -L_wg], [a / 2 + t, b / 2 + t, 0]),
        ([-a / 2, -b / 2 - t, -L_wg], [a / 2, -b / 2, 0]),
        ([-a / 2, b / 2, -L_wg], [a / 2, b / 2 + t, 0]),
        ([-a / 2 - t, -b / 2 - t, -L_wg - t], [a / 2 + t, b / 2 + t, -L_wg]),
    ]
    # flare plates (planar quads for a pyramidal horn)
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
    # probe feed across the guide height (TE10 E-plane)
    port_line = (np.array([0.0, -b / 2, z_feed]),
                 np.array([0.0, b / 2, z_feed]))
    mesh_lines = dict(
        x=[-a / 2, a / 2, -A / 2, A / 2, 0.0],
        y=[-b / 2, b / 2, -B / 2, B / 2, 0.0],
        z=[-L_wg - t, -L_wg, 0.0, L, float(z_feed)],
    )
    return dict(
        boxes=boxes, quads=quads, port_line=port_line, t=t,
        mesh_lines=mesh_lines, L_wg=L_wg, z_feed=z_feed, lam_g=lam_g,
        a=a, b=b, A=A, B=B, L=L,
    )


def prepare_horn(
    params: HornAntennaParams,
    *,
    device="cuda",
    boundary: str = "MUR",
    theta_step_deg: float = 2.0,
    phi_step_deg: float = 5.0,
    mesh_ppw: float = 15.0,
    n_steps_max: int = 20_000,
    end_criteria: float = 1e-4,
    verbose: int = 0,
) -> SolverPrepared:
    """Build the horn scene and its simulation on ``device``."""
    try:
        f0 = params.frequency_hz
        fc_src = f0 / 2.0
        mesh_res = C0 / (f0 + fc_src) / 1e-3 / mesh_ppw
        geo = horn_local_geometry(params, mesh_res)
        a, b, A, B, L = geo["a"], geo["b"], geo["A"], geo["B"], geo["L"]
        L_wg, z_feed, t, lam_g = (
            geo["L_wg"], geo["z_feed"], geo["t"], geo["lam_g"]
        )

        scene = Scene()
        for bi, (lo, hi) in enumerate(geo["boxes"]):
            scene.add_metal_box(f"wg_{bi}", lo, hi, priority=10)
        pec = PEC("flare")
        for q in geo["quads"]:
            scene.add_polyhedron(make_plate(q, t, pec, priority=10))
        scene.add_lumped_port(
            1, 50.0, geo["port_line"][0], geo["port_line"][1],
            direction="y", excite=1.0,
        )

        # simulation box
        lam0 = C0 / f0 * 1e3
        m_xy = 0.75 * lam0
        mb = MeshBuilder()
        mb.add_line("x", [-A / 2 - m_xy, A / 2 + m_xy, -a / 2, a / 2,
                          -A / 2, A / 2, 0.0])
        mb.add_line("y", [-B / 2 - m_xy, B / 2 + m_xy, -b / 2, b / 2,
                          -B / 2, B / 2, 0.0])
        mb.add_line("z", [-L_wg - t - 0.5 * lam0, L + 1.25 * lam0,
                          -L_wg, 0.0, L, float(z_feed)])
        grid = mb.build(mesh_res, ratio=1.4)

        cfg = FDTDConfig(
            n_steps_max=n_steps_max, end_criteria=end_criteria,
            boundary=boundary,
        )
        sim = build_simulation(
            scene, grid, f0=f0, fc=fc_src, cfg=cfg, device=device,
            port_freqs_hz=np.linspace(f0 * 0.7, f0 * 1.3, 201),
        )

        theta = np.arange(0.0, 181.0, max(0.5, theta_step_deg))
        phi = np.arange(0.0, 360.0, max(1.0, phi_step_deg))
        nf_center = np.array([0.0, 0.0, L / 2.0]) * 1e-3

        if verbose:
            print(
                f"horn prepared: a×b {a:.1f}×{b:.1f}, A×B {A:.1f}×{B:.1f}, "
                f"L {L:.1f} mm, λg {lam_g:.1f} mm, grid {grid.shape} "
                f"({grid.num_cells} cells) on {sim.device}; engine path: "
                f"{sim.pallas_mode_reason}"
            )
        return SolverPrepared(
            True,
            f"Horn prepared on {sim.device} (grid {grid.shape}, "
            f"{grid.num_cells} cells)",
            sim=sim,
            theta=theta,
            phi=phi,
            nf_center=nf_center,
        )
    except Exception as e:
        return SolverPrepared(False, f"Horn prepare failed: {e}")


def run_prepared_horn(
    prepared: SolverPrepared,
    *,
    frequency_hz: float,
    verbose: int = 1,
) -> FDTDSolverResult:
    try:
        if not prepared.ok or prepared.sim is None:
            return FDTDSolverResult(False, prepared.message)
        sim = prepared.sim
        t_start = time.perf_counter()
        out = sim.run()
        steps = int(out["steps"])
        wall = time.perf_counter() - t_start  # out["uf"] is on the host

        spectra = port_spectra(
            sim.port_freqs_hz, out["uf"][0], out["if_"][0], sim.dft_dt,
            z_ref=50.0,
        )
        f_res, s11_db_res = find_resonance(spectra, frequency_hz)
        # pattern, Dmax and P_rad at the frequency the result reports
        fi = int(np.argmin(np.abs(sim.nf_freqs_hz - f_res)))
        theta = np.asarray(prepared.theta)
        phi = np.asarray(prepared.phi)
        ff = nf2ff_transform(
            sim.faces, select_face_freqs(out["nf_e"], fi),
            select_face_freqs(out["nf_h"], fi), sim.dft_dt,
            sim.nf_freqs_hz[fi : fi + 1], theta, phi,
            center_m=prepared.nf_center, device=sim.device,
        )
        rad_eff, rad_eff_conv = radiation_efficiency(
            ff, spectra, float(out["e_ratio"])
        )
        mcells = sim.grid.num_cells * steps / wall / 1e6
        if verbose:
            print(f"horn FDTD done: {steps} steps, {wall:.2f}s, "
                  f"{mcells:.1f} Mcells/s")
        return FDTDSolverResult(
            True,
            f"Horn simulation completed on {sim.device}",
            theta=np.deg2rad(theta),
            phi=np.deg2rad(phi),
            intensity=ff.intensity_dbi(0),
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
                "s11_db_at_res": s11_db_res,
                "nf2ff_freq_hz": float(sim.nf_freqs_hz[fi]),
                "energy_ratio": float(out["e_ratio"]),
                "rad_eff_converged": rad_eff_conv,
                "device": str(sim.device),
            },
        )
    except Exception as e:
        return FDTDSolverResult(False, f"Horn run failed: {e}")
