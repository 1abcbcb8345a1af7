"""Microstrip-fed patch antenna solver on PyTorch.

Counterpart of ``fdtd_solver_antennas_tpu/solvers/microstrip.py``: the
reference's PCB-style patch with a 50 Ω microstrip feed (Wheeler width
synthesis, 4 feed directions, substrate sized patch + 30 mm margin + feed
length), fed either by a lumped port bridging patch and ground at the
feed edge (``port_mode="lumped"``, the reference contract) or by an MSL
port on the feed strip with 3-probe deembedding (``port_mode="msl"``);
S11 with the uf_ref/uf_inc contract and NF2FF at the resonance on
θ = 0..180° / φ = {0°, 90°}.

``device`` chooses where the run steps: 'cuda' launches the CUDA kernels,
'cpu' runs their plain PyTorch twins.
"""

from __future__ import annotations

import math
from enum import Enum
from typing import Tuple

import numpy as np

from ..models.params import PatchAntennaParams
from ..models.scene import MSLPortSpec, Scene
from ..ops.fdtd import FDTDConfig, build_simulation
from ..ops.mesh import MeshBuilder
from ..physics import C0, design_patch_for_frequency, substrate_conductivity
from ..post.ports import msl_port_spectra
from ..utils.tracing import span, traced
from .base import FDTDSolverResult, SolverPrepared, SolverProbe
from .patch_fixed import lumped_port_spectra, probe_fdtd, run_single_port


class FeedDirection(str, Enum):
    """Microstrip feed direction."""

    POS_X = "+X"
    NEG_X = "-X"
    POS_Y = "+Y"
    NEG_Y = "-Y"


def calculate_microstrip_width(
    freq_hz: float, eps_r: float, h_m: float, z0: float = 50.0
) -> float:
    """Microstrip width for a target Z0 via Wheeler's synthesis equations."""
    if z0 < 44.0:
        A = (z0 / 60.0) * math.sqrt((eps_r + 1.0) / 2.0) + (
            (eps_r - 1.0) / (eps_r + 1.0)
        ) * (0.23 + 0.11 / eps_r)
        w_h = 8.0 * math.exp(A) / (math.exp(2.0 * A) - 2.0)
    else:
        B = 377.0 * math.pi / (2.0 * z0 * math.sqrt(eps_r))
        w_h = (2.0 / math.pi) * (
            B
            - 1.0
            - math.log(2.0 * B - 1.0)
            + ((eps_r - 1.0) / (2.0 * eps_r))
            * (math.log(B - 1.0) + 0.39 - 0.61 / eps_r)
        )
    return w_h * h_m


def probe_openems_microstrip(device="cuda") -> SolverProbe:
    """Capability check under the reference's name: can the engine run on
    ``device``?"""
    return probe_fdtd(device)


def build_microstrip_scene(
    params: PatchAntennaParams,
    feed_direction: FeedDirection,
    feed_line_length_mm: float,
    mesh_res_mm: float,
    port_mode: str = "lumped",
) -> Tuple[Scene, MeshBuilder, dict]:
    """Shared geometry builder for the microstrip solvers.

    Returns (scene, mesh builder, info) where info holds patch/substrate
    dimensions in mm. ``port_mode`` "lumped" bridges patch and ground at
    the feed edge; "msl" puts an MSL port on the feed strip, which needs a
    feed line long enough to keep the measurement plane ≥ 3 mm beyond the
    excitation plane (a shorter one raises).
    """
    f0 = params.frequency_hz
    if params.patch_length_m and params.patch_width_m:
        patch_L = params.patch_length_m * 1e3
        patch_W = params.patch_width_m * 1e3
    else:
        L_m, W_m, _ = design_patch_for_frequency(f0, params.eps_r, params.h_m)
        patch_L = L_m * 1e3
        patch_W = W_m * 1e3
    h = params.h_m * 1e3
    feed_width = calculate_microstrip_width(f0, params.eps_r, params.h_m) * 1e3
    margin = 30.0
    fl = float(feed_line_length_mm)

    if feed_direction in (FeedDirection.POS_X, FeedDirection.NEG_X):
        sub_W = patch_W + 2 * margin + fl
        sub_L = patch_L + 2 * margin
    else:
        sub_W = patch_W + 2 * margin
        sub_L = patch_L + 2 * margin + fl

    air = 50.0
    box_x = sub_W + 2 * air
    box_y = sub_L + 2 * air
    box_z = 160.0

    kappa = substrate_conductivity(f0, params.eps_r, params.loss_tangent)
    scene = Scene()
    scene.add_material_box(
        "substrate", params.eps_r, kappa,
        [-sub_W / 2, -sub_L / 2, 0.0], [sub_W / 2, sub_L / 2, h], priority=0,
    )
    scene.add_metal_box(
        "ground", [-sub_W / 2, -sub_L / 2, 0.0], [sub_W / 2, sub_L / 2, 0.0],
        priority=10,
    )
    scene.add_metal_box(
        "patch", [-patch_W / 2, -patch_L / 2, h], [patch_W / 2, patch_L / 2, h],
        priority=10,
    )

    # feed strip geometry + port feed point at the patch edge center
    if feed_direction == FeedDirection.NEG_X:
        feed_lo = [-sub_W / 2, -feed_width / 2, h]
        feed_hi = [-patch_W / 2, feed_width / 2, h]
        feed_px, feed_py = -patch_W / 2, 0.0
    elif feed_direction == FeedDirection.POS_X:
        feed_lo = [patch_W / 2, -feed_width / 2, h]
        feed_hi = [sub_W / 2, feed_width / 2, h]
        feed_px, feed_py = patch_W / 2, 0.0
    elif feed_direction == FeedDirection.NEG_Y:
        feed_lo = [-feed_width / 2, -sub_L / 2, h]
        feed_hi = [feed_width / 2, -patch_L / 2, h]
        feed_px, feed_py = 0.0, -patch_L / 2
    else:
        feed_lo = [-feed_width / 2, patch_L / 2, h]
        feed_hi = [feed_width / 2, sub_L / 2, h]
        feed_px, feed_py = 0.0, patch_L / 2
    scene.add_metal_box("feed_line", feed_lo, feed_hi, priority=10)

    msl_positions = None
    if port_mode == "msl":
        # distributed microstrip-line port on the feed strip: excitation
        # near the substrate edge, measurement plane further inboard
        if feed_direction in (FeedDirection.NEG_X, FeedDirection.POS_X):
            prop = "x"
            edge = -sub_W / 2 if feed_direction == FeedDirection.NEG_X else sub_W / 2
            inward = 1.0 if feed_direction == FeedDirection.NEG_X else -1.0
        else:
            prop = "y"
            edge = -sub_L / 2 if feed_direction == FeedDirection.NEG_Y else sub_L / 2
            inward = 1.0 if feed_direction == FeedDirection.NEG_Y else -1.0
        exc = edge + inward * 3.0
        meas = edge + inward * min(10.0, fl / 2)
        # the 3-probe stencil must sit clear of the soft-source
        # discontinuity, else Z_L/β come out wrong with no error
        if inward * (meas - exc) < 3.0:
            raise ValueError(
                f"feed_line_length_mm={fl:g} is too short for the MSL "
                "3-probe deembedding (measurement plane must sit ≥3 mm "
                "beyond the excitation plane); lengthen the feed line "
                "or use port_mode='lumped'"
            )
        scene.add_msl_port(MSLPortSpec(
            port_id=1, prop_axis=prop, strip_center_mm=0.0,
            strip_width_mm=feed_width, height_mm=h,
            exc_pos_mm=exc, meas_pos_mm=meas, z0_ohm=50.0, excite=1.0,
        ))
        msl_positions = (prop, exc, meas)
    else:
        scene.add_lumped_port(
            1, 50.0, [feed_px, feed_py, 0.0], [feed_px, feed_py, h],
            direction="z", excite=1.0,
        )

    mb = MeshBuilder()
    mb.add_line("x", [-box_x / 2, box_x / 2])
    mb.add_line("y", [-box_y / 2, box_y / 2])
    mb.add_line("z", [-box_z / 3, box_z * 2 / 3])
    mb.add_line("z", np.linspace(0.0, h, 5))
    mb.add_metal_edges(
        [-sub_W / 2, -sub_L / 2, 0.0], [sub_W / 2, sub_L / 2, 0.0], dirs="xy"
    )
    mb.add_metal_edges(
        [-patch_W / 2, -patch_L / 2, h], [patch_W / 2, patch_L / 2, h],
        dirs="xy", metal_edge_res=mesh_res_mm / 2,
    )
    mb.add_metal_edges(feed_lo, feed_hi, dirs="xy", metal_edge_res=mesh_res_mm / 2)
    mb.add_line("x", [float(feed_px)])
    mb.add_line("y", [float(feed_py)])
    if msl_positions is not None:
        prop, exc, meas = msl_positions
        mb.add_line(prop, [float(exc), float(meas)])
    if feed_direction in (FeedDirection.NEG_X, FeedDirection.POS_X):
        mb.add_line("y", [-feed_width / 2, 0.0, feed_width / 2])
    else:
        mb.add_line("x", [-feed_width / 2, 0.0, feed_width / 2])

    info = dict(
        patch_L=patch_L, patch_W=patch_W, h=h, sub_W=sub_W, sub_L=sub_L,
        feed_width=feed_width,
    )
    return scene, mb, info


def microstrip_port_freqs(f0: float) -> np.ndarray:
    """The S11 sweep of the microstrip solvers: 201 points up to 1.3·f0
    from max(0.1 GHz, 0.7·f0), clamped to 0.9·f0 so the sweep always
    ascends and contains f0 (the reference's max(1 GHz, 0.7·f0) floor
    gives a descending sweep for sub-GHz antennas)."""
    return np.linspace(min(max(1e8, 0.7 * f0), 0.9 * f0), f0 * 1.3, 201)


@traced("fdtd.prepare")
def prepare_at_mesh(
    params: PatchAntennaParams,
    mesh_res: float,
    theta: np.ndarray,
    phi: np.ndarray,
    label: str,
    *,
    device,
    feed_direction,
    feed_line_length_mm: float,
    boundary: str,
    port_mode: str,
    verbose: int,
    n_steps_max: int,
    end_criteria: float,
) -> SolverPrepared:
    """The microstrip patch meshed at ``mesh_res`` mm (graded at ratio
    1.4) and its simulation on ``device``, the far field sampled at
    ``theta``/``phi`` (degrees) about the substrate's middle: the prepare
    the microstrip solvers share; ``label`` names the solver in its
    message. Raises on failure."""
    f0 = params.frequency_hz
    feed_direction = FeedDirection(feed_direction)
    with span("fdtd.prepare.scene"):  # the scene, its feed width, its mesh
        scene, mb, info = build_microstrip_scene(
            params, feed_direction, feed_line_length_mm, mesh_res,
            port_mode=port_mode,
        )
        grid = mb.build(mesh_res, ratio=1.4)
    cfg = FDTDConfig(
        n_steps_max=n_steps_max, end_criteria=end_criteria, boundary=boundary
    )
    sim = build_simulation(
        scene, grid, f0=f0, fc=f0 / 2.0, cfg=cfg, device=device,
        port_freqs_hz=microstrip_port_freqs(f0),
    )
    if verbose:
        print(
            f"{label} prepared: grid {grid.shape} ({grid.num_cells} cells), "
            f"feed {feed_direction.value}, w={info['feed_width']:.2f} mm, "
            f"device {sim.device}"
        )
    return SolverPrepared(
        True,
        f"{label} prepared (feed: {feed_direction.value}, grid {grid.shape})",
        sim=sim,
        theta=theta,
        phi=phi,
        nf_center=np.array([0.0, 0.0, info["h"] / 2000.0]),  # substrate mid, m
        diagnostics=info,
    )


def prepare_microstrip_patch(
    params: PatchAntennaParams,
    *,
    device="cuda",
    feed_direction: FeedDirection = FeedDirection.NEG_X,
    feed_line_length_mm: float = 20.0,
    boundary: str = "MUR",
    theta_step_deg: float = 2.0,
    port_mode: str = "lumped",  # 'lumped' (reference contract) | 'msl'
    verbose: int = 0,
    n_steps_max: int = 30_000,
    end_criteria: float = 1e-4,
) -> SolverPrepared:
    """Build the microstrip-fed patch and its simulation on ``device``
    (λ/20 mesh at f0 + fc), the far field on θ = 0..180° / φ = {0°, 90°}."""
    try:
        f0 = params.frequency_hz
        mesh_res = C0 / (f0 + f0 / 2.0) / 1e-3 / 20.0
        theta = np.arange(0.0, 181.0, max(0.5, float(theta_step_deg)))
        return prepare_at_mesh(
            params, mesh_res, theta, np.array([0.0, 90.0]), "Microstrip patch",
            device=device, feed_direction=feed_direction,
            feed_line_length_mm=feed_line_length_mm, boundary=boundary,
            port_mode=port_mode, verbose=verbose, n_steps_max=n_steps_max,
            end_criteria=end_criteria)
    except Exception as e:
        return SolverPrepared(False, f"Microstrip solver prepare failed: {e}")


def _microstrip_spectra(sim, out):
    if not sim.msl_ports:
        return lumped_port_spectra(sim, out)
    # 3-probe deembedding over the MSL port's rows, which follow any
    # lumped ports (see ops.fdtd.port_probe_sources)
    msl = sim.msl_ports[0]
    base = len(sim.ports)
    return msl_port_spectra(
        sim.port_freqs_hz, out["uf"][base : base + 3],
        out["if_"][base : base + 2], sim.dft_dt, msl.v_pos_m, msl.i_pos_m,
        z0_nominal=msl.z_ref)


def run_prepared_microstrip(
    prepared: SolverPrepared,
    *,
    frequency_hz: float,
    verbose: int = 1,
) -> FDTDSolverResult:
    """Run + port spectra (the MSL deembedding for an MSL port) + NF2FF
    at the resonance."""
    try:
        if not prepared.ok or prepared.sim is None:
            return FDTDSolverResult(False, prepared.message)
        return run_single_port(
            prepared, frequency_hz=frequency_hz,
            message="Microstrip simulation completed successfully",
            spectra_of=_microstrip_spectra, verbose=verbose)
    except Exception as e:
        return FDTDSolverResult(False, f"Microstrip simulation failed: {e}")


# Reference-parity aliases
prepare_openems_microstrip_patch = prepare_microstrip_patch
run_prepared_openems_microstrip = run_prepared_microstrip
