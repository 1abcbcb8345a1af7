"""Batched geometry sweeps: many designs, every launch for all of them.

Counterpart of ``fdtd_solver_antennas_tpu/solvers/sweep.py``. The
reference explores designs by serially re-preparing and re-running its
C++ engine per variant. Here every variant is voxelized onto one *shared
grid* (the union of all variants' mesh-refinement lines), so geometry
differences live purely in the ca/cb coefficient arrays. Those are
stacked on a leading variant axis, and the chunked time loop runs all
variants at once (``ops/fdtd.py::run_batched``) in the mode the base
simulation resolves (``ops/fdtd.py::resolve_pallas_mode``), as the JAX
package's vmapped run keeps its base's kernel:

- chunk mode (the union grid's working set fits the L2, as at the
  8-variant canonical sweep and the tests' patches and horns): one
  ``chunk_steps_batch`` launch per termination chunk steps every variant
  (K1 batched, the JAX package's chunk kernel under ``jax.vmap``);
- stream mode (a union grid that spills the L2, or ``pallas_mode=
  "stream"``): one ``stream_steps_batch`` launch per T steps and one
  ``probe_gather_batch`` per probe interval (K2 batched, its
  ``coef_ops_from`` form under ``jax.vmap``), the probe decimation
  rounded down to a multiple of T as the JAX base rounds it.

``parallel.shard_sweep(prepared, mesh)`` spreads the variants over the
ranks of a process group (``parallel/sweep_shard.py``): each rank runs
its sweep group's share and every rank gets every variant's results.

Early exit: each variant stops on its own. After every chunk each
variant's energy ratio is checked; a variant that meets the criterion is
frozen at that chunk (its step count, fields, DFT sums and ratio stay as
they were), as ``jax.vmap`` of the JAX package's ``lax.while_loop``
computes it: the batched loop keeps a member whose condition is false.
The run ends when every variant has stopped or at ``n_steps_max``.

``device`` chooses where the sweep steps: 'cuda' launches the kernel,
'cpu' runs its plain PyTorch twin.
"""

from __future__ import annotations

import dataclasses
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..models.params import HornAntennaParams, PatchAntennaParams
from ..models.scene import PEC, Box, Scene, make_plate
from ..ops.fdtd import FDTDConfig, build_simulation, run_batched
from ..ops.mesh import MeshBuilder
from ..ops.voxelize import _edge_axes, _inflated_bounds
from ..physics import C0, design_patch_for_frequency, substrate_conductivity
from ..post.nf2ff import nf2ff_transform_batch
from ..post.ports import PortSpectra, find_resonance, port_spectra
from ..utils.tracing import span, traced
from .horn import horn_local_geometry

_COMPS = ("ex", "ey", "ez")


@dataclasses.dataclass
class SweepPrepared:
    ok: bool
    message: str
    sim: object = None  # base PreparedSimulation (variant 0, or the naked scene)
    batched_coeffs: Optional[Dict[str, torch.Tensor]] = None  # (B, X, Y, Z)
    variants: Optional[List] = None  # PatchAntennaParams | HornAntennaParams
    # far-field post-processing inputs (horn sweeps)
    theta: Optional[np.ndarray] = None  # degrees
    phi: Optional[np.ndarray] = None  # degrees
    nf_centers: Optional[List[np.ndarray]] = None  # per-variant, meters
    # sweep-level sharding (``parallel/sweep_shard.py``): the rows past
    # len(variants) are padding, dropped before post-processing; the mesh
    # whose sweep group's share ``batched_coeffs`` holds
    _sweep_pad: int = 0
    _sweep_mesh: object = None


@dataclasses.dataclass
class SweepResult:
    ok: bool
    message: str
    spectra: Optional[List[PortSpectra]] = None
    f_res_hz: Optional[np.ndarray] = None
    s11_min_db: Optional[np.ndarray] = None
    Dmax_dbi: Optional[np.ndarray] = None  # horn sweeps: per-variant gain
    steps_run: int = 0  # the most steps any variant ran
    wall_time_s: float = 0.0
    mcells_per_s: float = 0.0
    steps: Optional[np.ndarray] = None  # per variant
    e_ratio: Optional[np.ndarray] = None  # per variant


def _patch_dims_mm(p: PatchAntennaParams):
    if p.patch_length_m and p.patch_width_m:
        return p.patch_width_m * 1e3, p.patch_length_m * 1e3
    L_m, W_m, _ = design_patch_for_frequency(p.frequency_hz, p.eps_r, p.h_m)
    return W_m * 1e3, L_m * 1e3


def _variant_scene(p: PatchAntennaParams, feed_pos: float) -> Scene:
    """Canonical fixed-solver scene for one variant (60×60 substrate)."""
    W, L = _patch_dims_mm(p)
    h = p.h_m * 1e3
    kappa = substrate_conductivity(p.frequency_hz, p.eps_r, p.loss_tangent)
    scene = Scene()
    scene.add_material_box(
        "substrate", p.eps_r, kappa, [-30, -30, 0.0], [30, 30, h], priority=0
    )
    scene.add_metal_box("patch", [-W / 2, -L / 2, h], [W / 2, L / 2, h], 10)
    scene.add_metal_box("gnd", [-30, -30, 0.0], [30, 30, 0.0], 10)
    scene.add_lumped_port(
        1, 50.0, [feed_pos, 0.0, 0.0], [feed_pos, 0.0, h], direction="z"
    )
    return scene


def _patch_axis_masks(comp: str, grid, padded_shape,
                      W: float, L: float, h: float):
    """Per-axis boolean vectors (padded lengths) whose outer AND equals
    the voxelizer's containment test over the E-edge midpoints for the
    axis-aligned patch sheet [-W/2,-L/2,h]-[W/2,L/2,h] (containment of an
    untransformed box is separable; same inflation: degenerate axes ± the
    sheet tolerance, finite axes ± 1e-9). Pad slots are False."""
    box = Box(PEC("patch"), (-W / 2, -L / 2, h), (W / 2, L / 2, h))
    lo, hi = _inflated_bounds(box)
    out = []
    for a, v in enumerate(_edge_axes(grid, comp)):
        m = np.zeros(padded_shape[a], bool)
        v = np.asarray(v, float)
        m[: len(v)] = (v >= lo[a]) & (v <= hi[a])
        out.append(m)
    return out


def _shared_substrate(variants: Sequence[PatchAntennaParams]) -> bool:
    v0 = variants[0]
    return all(
        v.eps_r == v0.eps_r
        and v.loss_tangent == v0.loss_tangent
        and v.frequency_hz == v0.frequency_hz
        for v in variants
    )


def _batched_coeffs_delta(variants, grid, feed_pos_mm, f0, fc, cfg,
                          port_freqs, nf_freqs, device="cuda"):
    """Sweep coefficients without N full voxelize + build passes.

    Patch-sweep variants share everything except the patch metal sheet
    (substrate, ground and port are identical). So build ONE *naked* sim
    (the scene without the patch box: PEC paint is the coefficient
    builder's last step, so leaving it out leaves exactly the pre-PEC
    ca/cb), then zero each variant's patch edges as a separable per-axis
    mask, on ``device``: the naked arrays are uploaded once, the (B, axis)
    boolean masks are kilobytes, and ``torch.where`` broadcasts the batch,
    so the (B, X, Y, Z) coefficients never exist on the host. Bit-equal to
    each variant's own :func:`build_simulation`.

    Returns ``(base_sim, batched)``: the naked sim carries the shared
    ports, probes, waveform and faces; ``batched`` the ``ca_*``/``cb_*``
    tensors.
    """
    with span("fdtd.prepare.scene"):
        naked = _variant_scene(variants[0], feed_pos_mm)
        naked.boxes = [b for b in naked.boxes if b.prop.name != "patch"]
    sim = build_simulation(
        naked, grid, f0=f0, fc=fc, cfg=cfg, device=device,
        port_freqs_hz=port_freqs, nf_freqs_hz=nf_freqs,
    )
    pshape = sim.padded_shape
    h = variants[0].h_m * 1e3
    batched = {}
    with span("fdtd.prepare.coeffs"):  # the masks; their uploads nest inside
        zero = torch.zeros((), dtype=torch.float32, device=sim.device)
        for comp in _COMPS:
            per_axis = [
                _patch_axis_masks(comp, grid, pshape, *_patch_dims_mm(v), h)
                for v in variants
            ]
            with span("fdtd.prepare.upload"):
                mx, my, mz = (
                    torch.from_numpy(np.stack([pa[a] for pa in per_axis]))
                    .to(sim.device) for a in range(3)
                )
            m = mx[:, :, None, None] & my[:, None, :, None] & mz[:, None, None, :]
            for pre in ("ca_", "cb_"):
                batched[pre + comp] = torch.where(
                    m, zero, sim.coeffs[pre + comp][None])
    return sim, batched


def _stack_coeffs(sims) -> Dict[str, torch.Tensor]:
    return {k: torch.stack([s.coeffs[k] for s in sims]) for k in sims[0].coeffs}


@traced("fdtd.prepare")
def prepare_patch_geometry_sweep(
    variants: Sequence[PatchAntennaParams],
    *,
    feed_pos_mm: float = -6.0,
    n_steps_max: int = 16_000,
    end_criteria: float = 1e-4,
    boundary: str = "MUR",
    pallas_mode: Optional[str] = None,
    device="cuda",
    verbose: int = 0,
) -> SweepPrepared:
    """Build the shared grid + stacked coefficients for a design sweep on
    ``device``.

    All variants must share substrate thickness (the grid's z lines).
    Variants that also share εr, loss and frequency take the delta path
    (:func:`_batched_coeffs_delta`); others are built one by one in
    threads and stacked. ``pallas_mode`` ("chunk", "stream" or None, the
    JAX package's argument) forces the batched run's kernels; None lets
    the base simulation's working set pick them.
    """
    try:
        variants = list(variants)
        if not variants:
            return SweepPrepared(False, "No variants provided.")
        h0 = variants[0].h_m
        if any(abs(v.h_m - h0) > 1e-12 for v in variants):
            return SweepPrepared(
                False, "All sweep variants must share substrate thickness h."
            )
        f0 = max(v.frequency_hz for v in variants)
        fc = f0 / 2.0
        h = h0 * 1e3
        mesh_res = C0 / (f0 + fc) / 1e-3 / 20.0

        # union mesh: every variant's metal edges refine the shared grid
        with span("fdtd.prepare.scene"):
            mb = MeshBuilder()
            mb.add_line("x", [-100.0, 100.0])
            mb.add_line("y", [-100.0, 100.0])
            mb.add_line("z", [-50.0, 100.0])
            mb.add_line("z", np.linspace(0.0, h, 5))
            mb.add_line("x", [feed_pos_mm])
            mb.add_line("y", [0.0])
            mb.add_metal_edges([-30, -30, 0], [30, 30, 0], dirs="xy")
            for v in variants:
                W, L = _patch_dims_mm(v)
                mb.add_metal_edges(
                    [-W / 2, -L / 2, h], [W / 2, L / 2, h], dirs="xy",
                    metal_edge_res=mesh_res / 2,
                )
            grid = mb.build(mesh_res, ratio=1.4)

        cfg = FDTDConfig(
            n_steps_max=n_steps_max, end_criteria=end_criteria,
            boundary=boundary, pallas_mode=pallas_mode,
        )
        port_freqs = np.linspace(max(1e8, f0 * 0.5), f0 * 1.5, 201)
        nf_freqs = np.array([f0])  # sweeps are S11-centric; keep NF light

        if _shared_substrate(variants):
            base, batched = _batched_coeffs_delta(
                variants, grid, feed_pos_mm, f0, fc, cfg,
                port_freqs, nf_freqs, device=device,
            )
        else:
            # general path: per-variant voxelize + coefficient builds are
            # independent and their numpy work releases the GIL
            with ThreadPoolExecutor(max_workers=min(8, len(variants))) as tp:
                sims = list(tp.map(
                    lambda v: build_simulation(
                        _variant_scene(v, feed_pos_mm), grid, f0=f0, fc=fc,
                        cfg=cfg, device=device, port_freqs_hz=port_freqs,
                        nf_freqs_hz=nf_freqs,
                    ),
                    variants,
                ))
            base = sims[0]
            batched = _stack_coeffs(sims)
        if verbose:
            print(
                f"sweep prepared: {len(variants)} variants on shared grid "
                f"{grid.shape} ({grid.num_cells} cells) on {base.device}"
            )
        return SweepPrepared(
            True,
            f"Sweep prepared: {len(variants)} variants, grid {grid.shape}",
            sim=base,
            batched_coeffs=batched,
            variants=variants,
        )
    except Exception as e:
        return SweepPrepared(False, f"sweep prepare failed: {e}")


def _run_batched(prepared: SweepPrepared, impl=None):
    """Run the batched loop; returns ``(out, wall_s, max_steps)``. The wall
    time ends in host reads of the results. A sweep sharded by
    ``parallel.shard_sweep`` runs this rank's share and gathers every
    variant's results (``parallel/sweep_shard.py::run_sweep_share``; the
    padded rows stay in ``out``)."""
    if prepared._sweep_mesh is not None:
        from ..parallel.sweep_shard import run_sweep_share

        return run_sweep_share(prepared, impl)
    t0 = time.perf_counter()
    out = run_batched(prepared.sim, prepared.batched_coeffs, impl)
    wall = time.perf_counter() - t0
    return out, wall, int(np.max(out["steps"]))


def _batched_port_spectra(prepared: SweepPrepared, out) -> List[PortSpectra]:
    """Per-variant port-0 spectra from the batched (B, ports, Nf) DFTs."""
    sim = prepared.sim
    return [
        port_spectra(sim.port_freqs_hz, out["uf"][b, 0], out["if_"][b, 0],
                     sim.dft_dt)
        for b in range(len(prepared.variants))
    ]


def _resonances(spectra, variants):
    f_res, s11_min = [], []
    for sp, v in zip(spectra, variants):
        fr, _ = find_resonance(sp, v.frequency_hz)
        f_res.append(fr)
        s11_min.append(
            float(20 * np.log10(np.maximum(np.abs(sp.s11), 1e-30)).min())
        )
    return np.array(f_res), np.array(s11_min)


def run_patch_geometry_sweep(
    prepared: SweepPrepared, *, verbose: int = 0
) -> SweepResult:
    """Execute the batched sweep; per-variant S11 spectra and resonances."""
    try:
        if not prepared.ok or prepared.sim is None:
            return SweepResult(False, prepared.message)
        sim = prepared.sim
        out, wall, steps = _run_batched(prepared)
        n_var = len(prepared.variants)
        spectra = _batched_port_spectra(prepared, out)
        f_res, s11_min = _resonances(spectra, prepared.variants)
        rate = sim.grid.num_cells * steps * n_var / wall / 1e6
        if verbose:
            print(
                f"sweep: {n_var} variants × {steps} steps in {wall:.2f}s "
                f"→ {rate:.0f} Mcells/s aggregate"
            )
        return SweepResult(
            True,
            f"Sweep completed: {n_var} variants",
            spectra=spectra,
            f_res_hz=f_res,
            s11_min_db=s11_min,
            steps_run=steps,
            wall_time_s=wall,
            mcells_per_s=rate,
            steps=out["steps"][:n_var],
            e_ratio=out["e_ratio"][:n_var],
        )
    except Exception as e:
        return SweepResult(False, f"sweep run failed: {e}")


# ---------------------------------------------------------------------------
# Horn aperture sweeps (beyond-reference: the reference has no horn solver)
# ---------------------------------------------------------------------------

def prepare_horn_aperture_sweep(
    base: HornAntennaParams,
    apertures_mm: Sequence,  # [(A_mm, B_mm, L_mm), ...]
    *,
    mesh_ppw: float = 15.0,
    n_steps_max: int = 16_000,
    end_criteria: float = 1e-4,
    boundary: str = "MUR",
    device="cuda",
    theta_step_deg: float = 5.0,
    phi_step_deg: float = 15.0,
    verbose: int = 0,
) -> SweepPrepared:
    """Batch N pyramidal-horn flare geometries into one batched run.

    All variants share the throat (a×b), waveguide and feed port, so the
    port/probe layout is static across the batch, while the flare plates
    and aperture differ: purely a coefficient-array change on the shared
    grid. Sweeping (A, B, L) is the primary horn design loop (aperture ↔
    gain trade-off).
    """
    try:
        apertures_mm = [tuple(map(float, ap)) for ap in apertures_mm]
        if not apertures_mm:
            return SweepPrepared(False, "No aperture variants provided.")
        variants = [
            dataclasses.replace(
                base, aperture_A_m=A * 1e-3, aperture_B_m=B * 1e-3,
                length_m=L * 1e-3,
            )
            for A, B, L in apertures_mm
        ]
        f0 = base.frequency_hz
        fc = f0 / 2.0
        mesh_res = C0 / (f0 + fc) / 1e-3 / mesh_ppw
        geos = [horn_local_geometry(v, mesh_res) for v in variants]
        g0 = geos[0]  # throat/waveguide/feed identical across variants
        lam0 = C0 / f0 * 1e3
        A_max = max(g["A"] for g in geos)
        B_max = max(g["B"] for g in geos)
        L_max = max(g["L"] for g in geos)
        m_xy = 0.75 * lam0

        mb = MeshBuilder()
        mb.add_line("x", [-A_max / 2 - m_xy, A_max / 2 + m_xy])
        mb.add_line("y", [-B_max / 2 - m_xy, B_max / 2 + m_xy])
        mb.add_line("z", [-g0["L_wg"] - g0["t"] - 0.5 * lam0,
                          L_max + 1.25 * lam0])
        for g in geos:  # union of every variant's feature lines
            for nm, vals in g["mesh_lines"].items():
                mb.add_line(nm, vals)
        grid = mb.build(mesh_res, ratio=1.4)

        cfg = FDTDConfig(
            n_steps_max=n_steps_max, end_criteria=end_criteria,
            boundary=boundary,
        )
        port_freqs = np.linspace(f0 * 0.7, f0 * 1.3, 201)
        nf_freqs = np.array([f0])

        def _scene(g):
            scene = Scene()
            for bi, (lo, hi) in enumerate(g["boxes"]):
                scene.add_metal_box(f"wg_{bi}", lo, hi, priority=10)
            pec = PEC("flare")
            for quad in g["quads"]:
                scene.add_polyhedron(make_plate(quad, g["t"], pec, priority=10))
            scene.add_lumped_port(
                1, 50.0, g["port_line"][0], g["port_line"][1],
                direction="y", excite=1.0,
            )
            return scene

        with ThreadPoolExecutor(max_workers=min(8, len(geos))) as tp:
            sims = list(tp.map(
                lambda g: build_simulation(
                    _scene(g), grid, f0=f0, fc=fc, cfg=cfg, device=device,
                    port_freqs_hz=port_freqs, nf_freqs_hz=nf_freqs,
                ),
                geos,
            ))
        theta = np.arange(0.0, 181.0, max(0.5, theta_step_deg))
        phi = np.arange(0.0, 360.0, max(1.0, phi_step_deg))
        nf_centers = [
            np.array([0.0, 0.0, g["L"] / 2.0]) * 1e-3 for g in geos
        ]
        if verbose:
            print(
                f"horn sweep prepared: {len(variants)} apertures on shared "
                f"grid {grid.shape} ({grid.num_cells} cells) on {sims[0].device}"
            )
        return SweepPrepared(
            True,
            f"Horn sweep prepared: {len(variants)} variants, grid {grid.shape}",
            sim=sims[0],
            batched_coeffs=_stack_coeffs(sims),
            variants=variants,
            theta=theta,
            phi=phi,
            nf_centers=nf_centers,
        )
    except Exception as e:
        return SweepPrepared(False, f"horn sweep prepare failed: {e}")


def run_horn_aperture_sweep(
    prepared: SweepPrepared, *, verbose: int = 0
) -> SweepResult:
    """Execute the batched horn sweep; per-variant S11 + boresight gain."""
    try:
        if not prepared.ok or prepared.sim is None:
            return SweepResult(False, prepared.message)
        sim = prepared.sim
        out, wall, steps = _run_batched(prepared)
        n_var = len(prepared.variants)
        spectra = _batched_port_spectra(prepared, out)
        f_res, s11_min = _resonances(spectra, prepared.variants)
        # one batched NF2FF pass for all variants × frequencies, on the
        # real variants: a sharded sweep pads the batch (shard_sweep), and
        # nf_centers has only n_var rows
        nf_e = [face[:n_var] for face in out["nf_e"]]
        nf_h = [face[:n_var] for face in out["nf_h"]]
        ffs = nf2ff_transform_batch(
            sim.faces, nf_e, nf_h, sim.dft_dt, sim.nf_freqs_hz,
            prepared.theta, prepared.phi,
            centers_m=np.asarray(prepared.nf_centers), device=sim.device,
        )
        dmax_dbi = np.array([float(10 * np.log10(ff.Dmax[0])) for ff in ffs])
        rate = sim.grid.num_cells * steps * n_var / wall / 1e6
        if verbose:
            print(
                f"horn sweep: {n_var} apertures × {steps} steps in {wall:.2f}s"
                f" → {rate:.0f} Mcells/s aggregate; Dmax {dmax_dbi} dBi"
            )
        return SweepResult(
            True,
            f"Horn sweep completed: {n_var} variants",
            spectra=spectra,
            f_res_hz=f_res,
            s11_min_db=s11_min,
            Dmax_dbi=dmax_dbi,
            steps_run=steps,
            wall_time_s=wall,
            mcells_per_s=rate,
            steps=out["steps"][:n_var],
            e_ratio=out["e_ratio"][:n_var],
        )
    except Exception as e:
        return SweepResult(False, f"horn sweep run failed: {e}")
