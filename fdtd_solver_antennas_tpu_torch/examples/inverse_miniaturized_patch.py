"""Headline inverse-design result: a miniaturized 2.45 GHz patch.

Counterpart of ``examples/inverse_miniaturized_patch.py``, with its
arguments, lines and headline check. The closed-form Hammerstad–Jensen
design for 2.45 GHz on FR-4 (εr 4.3, h 1.6 mm,
``physics.py::design_patch_for_frequency``) needs a 28.8 × 37.2 mm patch.
This script squeezes the radiator into a design region only ~72% of that
linear size (~52% of the footprint area), where a solid patch of the
whole region resonates far above the target, and lets the adjoint
optimizer (``solvers/inverse.py``: ``torch.autograd`` through the
fixed-length FDTD loop) carve a slotted metallization that brings the
resonance down to 2.45 GHz.

Workflow:
1. baseline: solid metal over the whole (shrunken) region, validated
   through the standard energy-terminated engine (K1 on the card);
2. optimize: Adam on the density logits against mean |S11|² in a narrow
   band around 2.45 GHz;
3. threshold at 0.5 and validate the binary design through the standard
   engine: every number reported comes from that run, never from the soft
   density model.

Without ``--quick`` the script asserts the headline: the baseline misses
2.45 GHz by more than 10% and the optimized design lands within 2%.
``--quick`` (λ/12, 8 iterations) shows the mechanics, not the headline.

Usage:
    python -m fdtd_solver_antennas_tpu_torch.examples.inverse_miniaturized_patch [--iters 60] [--quick] [--device cuda] [--outdir outputs]
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np

from ..models.params import PatchAntennaParams
from ..physics import design_patch_for_frequency
from ..solvers.inverse import prepare_patch_inverse
from ..utils.backend import ensure_backend
from ..viz import save_figure

F0 = 2.45e9
# find_resonance's answer when no dip clears -10 dB: the target itself
NO_DIP = "no in-band resonance (no dip below -10 dB; f_res reported as the target)"


def inverse_miniaturized_patch(*, iters: int = 60, shrink: float = 0.72,
                               outdir="outputs", quick: bool = False,
                               device="cuda", mesh_divisor: float = 18.0,
                               lr: float = 0.08, beta_sharpen: float = 4.0,
                               n_steps_max_validate: int = 12_000,
                               check_headline: bool = True) -> dict:
    """Baseline, optimize, validate and draw; the JAX script's lines.
    ``quick`` takes λ/12 and 8 iterations, as the JAX script's ``--quick``
    does, and skips the headline check; so does ``check_headline=False``
    (a run cut to a few iterations cannot reach it). Returns the problem, both
    validations, the optimizer's result and the timings."""
    t_all = time.perf_counter()
    params = PatchAntennaParams.from_user_units(
        frequency_ghz=2.45, er=4.3, h_mm=1.6, loss_tangent=0.02)
    L_m, W_m, _ = design_patch_for_frequency(F0, 4.3, 1.6e-3)
    s = float(shrink)
    # region centered like the canonical patch, shrunk per side
    region = (
        -W_m / 2 * 1e3 * s, W_m / 2 * 1e3 * s,
        -L_m / 2 * 1e3 * s, L_m / 2 * 1e3 * s,
    )
    print(
        f"closed-form patch: {W_m * 1e3:.1f} × {L_m * 1e3:.1f} mm; "
        f"design region: {(region[1] - region[0]):.1f} × "
        f"{(region[3] - region[2]):.1f} mm "
        f"({100 * s * s:.0f}% of the footprint area)"
    )

    n_iters = 8 if quick else int(iters)
    prob = prepare_patch_inverse(
        params,
        region_mm=region,
        freqs_hz=np.linspace(0.96 * F0, 1.04 * F0, 5),
        mesh_divisor=12.0 if quick else mesh_divisor,
        fc_hz=F0,  # wide band halves the source: cheaper iterations
        n_steps_max_validate=n_steps_max_validate,
        device=device,
    )
    print(f"grid {prob.sim.grid.shape}, design pixels {prob.region.shape}, "
          f"{prob.n_steps} differentiable steps/iter")

    # -- baseline: solid metal over the whole shrunken region -------------
    solid = np.ones(prob.region.shape, np.float32)
    base = prob.validate(solid)
    f_base = base["f_res_hz"]
    print(
        f"baseline (solid {100 * s * s:.0f}%-area patch): "
        + (f"resonance {f_base / 1e9:.3f} GHz, S11 {base['s11_db']:.1f} dB "
           f"(target {F0 / 1e9:.2f} GHz missed by "
           f"{100 * abs(f_base - F0) / F0:.1f}%)"
           if base["s11_db"] is not None else NO_DIP)
    )

    # -- adjoint optimization ---------------------------------------------
    t0 = time.perf_counter()
    res = prob.optimize(n_iters=n_iters, lr=lr, beta_sharpen=beta_sharpen)
    opt_s = time.perf_counter() - t0
    print(
        f"optimized {n_iters} iterations in {opt_s:.0f}s; "
        f"loss {res.history[0]:.4f} → {res.history[-1]:.4f}"
    )

    # -- validate the binarized design through the standard engine --------
    val = prob.validate(res.rho)
    f_opt = val["f_res_hz"]
    fill = float((np.asarray(res.rho) >= 0.5).mean())
    print(
        "validated optimized design: "
        + (f"resonance {f_opt / 1e9:.3f} GHz "
           f"(target miss {100 * abs(f_opt - F0) / F0:.2f}%), "
           f"S11 {val['s11_db']:.1f} dB"
           if val["s11_db"] is not None else NO_DIP)
        + f", metal fill {100 * fill:.0f}%"
    )

    # -- figure -------------------------------------------------------------
    def draw():
        import matplotlib.pyplot as plt

        fig, (ax0, ax1) = plt.subplots(1, 2, figsize=(11, 4.2))
        ax0.imshow(
            (np.asarray(res.rho) >= 0.5).T, origin="lower", cmap="copper",
            extent=[region[0], region[1], region[2], region[3]],
            aspect="equal",
        )
        ax0.set_title(
            f"optimized metallization ({(region[1] - region[0]):.0f}×"
            f"{(region[3] - region[2]):.0f} mm region, "
            f"{100 * s * s:.0f}% of closed-form area)"
        )
        ax0.set_xlabel("x (mm)")
        ax0.set_ylabel("y (mm)")
        for tag, out, style in (("solid baseline", base, "--"),
                                ("optimized", val, "-")):
            sp = out["spectra"]
            db = 20 * np.log10(np.abs(sp.s11) + 1e-12)
            ax1.plot(sp.freq_hz / 1e9, db, style, label=tag)
        ax1.axvline(F0 / 1e9, color="k", lw=0.8, alpha=0.6)
        ax1.set_xlabel("frequency (GHz)")
        ax1.set_ylabel("S11 (dB)")
        ax1.set_title("validated through the standard engine")
        ax1.legend()
        ax1.grid(alpha=0.3)
        fig.tight_layout()
        return fig

    outdir = Path(outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    save_figure(outdir / "inverse_miniaturized_patch.png", draw, dpi=160)
    wall = time.perf_counter() - t_all
    print(f"wall {wall:.1f} s; optimize {opt_s:.1f} s, "
          f"{opt_s / max(n_iters, 1):.2f} s an iteration, on {prob.device}")

    # headline check: the optimizer must have pulled the resonance to
    # within 2% of target from a baseline that misses by >10%
    if check_headline and not quick:
        assert abs(f_base - F0) / F0 > 0.10, "baseline unexpectedly on target"
        assert abs(f_opt - F0) / F0 < 0.02, (
            f"optimized design missed: {f_opt / 1e9:.3f} GHz")
        print("HEADLINE OK: >10% baseline miss pulled to <2% of target")
    return dict(problem=prob, base=base, result=res, validated=val,
                optimize_s=opt_s, n_iters=n_iters, wall_s=wall)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=60)
    ap.add_argument("--shrink", type=float, default=0.72,
                    help="design-region linear size vs the closed-form "
                         "patch (0.72 → 52%% of the footprint area)")
    ap.add_argument("--outdir", type=str, default="outputs")
    ap.add_argument("--quick", action="store_true",
                    help="small configuration (coarser mesh, fewer "
                         "iterations): the mechanics, not the headline")
    ap.add_argument("--device", type=str, default="cuda",
                    help="'cuda' runs the CUDA kernels, 'cpu' their plain "
                         "PyTorch twins")
    args = ap.parse_args(argv)
    ensure_backend(args.device)
    inverse_miniaturized_patch(iters=args.iters, shrink=args.shrink,
                               outdir=args.outdir, quick=args.quick,
                               device=args.device)


if __name__ == "__main__":
    main()
