"""Adjoint pattern-objective result: recovering broadside gain.

Counterpart of ``examples/inverse_broadside_gain.py``, with its
arguments, lines and headline check. The adjoint runs through the NF2FF
radiation integrals (``solvers/inverse.py::_directivity_ri``), so the
optimizer works on the far field, here broadside realized gain
D(θ=0)·(1−|S11(f0)|²), instead of only the port spectrum.

Scenario: a patch perturbed off its design. The metallization is a solid
rectangle shrunk 12% per side, so it resonates well above 2.45 GHz and
reflects most of the feed power at f0; its broadside realized gain is
poor. The optimizer starts from that damaged core (the seed density) and
must recover the gain by retuning the radiator.

Workflow:
1. baseline: the perturbed patch validated through the standard
   energy-terminated engine (K1 on the card) and the standard NF2FF;
2. optimize: Adam on the density logits against negative broadside
   realized gain at f0, the gradient flowing through the FDTD loop and
   the radiation integrals under ``torch.autograd``;
3. threshold at 0.5 and validate the binary design through the standard
   engine and ``post/nf2ff.py``: the reported lift never rests on the soft
   density model.

Without ``--quick`` the script asserts a validated lift above 1 dB.
``--quick`` (λ/12, 6 iterations) shows the mechanics.

Usage:
    python -m fdtd_solver_antennas_tpu_torch.examples.inverse_broadside_gain [--iters 40] [--quick] [--device cuda] [--outdir outputs]
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


def _fmt_res(out) -> str:
    # a badly detuned design may have no in-band dip at all:
    # find_resonance then reports None
    if out["f_res_hz"] is None or out["s11_db"] is None:
        return "no in-band resonance"
    return (f"resonance {out['f_res_hz'] / 1e9:.3f} GHz, "
            f"S11(f_res) {out['s11_db']:.1f} dB")


def inverse_broadside_gain(*, iters: int = 40, shrink: float = 0.88,
                           outdir="outputs", quick: bool = False,
                           device="cuda", mesh_divisor: float = 16.0,
                           lr: float = 0.08, beta_sharpen: float = 4.0,
                           n_steps_max_validate: int = 12_000,
                           check_headline: bool = True) -> dict:
    """Baseline, optimize, validate and draw; the JAX script's lines.
    ``quick`` takes λ/12 and 6 iterations, as the JAX script's ``--quick``
    does, and skips the headline check; so does ``check_headline=False``
    (a run cut to a few iterations). Returns the problem, the seed, both
    validations, the optimizer's result and the timings."""
    t_all = time.perf_counter()
    params = PatchAntennaParams.from_user_units(
        frequency_ghz=2.45, er=4.3, h_mm=1.6, loss_tangent=0.02)
    L_m, W_m, _ = design_patch_for_frequency(F0, 4.3, 1.6e-3)

    n_iters = 6 if quick else int(iters)
    prob = prepare_patch_inverse(
        params,
        freqs_hz=np.linspace(0.96 * F0, 1.04 * F0, 5),
        mesh_divisor=12.0 if quick else mesh_divisor,
        fc_hz=F0,  # wide band halves the source: cheaper iterations
        n_steps_max_validate=n_steps_max_validate,
        device=device,
    )
    r = prob.region
    print(f"grid {prob.sim.grid.shape}, design pixels {r.shape}, "
          f"{prob.n_steps} differentiable steps/iter")

    # -- seed: the perturbed (shrunk, detuned) patch ------------------------
    g = prob.sim.grid
    cx = 0.5 * (g.lines["x"][r.i0:r.i1] + g.lines["x"][r.i0 + 1:r.i1 + 1])
    cy = 0.5 * (g.lines["y"][r.j0:r.j1] + g.lines["y"][r.j0 + 1:r.j1 + 1])
    s = float(shrink)
    wx, wy = W_m / 2 * 1e3 * s, L_m / 2 * 1e3 * s
    seed = (
        (np.abs(cx)[:, None] <= wx) & (np.abs(cy)[None, :] <= wy)
    ).astype(np.float32)
    print(
        f"perturbed patch: {2 * wx:.1f} × {2 * wy:.1f} mm "
        f"(closed form {W_m * 1e3:.1f} × {L_m * 1e3:.1f} mm)"
    )

    base = prob.validate(seed, pattern=True)
    g_base = base["broadside_realized_gain_dbi"]
    print(
        f"baseline (perturbed patch): {_fmt_res(base)}, "
        f"broadside realized gain at f0 {g_base:.2f} dBi"
    )

    # -- adjoint optimization on the far-field objective --------------------
    t0 = time.perf_counter()
    res = prob.optimize(
        rho0=np.clip(seed, 0.02, 0.98),  # optimizer may add or trim metal
        n_iters=n_iters, lr=lr, beta_sharpen=beta_sharpen,
        objective="broadside_gain",
    )
    opt_s = time.perf_counter() - t0
    print(
        f"optimized {n_iters} iterations in {opt_s:.0f}s; "
        f"soft realized gain {-res.history[0]:.2f} → {-res.history[-1]:.2f} "
        "(linear)"
    )

    # -- validate the binarized design through the standard engine ----------
    val = prob.validate(res.rho, pattern=True)
    g_opt = val["broadside_realized_gain_dbi"]
    print(
        f"validated optimized design: {_fmt_res(val)}, "
        f"broadside realized gain at f0 {g_opt:.2f} dBi  "
        f"(lift {g_opt - g_base:+.2f} dB)"
    )

    # -- figure --------------------------------------------------------------
    def draw():
        import matplotlib.pyplot as plt

        fig, axes = plt.subplots(1, 3, figsize=(14, 4.2))
        for ax, rho, title in (
            (axes[0], seed, "perturbed seed"),
            (axes[1], (np.asarray(res.rho) >= 0.5).astype(float),
             "optimized"),
        ):
            ax.imshow(
                rho.T, origin="lower", cmap="copper",
                extent=[r.x_mm[0], r.x_mm[1], r.y_mm[0], r.y_mm[1]],
                aspect="equal",
            )
            ax.set_title(title)
            ax.set_xlabel("x (mm)")
        axes[0].set_ylabel("y (mm)")
        for tag, out, style in (("perturbed", base, "--"),
                                ("optimized", val, "-")):
            sp = out["spectra"]
            db = 20 * np.log10(np.abs(sp.s11) + 1e-12)
            gain = out["broadside_realized_gain_dbi"]
            axes[2].plot(sp.freq_hz / 1e9, db, style,
                         label=f"{tag}: {gain:.1f} dBi broadside")
        axes[2].axvline(F0 / 1e9, color="k", lw=0.8, alpha=0.6)
        axes[2].set_xlabel("frequency (GHz)")
        axes[2].set_ylabel("S11 (dB)")
        axes[2].set_title("validated through the standard engine")
        axes[2].legend(fontsize=8)
        axes[2].grid(alpha=0.3)
        fig.tight_layout()
        return fig

    outdir = Path(outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    save_figure(outdir / "inverse_broadside_gain.png", draw, dpi=160)
    wall = time.perf_counter() - t_all
    print(f"wall {wall:.1f} s; optimize {opt_s:.1f} s, "
          f"{opt_s / max(n_iters, 1):.2f} s an iteration, on {prob.device}")

    if check_headline and not quick:
        assert g_opt > g_base + 1.0, (
            f"expected ≥1 dB validated gain lift, got {g_opt - g_base:+.2f}"
        )
        print(f"HEADLINE OK: broadside realized gain {g_base:.1f} → "
              f"{g_opt:.1f} dBi, validated through the standard engine")
    return dict(problem=prob, seed=seed, base=base, result=res,
                validated=val, optimize_s=opt_s, n_iters=n_iters, wall_s=wall)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=40)
    ap.add_argument("--shrink", type=float, default=0.88,
                    help="perturbed-patch linear size vs the closed form")
    ap.add_argument("--outdir", type=str, default="outputs")
    ap.add_argument("--quick", action="store_true",
                    help="small configuration (coarser mesh, fewer "
                         "iterations)")
    ap.add_argument("--device", type=str, default="cuda",
                    help="'cuda' runs the CUDA kernels, 'cpu' their plain "
                         "PyTorch twins")
    args = ap.parse_args(argv)
    ensure_backend(args.device)
    inverse_broadside_gain(iters=args.iters, shrink=args.shrink,
                           outdir=args.outdir, quick=args.quick,
                           device=args.device)


if __name__ == "__main__":
    main()
