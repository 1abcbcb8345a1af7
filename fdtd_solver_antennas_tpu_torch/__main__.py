"""CLI frontend: ``python -m fdtd_solver_antennas_tpu_torch simulate|fdtd|s11|horn|array|inverse ...``.

Counterpart of ``fdtd_solver_antennas_tpu/__main__.py``, with its
subcommands, flags and files: ``simulate``, the analytical design (its
summary, ``cuts.png`` and ``pattern_3d.png``); a full 3D FDTD run of the
canonical patch (``fdtd --solver fixed``) or of the microstrip-fed patch
(``--solver microstrip``, the ``s11`` default), each printing its engine
path and a JSON summary and writing ``s11.npz`` and a Touchstone file
(``fdtd`` also ``pattern_fdtd.png``); of a pyramidal horn (JSON summary,
``s11.npz``, ``horn_pattern.png``); or of an nx×ny patch array, one run
per port (JSON summary, ``array_embedded.npz`` with the embedded element
patterns and the S matrix, the array's Touchstone file,
``array_broadside.png`` and ``array_steered.png``); or the adjoint inverse
design of the patch metallization (optimize, threshold, validate:
progress lines, a JSON summary, ``inverse_design.npz`` and
``inverse_design.png``). Every FDTD subcommand runs on ``--device cuda``
unless ``--device cpu`` is asked for.

The figures need matplotlib, which nothing else here imports. Without
it every numeric output is still written, and each figure left out is
named on a line of its own (``Not drawn: <file> (...)``).
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np


def _add_common_antenna_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--frequency-ghz", type=float, required=True)
    p.add_argument("--er", type=float, required=True)
    p.add_argument("--h-mm", type=float, required=True)
    p.add_argument("--L-mm", type=float, default=None)
    p.add_argument("--W-mm", type=float, default=None)
    p.add_argument("--metal", type=str, default="copper")
    p.add_argument("--loss-tangent", type=float, default=0.0)
    p.add_argument("--outdir", type=str, default="outputs")
    _add_device_arg(p)


def _add_device_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "--device", type=str, default="cuda",
        help="'cuda' runs the CUDA kernels, 'cpu' their plain PyTorch twins",
    )


def _figure(path: Path, draw) -> None:
    """Save the figure ``draw()`` returns at ``path`` (dpi 160, tight
    bounding box, as the JAX CLI saves its figures), or print that it was
    not drawn when matplotlib is not installed."""
    from .viz import save_figure

    save_figure(path, draw, dpi=160, bbox_inches="tight")


def _grid_figure(theta, phi, intensity, colors_db):
    """``draw`` for a far-field grid: the JAX CLI's 3D surface."""

    def draw():
        from .viz.plotting import plot_3d_pattern_from_grid

        return plot_3d_pattern_from_grid(theta, phi, intensity,
                                         colors_db=colors_db)

    return draw


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description="Patch antenna FDTD simulator (PyTorch / CUDA)"
    )
    sub = parser.add_subparsers(dest="cmd", required=True)
    sim_p = sub.add_parser(
        "simulate", help="Analytical simulation; saves cuts.png + pattern_3d.png"
    )
    _add_common_antenna_args(sim_p)
    p = sub.add_parser(
        "fdtd", help="Full 3D FDTD run: S11 sweep, far-field, dBi grid"
    )
    _add_common_antenna_args(p)
    p.add_argument("--solver", choices=["fixed", "microstrip"], default="fixed")
    p.add_argument("--feed-direction", type=str, default="-X")
    p.add_argument("--boundary", type=str, default="MUR")
    p.add_argument("--steps-max", type=int, default=30_000)
    h = sub.add_parser("horn", help="Pyramidal horn FDTD: gain pattern + S11")
    h.add_argument("--frequency-ghz", type=float, required=True)
    h.add_argument("--throat-a-mm", type=float, required=True)
    h.add_argument("--throat-b-mm", type=float, required=True)
    h.add_argument("--aperture-A-mm", type=float, required=True)
    h.add_argument("--aperture-B-mm", type=float, required=True)
    h.add_argument("--length-mm", type=float, required=True)
    h.add_argument("--outdir", type=str, default="outputs")
    _add_device_arg(h)
    s = sub.add_parser("s11", help="FDTD S11 frequency sweep only")
    _add_common_antenna_args(s)
    s.add_argument("--solver", choices=["fixed", "microstrip"],
                   default="microstrip")
    s.add_argument("--feed-direction", type=str, default="-X")
    s.add_argument("--steps-max", type=int, default=30_000)
    a = sub.add_parser(
        "array",
        help="nx×ny patch array: embedded element patterns, full S-matrix, "
        "and steered-beam synthesis from N one-hot FDTD runs",
    )
    _add_common_antenna_args(a)
    a.add_argument("--nx", type=int, default=2)
    a.add_argument("--ny", type=int, default=1)
    a.add_argument("--spacing-mm", type=float, default=None,
                   help="element pitch (default: free-space λ0/2)")
    a.add_argument("--mesh-quality", type=int, default=3)
    a.add_argument("--steer-theta", type=float, default=25.0)
    a.add_argument("--steer-phi", type=float, default=0.0)
    a.add_argument("--steering", choices=["conjugate", "geometric"],
                   default="conjugate")
    a.add_argument("--theta-step", type=float, default=5.0)
    a.add_argument("--phi-step", type=float, default=5.0)
    inv = sub.add_parser(
        "inverse",
        help="adjoint topology optimization of the patch metallization "
        "against the S11 band or broadside realized gain "
        "(optimize -> threshold -> validate)",
    )
    _add_common_antenna_args(inv)
    inv.add_argument("--iters", type=int, default=40)
    inv.add_argument("--lr", type=float, default=0.05)
    inv.add_argument("--band-pct", type=float, default=10.0,
                     help="loss band half-width around f0 in percent")
    inv.add_argument("--n-freqs", type=int, default=5)
    inv.add_argument("--mesh-divisor", type=float, default=20.0,
                     help="design-region resolution: cells per wavelength")
    inv.add_argument(
        "--objective", choices=["s11_band", "broadside_gain"],
        default="s11_band",
        help="loss to optimize: mean |S11|^2 over the band, or negative "
        "broadside realized gain D(0)*(1-|S11(f0)|^2) through the "
        "differentiable NF2FF transform",
    )
    inv.add_argument("--beta", type=float, default=4.0,
                     help="sigmoid sharpness pushing densities toward 0/1")
    args = parser.parse_args(argv)
    if args.cmd == "horn":
        _horn(args)
        return

    from .models.params import PatchAntennaParams
    from .post.touchstone import write_touchstone

    outdir = Path(args.outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    params = PatchAntennaParams.from_user_units(
        frequency_ghz=args.frequency_ghz,
        er=args.er,
        h_mm=args.h_mm,
        L_mm=args.L_mm,
        W_mm=args.W_mm,
        metal=args.metal,
        loss_tangent=args.loss_tangent,
    )
    if args.cmd == "array":
        _array(args, params, outdir)
        return
    if args.cmd == "inverse":
        _inverse(args, params, outdir)
        return
    if args.cmd == "simulate":
        _simulate(params, outdir)
        return
    if args.solver == "fixed":
        from .solvers.patch_fixed import prepare_patch_fixed, run_prepared_fixed

        prepared = prepare_patch_fixed(
            params, device=args.device, n_steps_max=args.steps_max,
            boundary=getattr(args, "boundary", "MUR"), verbose=1,
        )
        runner = run_prepared_fixed
    else:
        from .solvers.microstrip import (
            FeedDirection,
            prepare_microstrip_patch,
            run_prepared_microstrip,
        )

        prepared = prepare_microstrip_patch(
            params, device=args.device,
            feed_direction=FeedDirection(args.feed_direction),
            n_steps_max=args.steps_max, verbose=1,
        )
        runner = run_prepared_microstrip
    if not prepared.ok:
        raise SystemExit(f"prepare failed: {prepared.message}")
    print(f"engine path: {prepared.sim.pallas_mode_reason}")
    result = runner(prepared, frequency_hz=params.frequency_hz, verbose=1)
    if not result.ok:
        raise SystemExit(f"run failed: {result.message}")

    s11_db = 20 * np.log10(np.maximum(np.abs(result.s11), 1e-12))
    summary = {
        "f_res_ghz": result.f_res_hz / 1e9,
        "s11_min_db": float(s11_db.min()),
        "Dmax_dbi": 10 * np.log10(result.Dmax) if result.Dmax else None,
        "steps": result.steps_run,
        "wall_time_s": result.wall_time_s,
        "mcells_per_s": result.mcells_per_s,
        "device": result.diagnostics.get("device"),
    }
    print(json.dumps(summary, indent=2))
    np.savez(
        outdir / "s11.npz", freq_hz=result.freq, s11=result.s11, z_in=result.z_in
    )
    print(f"Saved: {outdir / 's11.npz'}")
    ts = write_touchstone(
        outdir / "s11", result.freq, result.s11, z_ref=50.0,
        comments=[f"{args.solver} patch, f0={params.frequency_hz/1e9:g} GHz"],
    )
    print(f"Saved: {ts}")
    if args.cmd == "fdtd":
        _figure(outdir / "pattern_fdtd.png", _grid_figure(
            result.theta, result.phi,
            10 ** (np.asarray(result.intensity) / 10.0), result.intensity))


def _simulate(params, outdir: Path) -> None:
    """The ``simulate`` subcommand: the analytical cavity model's design
    summary, then its polar cuts and 3D gain surface."""
    from .solvers.analytical import AnalyticalPatchSolver

    solver = AnalyticalPatchSolver(params)
    print("Design:")
    for k, v in solver.summary().items():
        print(f"  {k}: {v}")

    def cuts():
        from .viz.plotting import plot_cross_sections

        return plot_cross_sections(solver)

    def pattern_3d():
        from .viz.plotting import plot_3d_pattern

        return plot_3d_pattern(solver)

    _figure(outdir / "cuts.png", cuts)
    _figure(outdir / "pattern_3d.png", pattern_3d)


def _array(args, params, outdir: Path) -> None:
    """The ``array`` subcommand: ``design_array``, then the JAX CLI's JSON
    summary, ``array_embedded.npz``, the Touchstone file and the broadside
    and steered realized-gain surfaces."""
    from .post.touchstone import write_touchstone
    from .solvers.array_synth import array_run_summary, design_array

    design = design_array(
        params, args.nx, args.ny, args.spacing_mm,
        mesh_quality=args.mesh_quality,
        theta_step_deg=args.theta_step, phi_step_deg=args.phi_step,
        verbose=1, device=args.device,
        progress_cb=lambda j, n, r: (
            print(f"one-hot run {j}/{n} done") if j and r >= j / n else None
        ),
    )
    if not design.ok:
        raise SystemExit(design.message)
    summary, broadside, steered, _ = array_run_summary(
        design, args.steer_theta, args.steer_phi, kind=args.steering
    )
    summary = {"design_freq_ghz": params.frequency_hz / 1e9, **summary,
               "device": str(design.prep.sim.device)}
    print(json.dumps(summary, indent=2))
    eps, sm = design.patterns, design.smatrix
    np.savez(
        outdir / "array_embedded.npz",
        freq_hz=eps.freq_hz, theta=eps.theta, phi=eps.phi,
        e_theta=eps.e_theta, e_phi=eps.e_phi,
        s=sm.s, s_freqs_hz=sm.freq_hz,
        port_centers_m=eps.port_centers_m,
    )
    print(f"Saved: {outdir / 'array_embedded.npz'}")
    ts = write_touchstone(
        outdir / "array", sm.freq_hz, sm.s, z_ref=sm.z_ref,
        comments=[f"{args.nx}x{args.ny} patch array, full S matrix"],
    )
    print(f"Saved: {ts}")
    for tag, pat in (("broadside", broadside), ("steered", steered)):
        _figure(outdir / f"array_{tag}.png", _grid_figure(
            pat.theta, pat.phi, pat.realized_gain, pat.realized_gain_dbi()))


def _inverse(args, params, outdir: Path) -> None:
    """The ``inverse`` subcommand: prepare, optimize, validate the binary
    design, then the JAX CLI's JSON summary, ``inverse_design.npz`` and the
    density beside the validated and soft S11."""
    from .solvers import inverse

    f0 = params.frequency_hz
    half = args.band_pct / 100.0
    freqs = np.linspace((1 - half) * f0, (1 + half) * f0, args.n_freqs)
    print(f"Building differentiable problem (mesh λ/{args.mesh_divisor:g}) …")
    prob = inverse.prepare_patch_inverse(
        params, freqs_hz=freqs, mesh_divisor=args.mesh_divisor,
        device=args.device,
    )
    ni, nj = prob.region.shape
    print(
        f"Design region {ni}×{nj} px over "
        f"x∈[{prob.region.x_mm[0]:.1f},{prob.region.x_mm[1]:.1f}] "
        f"y∈[{prob.region.y_mm[0]:.1f},{prob.region.y_mm[1]:.1f}] mm; "
        f"{prob.n_steps} differentiable steps/iter"
    )
    res = prob.optimize(
        n_iters=args.iters, lr=args.lr, beta_sharpen=args.beta,
        objective=args.objective,
        callback=lambda it, v, _r: print(
            f"  iter {it + 1}/{args.iters}  loss={v:.5f}"
        ),
    )
    pattern = args.objective == "broadside_gain"
    val = prob.validate(res.rho, pattern=pattern)
    spec = val["spectra"]
    summary = {
        "loss_initial": res.history[0],
        "loss_final": res.history[-1],
        "soft_s11_db_band": [float(v) for v in res.s11_db()],
        "validated_f_res_ghz": (
            val["f_res_hz"] / 1e9 if val["f_res_hz"] else None
        ),
        "validated_s11_min_db": (
            float(np.min(20 * np.log10(np.maximum(np.abs(spec.s11), 1e-12))))
            if spec is not None else None
        ),
        "validated_steps": val["steps"],
        "optimize_wall_s": res.wall_s,
    }
    if pattern:
        summary["objective"] = "broadside_gain"
        summary["validated_broadside_directivity"] = val[
            "broadside_directivity"
        ]
        summary["validated_broadside_realized_gain_dbi"] = val[
            "broadside_realized_gain_dbi"
        ]
    summary["device"] = str(prob.device)
    print(json.dumps(summary, indent=2))
    np.savez(
        outdir / "inverse_design.npz",
        rho=res.rho, rho_binary=val["rho_binary"],
        loss_history=np.asarray(res.history),
        freqs_hz=res.freqs_hz, s11=res.s11,
        validated_freq_hz=spec.freq_hz, validated_s11=spec.s11,
        region_x_mm=np.asarray(prob.region.x_mm),
        region_y_mm=np.asarray(prob.region.y_mm),
    )
    print(f"Saved: {outdir / 'inverse_design.npz'}")

    def draw():
        import matplotlib.pyplot as plt

        fig, (ax0, ax1) = plt.subplots(1, 2, figsize=(10, 4))
        ax0.imshow(
            res.rho.T, origin="lower", cmap="gray_r", vmin=0, vmax=1,
            extent=[*prob.region.x_mm, *prob.region.y_mm], aspect="equal",
        )
        ax0.set_title("metallization density ρ")
        ax0.set_xlabel("x (mm)")
        ax0.set_ylabel("y (mm)")
        val_db = 20 * np.log10(np.maximum(np.abs(spec.s11), 1e-12))
        ax1.plot(spec.freq_hz / 1e9, val_db, label="validated (binary)")
        ax1.plot(res.freqs_hz / 1e9, res.s11_db(), "o", label="soft model")
        ax1.axhline(-10, color="k", lw=0.5, ls="--")
        ax1.set_xlabel("f (GHz)")
        ax1.set_ylabel("S11 (dB)")
        ax1.legend()
        ax1.grid(alpha=0.3)
        return fig

    _figure(outdir / "inverse_design.png", draw)


def _horn(args) -> None:
    """The ``horn`` subcommand: prepare and run, then the JAX CLI's JSON
    summary, ``s11.npz`` and the gain surface."""
    from .models.params import HornAntennaParams
    from .solvers.horn import prepare_horn, run_prepared_horn

    outdir = Path(args.outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    hp = HornAntennaParams.from_user_units(
        frequency_ghz=args.frequency_ghz,
        throat_a_mm=args.throat_a_mm,
        throat_b_mm=args.throat_b_mm,
        aperture_A_mm=args.aperture_A_mm,
        aperture_B_mm=args.aperture_B_mm,
        length_mm=args.length_mm,
    )
    prep = prepare_horn(hp, device=args.device, verbose=1)
    if not prep.ok:
        raise SystemExit(f"prepare failed: {prep.message}")
    res = run_prepared_horn(prep, frequency_hz=hp.frequency_hz)
    if not res.ok:
        raise SystemExit(f"run failed: {res.message}")
    print(json.dumps({
        "Dmax_dbi": 10 * np.log10(res.Dmax),
        "radiation_efficiency": res.radiation_efficiency,
        "steps": res.steps_run,
        "mcells_per_s": res.mcells_per_s,
        "device": res.diagnostics.get("device"),
    }, indent=2))
    np.savez(outdir / "s11.npz", freq_hz=res.freq, s11=res.s11, z_in=res.z_in)
    print(f"Saved: {outdir / 's11.npz'}")
    _figure(outdir / "horn_pattern.png", _grid_figure(
        res.theta, res.phi, 10 ** (np.asarray(res.intensity) / 10.0),
        res.intensity))


if __name__ == "__main__":
    main()
