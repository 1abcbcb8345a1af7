"""CLI frontend: ``python -m fdtd_solver_antennas_tpu_torch fdtd|s11|horn|array ...``.

Counterpart of the ``fdtd``, ``s11``, ``horn`` and ``array`` subcommands
of ``fdtd_solver_antennas_tpu/__main__.py``: a full 3D FDTD run of the
canonical patch (``--solver fixed``) or of the microstrip-fed patch
(``--solver microstrip``, the ``s11`` default), each printing its engine
path and a JSON summary and writing ``s11.npz`` and a Touchstone file; of
a pyramidal horn (JSON summary and ``s11.npz``); or of an nx×ny patch
array, one run per port (JSON summary, ``array_embedded.npz`` with the
embedded element patterns and the S matrix, and the array's Touchstone
file). Every subcommand runs on ``--device cuda`` unless ``--device cpu``
is asked for. It draws no plots.
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


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description="Patch antenna FDTD simulator (PyTorch / CUDA)"
    )
    sub = parser.add_subparsers(dest="cmd", required=True)
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


def _array(args, params, outdir: Path) -> None:
    """The ``array`` subcommand: ``design_array``, then the JAX CLI's JSON
    summary, ``array_embedded.npz`` and the Touchstone file (no plot)."""
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
    summary, _broadside, _steered, _ = array_run_summary(
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


def _horn(args) -> None:
    """The ``horn`` subcommand: prepare and run, then the JAX CLI's JSON
    summary and ``s11.npz`` (no plot)."""
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


if __name__ == "__main__":
    main()
