"""CLI frontend: ``python -m fdtd_solver_antennas_tpu_torch fdtd ...``.

Counterpart of the ``fdtd --solver fixed`` subcommand of
``fdtd_solver_antennas_tpu/__main__.py``: a full 3D FDTD run of the
canonical patch, a JSON summary, ``s11.npz`` and a Touchstone file. It
draws no plots.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description="Patch antenna FDTD simulator (PyTorch / CUDA)"
    )
    sub = parser.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser(
        "fdtd", help="Full 3D FDTD run: S11 sweep, far-field, dBi grid"
    )
    p.add_argument("--frequency-ghz", type=float, required=True)
    p.add_argument("--er", type=float, required=True)
    p.add_argument("--h-mm", type=float, required=True)
    p.add_argument("--L-mm", type=float, default=None)
    p.add_argument("--W-mm", type=float, default=None)
    p.add_argument("--metal", type=str, default="copper")
    p.add_argument("--loss-tangent", type=float, default=0.0)
    p.add_argument("--outdir", type=str, default="outputs")
    p.add_argument("--solver", choices=["fixed"], default="fixed")
    p.add_argument("--boundary", type=str, default="MUR")
    p.add_argument("--steps-max", type=int, default=30_000)
    p.add_argument(
        "--device", type=str, default="cuda",
        help="'cuda' runs the CUDA kernels, 'cpu' their plain PyTorch twins",
    )
    args = parser.parse_args(argv)

    from .models.params import PatchAntennaParams
    from .post.touchstone import write_touchstone
    from .solvers.patch_fixed import prepare_patch_fixed, run_prepared_fixed

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
    prepared = prepare_patch_fixed(
        params, device=args.device, n_steps_max=args.steps_max,
        boundary=args.boundary, verbose=1,
    )
    if not prepared.ok:
        raise SystemExit(f"prepare failed: {prepared.message}")
    result = run_prepared_fixed(
        prepared, frequency_hz=params.frequency_hz, verbose=1)
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


if __name__ == "__main__":
    main()
