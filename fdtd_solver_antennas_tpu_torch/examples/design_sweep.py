"""Batched geometry sweep: S11 over a family of patch designs in one
batched run. Prints each variant's resonance and dip depth.

Counterpart of ``examples/design_sweep.py``, with its variants and lines.
The three variants share one union grid and run together: on the card
one ``chunk_steps_batch`` launch a chunk (K1 batched), where the JAX
package runs its chunk kernel under ``jax.vmap``.

Usage:
    python -m fdtd_solver_antennas_tpu_torch.examples.design_sweep [--device cuda]
"""

from __future__ import annotations

import argparse

import numpy as np

from ..models.params import PatchAntennaParams
from ..solvers.sweep import prepare_patch_geometry_sweep, run_patch_geometry_sweep
from ..utils.backend import ensure_backend

GEOMETRIES_MM = ((26.0, 34.0), (29.1, 37.6), (32.0, 41.0))  # (L, W)


def design_sweep(*, device="cuda", geometries=GEOMETRIES_MM,
                 n_steps_max: int = 12_000, verbose: int = 1):
    """Prepare and run the sweep of ``geometries`` ((L, W) in mm); print
    each variant's dip. Returns ``(prepared, result)``."""
    variants = [
        PatchAntennaParams.from_user_units(
            frequency_ghz=2.45, er=4.3, h_mm=1.6, L_mm=L, W_mm=W)
        for (L, W) in geometries
    ]
    prep = prepare_patch_geometry_sweep(variants, n_steps_max=n_steps_max,
                                        device=device)
    assert prep.ok, prep.message
    res = run_patch_geometry_sweep(prep, verbose=verbose)
    assert res.ok, res.message
    for v, sp in zip(variants, res.spectra):
        db = 20 * np.log10(np.abs(sp.s11) + 1e-30)
        i = int(np.argmin(db))
        print(
            f"L={v.L_mm:.1f} W={v.W_mm:.1f} mm → dip {db[i]:.1f} dB at "
            f"{sp.freq_hz[i] / 1e9:.3f} GHz"
        )
    return prep, res


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", type=str, default="cuda",
                    help="'cuda' runs the CUDA kernels, 'cpu' their plain "
                         "PyTorch twins")
    args = ap.parse_args(argv)
    ensure_backend(args.device)
    design_sweep(device=args.device)


if __name__ == "__main__":
    main()
