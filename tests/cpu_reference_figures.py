"""A long CPU run that settles whether a port reading is the reference's:
the JAX package's ``design_array`` on the CLI's 2×1 array of
the canonical FR-4 patch (86×44×53, two one-hot runs to the energy stop)
on its XLA path, printing what smoke phase 22 prints for the port's run
on the card: reciprocity error over max|S|, passivity margin, maximum
coupling, each |S_ii|min, the pitch, margin and feed, and the steps.

    JAX_PLATFORMS=cpu python tests/cpu_reference_figures.py
"""

import os
import sys
import time

os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

USER = dict(frequency_ghz=2.45, er=4.3, h_mm=1.6, loss_tangent=0.02)


def array_figures() -> None:
    from fdtd_solver_antennas_tpu.models.params import PatchAntennaParams
    from fdtd_solver_antennas_tpu.solvers.array_synth import design_array

    t0 = time.perf_counter()
    d = design_array(PatchAntennaParams.from_user_units(**USER), 2, 1)
    assert d.ok, d.message
    sm = d.patterns.smatrix
    s = sm.s
    n = s.shape[0]
    peak = float(np.nanmax(np.abs(s)))
    recip = sm.reciprocity_error()
    off = np.abs(s[~np.eye(n, dtype=bool)])
    diag = [20 * np.log10(np.nanmin(np.abs(s[i, i]))) for i in range(n)]
    print(f"JAX design_array 2x1 (XLA on the CPU, {time.perf_counter() - t0:.1f} s): "
          f"pitch {d.spacing_mm:.1f} mm, margin {d.margin_mm:.1f} mm, feed "
          f"{d.feed_mm:.1f} mm, {sm.steps_run} steps at most; reciprocity "
          f"error {recip:.4e} = {recip / peak:.4e} of max|S| {peak:.4f}, "
          f"passivity margin {sm.passivity_margin():.4f}, max coupling "
          f"{20 * np.log10(np.nanmax(off)):.2f} dB, |S_ii|min "
          f"{' / '.join(f'{v:.2f}' for v in diag)} dB, resonant {d.resonant}")


if __name__ == "__main__":
    array_figures()
