"""Gaussian-pulse excitation (openEMS ``SetGaussExcite(f0, fc)`` analog).

A copy of ``fdtd_solver_antennas_tpu/ops/source.py`` (NumPy only).

The reference excites every FDTD run with a modulated Gaussian whose −20 dB
spectral corners sit at f0 ± fc (``solver_fdtd_openems_fixed.py:167-172``
with fc = f0/2). We precompute the whole waveform as a (T,) array that the
scanned time loop indexes — no per-step host work.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np


def gaussian_source_params(f0: float, fc: float) -> Tuple[float, float]:
    """Return (sigma_t, t0) for the modulated Gaussian.

    sigma chosen so the spectral envelope exp(−(2π·Δf)²σ²/2) is −20 dB
    (factor 0.1) at Δf = fc; t0 = 4.5σ keeps the turn-on transient below
    ~1e-4 of peak.
    """
    sigma = math.sqrt(2.0 * math.log(10.0)) / (2.0 * math.pi * fc)
    t0 = 4.5 * sigma
    return sigma, t0


def gaussian_excitation(
    f0: float, fc: float, dt: float, n_steps: int
) -> np.ndarray:
    """Waveform s(t_n) = cos(2π f0 (t−t0))·exp(−(t−t0)²/(2σ²)) at the
    engine's injection times t_n = (n + 1/2)·dt — the E half-step where
    the soft source is applied. (Sampling at n·dt would disagree with
    the injected source by half a step, a π·f0·dt phase error in any
    phase-sensitive post-processing.) This is THE waveform; the
    engine consumes it directly."""
    sigma, t0 = gaussian_source_params(f0, fc)
    t = (np.arange(n_steps) + 0.5) * dt
    env = np.exp(-0.5 * ((t - t0) / sigma) ** 2)
    return (np.cos(2.0 * math.pi * f0 * (t - t0)) * env).astype(np.float32)


def source_active_steps(f0: float, fc: float, dt: float) -> int:
    """Number of steps until the source has decayed below ~1e-5 of peak."""
    sigma, t0 = gaussian_source_params(f0, fc)
    return int(math.ceil((t0 + 5.0 * sigma) / dt))
