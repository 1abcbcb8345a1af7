"""Physical constants and the closed-form patch design equations.

A frozen copy of the port's ``physics.py``, cut to what the reference
uses: Hammerstad–Jensen effective permittivity and edge extension, the
TM10 design and the substrate's equivalent conductivity.
"""

from __future__ import annotations

import math
from typing import Tuple

# Physical constants (SI)
C0 = 299_792_458.0
MU0 = 4.0 * math.pi * 1e-7
EPS0 = 1.0 / (MU0 * C0 * C0)
ETA0 = math.sqrt(MU0 / EPS0)


def effective_eps(eps_r: float, h_m: float, W_m: float) -> float:
    """Hammerstad–Jensen effective permittivity."""
    if W_m <= 0 or h_m <= 0:
        return eps_r
    w_h = W_m / h_m
    return (eps_r + 1.0) / 2.0 + (eps_r - 1.0) / 2.0 / math.sqrt(1.0 + 12.0 / w_h)


def delta_L(eps_eff: float, h_m: float, W_m: float) -> float:
    """Fringing-field edge extension ΔL."""
    if W_m <= 0 or h_m <= 0:
        return 0.0
    w_h = W_m / h_m
    num = (eps_eff + 0.3) * (w_h + 0.264)
    den = (eps_eff - 0.258) * (w_h + 0.8)
    return 0.412 * h_m * num / den


def design_patch_for_frequency(
    f_hz: float, eps_r: float, h_m: float
) -> Tuple[float, float, float]:
    """Design (L, W, eps_eff) for TM10 resonance at ``f_hz``.

    W = c0/(2f)·sqrt(2/(εr+1)); L = c0/(2f·sqrt(ε_eff)) − 2ΔL.
    """
    W = C0 / (2.0 * f_hz) * math.sqrt(2.0 / (eps_r + 1.0))
    eps_eff = effective_eps(eps_r, h_m, W)
    L_eff = C0 / (2.0 * f_hz * math.sqrt(eps_eff))
    L = L_eff - 2.0 * delta_L(eps_eff, h_m, W)
    return L, W, eps_eff


def substrate_conductivity(
    frequency_hz: float, eps_r: float, loss_tangent: float
) -> float:
    """Equivalent substrate conductivity κ = 2πf·ε0·εr·tanδ."""
    return 2.0 * math.pi * frequency_hz * EPS0 * eps_r * loss_tangent
