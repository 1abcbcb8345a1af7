"""Physical constants and closed-form microstrip patch design equations.

Counterpart of ``fdtd_solver_antennas_tpu/physics.py`` in NumPy:
Hammerstad–Jensen effective permittivity / edge extension, TM10 design,
two-slot power pattern and the efficiency heuristic. The numbers are the
same; only the array library of the pattern helpers changed.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np

# Physical constants (SI)
C0 = 299_792_458.0
MU0 = 4.0 * math.pi * 1e-7
EPS0 = 1.0 / (MU0 * C0 * C0)
ETA0 = math.sqrt(MU0 / EPS0)

# Lowercase aliases, the reference's export names
c0 = C0
mu0 = MU0
eps0 = EPS0
eta0 = ETA0


def skin_depth(f_hz: float, sigma_s_per_m: float) -> float:
    """Conductor skin depth δ = √(2/(ωμ0σ)) in meters."""
    return math.sqrt(2.0 / (2.0 * math.pi * f_hz * MU0 * sigma_s_per_m))


def sheet_conductance(
    sigma_s_per_m: float, thickness_m: float, f_hz: float
) -> float:
    """Effective sheet conductance σ·t_eff (S) for thin metallization.

    The current crowds into one skin depth per face, so the effective
    thickness is capped at 2δ (a first-order surface-impedance model).
    """
    t_eff = min(thickness_m, 2.0 * skin_depth(f_hz, sigma_s_per_m))
    return sigma_s_per_m * t_eff


def wavelength(f_hz: float) -> float:
    """Free-space wavelength."""
    return C0 / f_hz


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


def jinc(x):
    """sin(x)/x with the x→0 limit handled."""
    x = np.asarray(x, dtype=float)
    safe = np.where(np.abs(x) > 1e-12, x, 1.0)
    return np.where(np.abs(x) > 1e-12, np.sin(safe) / safe, 1.0)


def rect_patch_power_pattern(L_eff, W, k0, theta, phi):
    """Unnormalized TM10 two-slot power pattern U(θ, φ).

    U = cos²(½k0·L_eff·sinθ·cosφ) · jinc²(½k0·W·sinθ·sinφ)
        · (cos²φ + cos²θ·sin²φ)
    """
    theta = np.asarray(theta, dtype=float)
    phi = np.asarray(phi, dtype=float)
    sin_th = np.sin(theta)
    f_len = np.cos(0.5 * k0 * L_eff * sin_th * np.cos(phi))
    f_wid = jinc(0.5 * k0 * W * sin_th * np.sin(phi))
    pol = np.cos(phi) ** 2 + (np.cos(theta) ** 2) * (np.sin(phi) ** 2)
    return (f_len**2) * (f_wid**2) * pol


def estimate_efficiency(
    eps_r: float,
    loss_tangent: float,
    conductivity_s_per_m: float,
    thickness_m: float,
    frequency_hz: float,
) -> float:
    """Heuristic overall radiation efficiency in [0.5, 0.98]."""
    eta_d = max(0.55, 1.0 - 1.6 * loss_tangent)
    sigma_ratio = min(1.2, conductivity_s_per_m / 5.8e7)
    thickness_ratio = min(1.5, max(0.2, thickness_m / 35e-6))
    freq_ghz = frequency_hz / 1e9
    eta_c = (
        0.93
        * (sigma_ratio**0.2)
        * (thickness_ratio**0.05)
        / (1.0 + 0.02 * math.sqrt(max(0.0, freq_ghz - 1e-9)))
    )
    eta_c = min(0.98, max(0.6, eta_c))
    return max(0.5, min(0.98, eta_d * eta_c))


def substrate_conductivity(
    frequency_hz: float, eps_r: float, loss_tangent: float
) -> float:
    """Equivalent substrate conductivity κ = 2πf·ε0·εr·tanδ."""
    return 2.0 * math.pi * frequency_hz * EPS0 * eps_r * loss_tangent
