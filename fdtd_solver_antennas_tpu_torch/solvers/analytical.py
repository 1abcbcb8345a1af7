"""Analytical cavity/two-slot model solver for rectangular patches.

Counterpart of ``fdtd_solver_antennas_tpu/solvers/analytical.py`` in
NumPy (float64): the full θ×φ directivity grid via
D = 4πU/∬U·sinθ dθdφ, gain = η·D with the heuristic efficiency, E/H-plane
cuts, and the L/W/L_eff/η/D0/G0 summary dict. It serves as the oracle for
FDTD validation.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np

from ..models.params import PatchAntennaParams
from ..physics import (
    C0,
    delta_L,
    design_patch_for_frequency,
    effective_eps,
    estimate_efficiency,
    rect_patch_power_pattern,
    wavelength,
)


@dataclass
class SolverResult:
    theta: np.ndarray
    phi: np.ndarray
    directivity: np.ndarray  # linear, shape (n_theta, n_phi)
    gain: np.ndarray  # linear
    peak_directivity_lin: float
    peak_gain_lin: float


def _pattern_grid(L_eff_m, W_m, k0, num_theta: int, num_phi: int):
    """Directivity grid on a θ×φ mesh."""
    theta = np.linspace(0.0, np.pi, num_theta)
    phi = np.linspace(0.0, 2.0 * np.pi, num_phi)
    th, ph = np.meshgrid(theta, phi, indexing="ij")
    U = rect_patch_power_pattern(L_eff_m, W_m, k0, th, ph)
    # rectangle-rule power integral, the reference's quadrature, so the
    # directivity values agree with it
    dtheta = theta[1] - theta[0]
    dphi = phi[1] - phi[0]
    prad = np.sum(U * np.sin(th)) * dtheta * dphi
    D = 4.0 * np.pi * U / prad
    return theta, phi, D


class AnalyticalPatchSolver:
    """Closed-form TM10 patch solver."""

    def __init__(self, params: PatchAntennaParams):
        self.params = params
        self._resolved_dimensions()

    def _resolved_dimensions(self) -> None:
        p = self.params
        if p.patch_width_m is None or p.patch_length_m is None:
            L, W, eps_eff = design_patch_for_frequency(p.frequency_hz, p.eps_r, p.h_m)
            self.L_m, self.W_m, self.eps_eff = L, W, eps_eff
        else:
            self.L_m = p.patch_length_m
            self.W_m = p.patch_width_m
            self.eps_eff = effective_eps(p.eps_r, p.h_m, p.patch_width_m)
        self.dL_m = delta_L(self.eps_eff, p.h_m, self.W_m)
        self.L_eff_m = self.L_m + 2.0 * self.dL_m

    def efficiency(self) -> float:
        p = self.params
        return estimate_efficiency(
            p.eps_r,
            p.loss_tangent,
            p.metal.conductivity_s_per_m,
            p.metal.thickness_m,
            p.frequency_hz,
        )

    def compute_full_pattern(
        self, num_theta: int = 181, num_phi: int = 361
    ) -> SolverResult:
        k0 = 2.0 * math.pi / wavelength(self.params.frequency_hz)
        theta, phi, D = _pattern_grid(
            self.L_eff_m, self.W_m, k0, num_theta, num_phi
        )
        G = self.efficiency() * D
        return SolverResult(
            theta=theta,
            phi=phi,
            directivity=D,
            gain=G,
            peak_directivity_lin=float(D.max()),
            peak_gain_lin=float(G.max()),
        )

    def cross_section_gain_lin(
        self, plane: str = "E", num_theta: int = 721
    ) -> Tuple[np.ndarray, np.ndarray]:
        """(theta, gain_linear) for φ=0 (E-plane) or φ=90° (H-plane),
        scaled so the cut's peak equals the full pattern's peak gain."""
        theta = np.linspace(0.0, math.pi, num_theta)
        phi_value = 0.0 if plane.upper() == "E" else math.pi / 2.0
        k0 = 2.0 * math.pi * self.params.frequency_hz / C0
        U = rect_patch_power_pattern(
            self.L_eff_m, self.W_m, k0, theta, phi_value)
        full = self.compute_full_pattern(num_theta=361, num_phi=361)
        D_cut = U / U.max() * full.peak_directivity_lin
        eta = full.peak_gain_lin / full.peak_directivity_lin
        return theta, eta * D_cut

    @staticmethod
    def lin_to_dbi(x: np.ndarray) -> np.ndarray:
        return 10.0 * np.log10(np.maximum(1e-16, x))

    def summary(self) -> Dict[str, float]:
        res = self.compute_full_pattern()
        return {
            "L_mm": self.L_m * 1e3,
            "W_mm": self.W_m * 1e3,
            "L_eff_mm": self.L_eff_m * 1e3,
            "efficiency": float(res.peak_gain_lin / res.peak_directivity_lin),
            "D0_dBi": 10.0 * math.log10(res.peak_directivity_lin),
            "G0_dBi": 10.0 * math.log10(res.peak_gain_lin),
        }
