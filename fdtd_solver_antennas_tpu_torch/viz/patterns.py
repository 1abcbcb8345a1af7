"""Pure pattern-processing helpers shared by the UIs.

Counterpart of ``fdtd_solver_antennas_tpu/viz/patterns.py``, NumPy only.

Extracted from UI code in the reference so they are testable headlessly:

- ``classify_pattern``: the dynamic-range sanity heuristic the Streamlit
  app shows ("Too isotropic (check physics)" under 3 dB, "Highly
  directional" over 20 dB — streamlit_app.py:283-290);
- ``interpolate_cuts_to_sphere``: build a full (θ, φ) grid from E-plane
  (φ=0°) and H-plane (φ=90°) cuts by piecewise-linear blending over the
  four quadrants (streamlit_app.py:361-388, also used by the desktop GUI's
  synthetic 3D view, gui_app.py:1151-1348);
- ``mirror_half_cut``: extend a 0–180° θ cut to a full 360° polar trace
  (gui_app.py:1113-1149).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def classify_pattern(intensity_db: np.ndarray) -> Tuple[str, float]:
    """Return (label, dynamic_range_db) per the reference's thresholds."""
    arr = np.asarray(intensity_db, dtype=float)
    if arr.size == 0:
        return "No data", 0.0
    dynamic_range = float(arr.max() - arr.min())
    if dynamic_range < 3:
        label = "Too isotropic (check physics)"
    elif dynamic_range > 20:
        label = "Highly directional"
    else:
        label = "Moderately directional"
    return label, dynamic_range


def interpolate_cuts_to_sphere(
    e_plane_db: np.ndarray,
    h_plane_db: np.ndarray,
    num_phi: int = 73,
) -> Tuple[np.ndarray, np.ndarray]:
    """(phi_full_rad, pattern_db[θ, φ]) from two principal-plane cuts.

    Quadrant-wise linear blend: φ∈[0°,90°] blends E→H, [90°,180°] H→E,
    and so on — the reference's exact scheme (streamlit_app.py:361-388).
    """
    e = np.asarray(e_plane_db, float)
    h = np.asarray(h_plane_db, float)
    if e.shape != h.shape:
        raise ValueError("E- and H-plane cuts must have equal length")
    phi_full = np.linspace(0.0, 2.0 * np.pi, num_phi)
    pattern = np.zeros((len(e), num_phi))
    half_pi = np.pi / 2.0
    for i, phi in enumerate(phi_full):
        p = phi % (2.0 * np.pi)
        quadrant = min(3, int(p // half_pi))
        w = (p - quadrant * half_pi) / half_pi
        if quadrant % 2 == 0:  # E → H
            pattern[:, i] = (1 - w) * e + w * h
        else:  # H → E
            pattern[:, i] = (1 - w) * h + w * e
    return phi_full, pattern


def mirror_half_cut(
    theta_rad: np.ndarray, values_db: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Mirror a θ∈[0,π] cut into a full 0..2π polar trace
    (gui_app.py:1113-1149 mirroring for the 2D polar plots)."""
    theta = np.asarray(theta_rad, float)
    vals = np.asarray(values_db, float)
    theta_full = np.concatenate([theta, 2.0 * np.pi - theta[::-1]])
    vals_full = np.concatenate([vals, vals[::-1]])
    return theta_full, vals_full
