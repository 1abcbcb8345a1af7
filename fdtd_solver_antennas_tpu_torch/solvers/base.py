"""Shared 3-phase solver protocol: probe → prepare → run.

Parity with the reference result dataclasses
(``solver_fdtd_openems_fixed.py:15-42``): every FDTD solver exposes
``probe_*() -> SolverProbe``, ``prepare_*(params, ...) -> SolverPrepared``
and ``run_prepared_*(prepared, frequency_hz) -> FDTDSolverResult``. All
failures return structured ``ok/message`` results instead of raising — the
reference's defensive contract that its GUIs rely on.

A copy of ``fdtd_solver_antennas_tpu/solvers/base.py``. Where the
reference's ``prepare`` builds a C++ CSXCAD structure and its ``run``
enters the openEMS DLL, ours builds the mesh and coefficients as tensors on
a device; ``run`` steps the chunk loop there and post-processes in memory
(no disk artifacts).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np


@dataclass
class SolverProbe:
    """Capability check result (reference: OpenEMSProbe, fixed.py:15-19)."""

    ok: bool
    message: str
    api: Dict[str, List[str]] = field(default_factory=dict)


@dataclass
class FDTDSolverResult:
    """Far-field result (reference: OpenEMSResult, fixed.py:22-30).

    ``intensity`` is a (n_theta, n_phi)-shaped dBi grid when ``is_dBi`` is
    True. Extra diagnostics (S11 sweep, port impedance, timing)
    ride along without breaking the reference surface.
    """

    ok: bool
    message: str
    theta: Optional[np.ndarray] = None  # radians
    phi: Optional[np.ndarray] = None  # radians
    intensity: Optional[np.ndarray] = None
    sim_path: Optional[str] = None  # kept for API parity; always None (in-memory)
    is_dBi: bool = False
    # --- extras (not in the reference result) ---
    freq: Optional[np.ndarray] = None  # S11 sweep frequencies (Hz)
    s11: Optional[np.ndarray] = None  # complex S11(f)
    z_in: Optional[np.ndarray] = None  # complex Zin(f)
    f_res_hz: Optional[float] = None
    Dmax: Optional[float] = None
    radiated_power_w: Optional[float] = None
    radiation_efficiency: Optional[float] = None  # P_rad / P_accepted
    steps_run: Optional[int] = None
    wall_time_s: Optional[float] = None
    mcells_per_s: Optional[float] = None
    diagnostics: Dict[str, Any] = field(default_factory=dict)


@dataclass
class SolverPrepared:
    """Prepared simulation (reference: OpenEMSPrepared, fixed.py:33-42).

    ``sim`` holds the framework's prepared simulation (an
    ``ops.fdtd.PreparedSimulation``); ``theta``/``phi`` are the NF2FF
    sampling angles in degrees, ``nf_center`` the phase center in meters —
    the same contract the reference's runners consume.
    """

    ok: bool
    message: str
    sim: Optional[object] = None
    sim_path: Optional[str] = None  # parity field; unused (in-memory runs)
    theta: Optional[np.ndarray] = None  # degrees
    phi: Optional[np.ndarray] = None  # degrees
    nf_center: Optional[np.ndarray] = None  # meters
    diagnostics: Dict[str, Any] = field(default_factory=dict)


# Energy ratio below which the ring-down is captured well enough for the
# surface DFTs to account for essentially all radiated energy. Runs that
# early-exit at the looser solver defaults (1e-4 / −25 dB) still return an
# efficiency, flagged unconverged (see tests/test_power_balance.py).
RAD_EFF_CONVERGED_RATIO = 1e-6


def radiation_efficiency(ff, spectra, e_ratio: Optional[float] = None):
    """P_rad / ΣP_accepted at the NF2FF frequency, clipped to [0, 1].

    ``spectra`` is one port's spectra or a list of them (multi-port scenes
    sum accepted power). Returns ``(efficiency | None, converged)``: when
    the run's final energy ratio exceeds ``RAD_EFF_CONVERGED_RATIO`` the
    ring-down was truncated and the NF2FF DFTs undercount P_rad, so the
    value is reported but flagged for the caller's diagnostics.
    """
    from ..post.ports import accepted_power

    sp_list = spectra if isinstance(spectra, (list, tuple)) else [spectra]
    p_acc = sum(accepted_power(sp, float(ff.freq_hz[0])) for sp in sp_list)
    converged = e_ratio is None or e_ratio <= RAD_EFF_CONVERGED_RATIO
    if p_acc <= 0:
        return None, converged
    return float(np.clip(ff.P_rad[0] / p_acc, 0.0, 1.0)), converged


# Aliases so reference-code imports keep working verbatim.
OpenEMSProbe = SolverProbe
OpenEMSResult = FDTDSolverResult
OpenEMSPrepared = SolverPrepared
