"""Port spectra: S11 / input impedance from in-loop V/I DFTs.

Counterpart of ``fdtd_solver_antennas_tpu/post/ports.py`` for lumped
ports (NumPy only; the MSL deembedding is not ported yet).

Replaces openEMS's ``port.CalcPort(sim_path, f)`` disk round-trip
(reference: ``solver_fdtd_openems_microstrip.py:406-424``) with pure array
math on the DFT accumulators the time loop produced. The incident/reflected
decomposition follows the same contract the reference relies on:

    uf_inc = ½·(uf + Z_ref·if),  uf_ref = uf − uf_inc,  s11 = uf_ref/uf_inc

and resonance = argmin |S11| subject to S11 < −10 dB, else the target
frequency.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np


@dataclass
class PortSpectra:
    freq_hz: np.ndarray
    uf: np.ndarray  # total voltage spectrum (complex)
    if_: np.ndarray  # total current spectrum (complex)
    uf_inc: np.ndarray
    uf_ref: np.ndarray
    s11: np.ndarray
    z_in: np.ndarray
    z_ref: float


def port_spectra(
    freq_hz: np.ndarray,
    uf_raw: np.ndarray,
    if_raw: np.ndarray,
    dt: float,
    z_ref: float = 50.0,
) -> PortSpectra:
    """Assemble spectra from raw DFT sums (one port).

    ``uf_raw``/``if_raw`` are Σ x(t_n)·e^{−jωt_n}; multiplying by dt turns
    them into continuous-time Fourier estimates. The half-step offset
    between V (E-grid times) and I (H-grid times) is already encoded in the
    accumulation phases.
    """
    freq_hz = np.asarray(freq_hz)
    uf = np.asarray(uf_raw) * dt
    if_ = np.asarray(if_raw) * dt
    uf_inc = 0.5 * (uf + z_ref * if_)
    uf_ref = uf - uf_inc
    with np.errstate(divide="ignore", invalid="ignore"):
        # bins with NO incident energy carry no S11 information: NaN
        # (0.0 would read as a perfect −∞ dB match and find_resonance /
        # sweep minima would confidently report fake resonances there;
        # NaN fails every < comparison, so dead ports surface loudly)
        s11 = np.where(np.abs(uf_inc) > 0, uf_ref / uf_inc, np.nan)
        z_in = np.where(np.abs(if_) > 0, uf / if_, np.inf)
    return PortSpectra(
        freq_hz=freq_hz,
        uf=uf,
        if_=if_,
        uf_inc=uf_inc,
        uf_ref=uf_ref,
        s11=s11,
        z_in=z_in,
        z_ref=z_ref,
    )


def accepted_power(spectra: PortSpectra, f_hz: float) -> float:
    """Time-averaged power accepted by the antenna at ``f_hz``:
    P_acc = ½·Re{V(f)·I*(f)} at the nearest sweep frequency.

    Shares the DFT scaling of the NF2FF spectra, so
    ``P_rad(f) / P_acc(f)`` is the radiation efficiency — the FDTD
    counterpart of the reference's closed-form efficiency heuristic
    (physics.py:84-93), now computed from actual metal/dielectric losses.
    """
    i = int(np.argmin(np.abs(spectra.freq_hz - f_hz)))
    return float(0.5 * np.real(spectra.uf[i] * np.conj(spectra.if_[i])))


def find_resonance(
    spectra: PortSpectra, target_hz: float, threshold_db: float = -10.0
) -> Tuple[float, Optional[float]]:
    """(f_res, s11_db_at_res) with the reference's selection rule
    (microstrip.py:416-424): minimum S11 if it clears −10 dB, else target."""
    s11_db = 20.0 * np.log10(np.maximum(np.abs(spectra.s11), 1e-30))
    i_min = int(np.argmin(s11_db))
    if s11_db[i_min] < threshold_db:
        return float(spectra.freq_hz[i_min]), float(s11_db[i_min])
    return float(target_hz), None
