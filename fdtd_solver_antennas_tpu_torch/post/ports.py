"""Port spectra: S11 / input impedance from in-loop V/I DFTs.

Counterpart of ``fdtd_solver_antennas_tpu/post/ports.py`` (NumPy only):
the lumped-port split and the MSL port's 3-probe deembedding.

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


@dataclass
class MSLPortSpectra(PortSpectra):
    """PortSpectra plus the measured line parameters the 3-probe
    deembedding produces: ``z_line`` (complex characteristic impedance
    estimate per frequency) and ``beta`` (propagation constant, rad/m)."""

    z_line: np.ndarray = None
    beta: np.ndarray = None


def msl_port_spectra(
    freq_hz: np.ndarray,
    uf3_raw: np.ndarray,  # (3, Nf) raw V DFTs at planes m−1, m, m+1
    if2_raw: np.ndarray,  # (2, Nf) raw I DFTs at dual planes m−½, m+½
    dt: float,
    v_pos_m: np.ndarray,  # (3,) V-plane coordinates, meters
    i_pos_m: np.ndarray,  # (2,) I-plane coordinates, meters
    z0_nominal: float = 50.0,
) -> MSLPortSpectra:
    """openEMS-style MSL 3-probe deembedding.

    Centered estimates at the measurement plane m:

        Et  = V(m)                dEt = (V(m+1) − V(m−1)) / (x₂ − x₀)
        Ht  = ½(I(m−½) + I(m+½))  dHt = (I(m+½) − I(m−½)) / (x_{+} − x_{−})

    Telegrapher relations then give the *measured* line parameters
    β = √(−dEt·dHt / (Et·Ht)) and Z_L = √(Et·dEt / (Ht·dHt)), and the
    traveling-wave split uses Z_L (not the nominal 50 Ω):

        uf_inc = ½(Et + Ht·Z_L),  uf_ref = Et − uf_inc,  s11 = uf_ref/uf_inc

    Where the measured Z_L is unusable (DC, band edges with no signal) it
    falls back to ``z0_nominal``.
    """
    freq_hz = np.asarray(freq_hz)
    uf3 = np.asarray(uf3_raw) * dt
    if2 = np.asarray(if2_raw) * dt
    Et = uf3[1]
    dEt = (uf3[2] - uf3[0]) / (v_pos_m[2] - v_pos_m[0])
    Ht = 0.5 * (if2[0] + if2[1])
    dHt = (if2[1] - if2[0]) / (i_pos_m[1] - i_pos_m[0])

    with np.errstate(divide="ignore", invalid="ignore"):
        beta = np.sqrt(-dEt * dHt / (Et * Ht))
        # enforce forward propagation (Re β > 0), openEMS sign convention
        beta = np.where(np.real(beta) < 0, -beta, beta)
        z_line = np.sqrt(Et * dEt / (Ht * dHt))
        # physical line: positive real part; fall back to nominal where
        # the estimate degenerates (no signal / evanescent numerics)
        ok = np.isfinite(z_line) & (np.real(z_line) > 1.0)
        z_line = np.where(ok, z_line, z0_nominal)

        uf_inc = 0.5 * (Et + Ht * z_line)
        uf_ref = Et - uf_inc
        s11 = np.where(np.abs(uf_inc) > 0, uf_ref / uf_inc, 0.0)
        z_in = np.where(np.abs(Ht) > 0, Et / Ht, np.inf)
    return MSLPortSpectra(
        freq_hz=freq_hz,
        uf=Et,
        if_=Ht,
        uf_inc=uf_inc,
        uf_ref=uf_ref,
        s11=s11,
        z_in=z_in,
        z_ref=float(z0_nominal),
        z_line=z_line,
        beta=beta,
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
