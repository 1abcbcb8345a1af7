"""Full N-port S-parameter matrix of a prepared multi-port scene.

Counterpart of ``fdtd_solver_antennas_tpu/solvers/sparams.py``. FDTD is
linear, so N runs with one-hot excitations span the excitation space;
every run records the V/I DFTs of every port, so each run gives one
column of S:

    a_j = (V_j + Z_j I_j) / (2 sqrt(Z_j))     at the driven port j
    b_i = (V_i - Z_i I_i) / (2 sqrt(Z_i))     at every port i
    S_ij = b_i / a_j

Undriven ports keep their loads (a lumped port's resistance is folded
into the σ of its cells when the coefficients are built), so they are
matched resistive terminations, the S-parameter boundary condition.

The engine measures V/I along the unsigned grid axis; each port's
physical ground→patch orientation rides in the sign of its prepared
``excite``. The extractor drives each port with its own polarity and
corrects every probe by it, so off-diagonal phases are physical for
rotated or flipped elements and S is reciprocal.

One prepare, then N runs: :func:`ops.fdtd.set_port_excitation` rewrites
the source stamps on the device in place between runs, so the kernels,
their launch plans and the probe table are the same for every run.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np

from ..ops.fdtd import PreparedSimulation, set_port_excitation


@dataclasses.dataclass
class SMatrixResult:
    ok: bool
    message: str
    freq_hz: Optional[np.ndarray] = None
    s: Optional[np.ndarray] = None  # (N, N, Nf) complex
    z_ref: Optional[np.ndarray] = None  # (N,) port reference impedances
    steps_run: int = 0
    wall_time_s: float = 0.0

    def s_db(self) -> np.ndarray:
        """|S| in dB, NaN where a column had no incident energy."""
        with np.errstate(divide="ignore", invalid="ignore"):
            return 20.0 * np.log10(np.abs(self.s))

    def reciprocity_error(self) -> float:
        """max |S_ij − S_ji| over ports and frequencies (0 for an ideal
        reciprocal network; grows with truncated ring-down / mesh error)."""
        return float(np.nanmax(np.abs(self.s - self.s.transpose(1, 0, 2))))

    def passivity_margin(self) -> float:
        """max singular value of S over frequency (≤ 1 for a passive
        network up to numerical/truncation error)."""
        worst = 0.0
        for k in range(self.s.shape[2]):
            m = self.s[:, :, k]
            if np.isfinite(m).all():
                worst = max(worst, float(np.linalg.svd(m, compute_uv=False)[0]))
        return worst


def _port_polarities(sim: PreparedSimulation) -> np.ndarray:
    pols = []
    for p in list(sim.ports) + list(sim.msl_ports):
        e = float(getattr(p.spec, "excite", 1.0))
        pols.append(1.0 if e == 0.0 else float(np.sign(e)))
    return np.asarray(pols)


def compute_s_matrix(
    prep_or_sim,
    *,
    restore: bool = True,
    progress_cb=None,
    on_run=None,
    abort_cb=None,
    step_progress_cb=None,
) -> SMatrixResult:
    """Extract the (N, N, Nf) S-parameter matrix of a prepared scene.

    ``prep_or_sim`` is a solver ``SolverPrepared`` (its ``.sim`` is used)
    or a ``PreparedSimulation``. The simulation's ``port_freqs_hz`` grid
    defines Nf. With ``restore`` (default) the original excitation
    amplitudes are put back afterwards, even after an abort or an error.

    MSL ports are refused (their 3-probe deembedding rows would need
    per-plane polarity bookkeeping); prepare the scene with lumped ports.

    ``on_run(j, out, a_j)`` is called after each one-hot run with the
    driven port's index, the run's output dict (with the NF2FF surface
    accumulators) and the polarity-corrected incident-wave spectrum
    ``a_j`` on ``sim.port_freqs_hz``: the embedded-pattern extractor
    (``solvers.array_synth``) shares these N runs through it.
    ``progress_cb(done, n)`` is called after each run.

    ``abort_cb() -> bool`` is passed to every run (checked after every
    chunk) and checked between runs; an abort returns ``ok=False``.
    ``step_progress_cb(steps_done, n_steps_max, e_ratio)`` is passed to
    each run as its ``progress_cb``.
    """
    sim = getattr(prep_or_sim, "sim", prep_or_sim)
    if sim is None:
        return SMatrixResult(False, "prepared simulation missing (prepare failed?)")
    if getattr(sim, "msl_ports", ()):
        return SMatrixResult(
            False, "S-matrix extraction supports lumped ports only"
        )
    ports = list(sim.ports)
    n = len(ports)
    if n == 0:
        return SMatrixResult(False, "scene has no ports")

    freqs = np.asarray(sim.port_freqs_hz)
    pol = _port_polarities(sim)
    z = np.asarray([float(p.spec.resistance) for p in ports])
    rz = np.sqrt(z)
    orig = [float(p.spec.excite) for p in ports]

    S = np.full((n, n, len(freqs)), np.nan + 0j, np.complex128)
    steps = 0
    t0 = time.time()
    try:
        for j in range(n):
            if abort_cb is not None and abort_cb():
                return SMatrixResult(
                    False, f"aborted before one-hot run {j + 1}/{n}"
                )
            one_hot = np.zeros(n)
            one_hot[j] = pol[j]
            set_port_excitation(sim, one_hot)
            out = sim.run(progress_cb=step_progress_cb, abort_cb=abort_cb)
            if out.get("aborted"):
                return SMatrixResult(
                    False, f"aborted during one-hot run {j + 1}/{n}"
                )
            steps = max(steps, int(out["steps"]))
            # polarity-corrected spectra in each port's own reference
            uf = np.asarray(out["uf"])[:n] * pol[:, None]
            if_ = np.asarray(out["if_"])[:n] * pol[:, None]
            a_j = 0.5 * (uf[j] + z[j] * if_[j]) / rz[j]
            b = 0.5 * (uf - z[:, None] * if_) / rz[:, None]
            with np.errstate(divide="ignore", invalid="ignore"):
                S[:, j, :] = np.where(np.abs(a_j) > 0, b / a_j, np.nan + 0j)
            if on_run is not None:
                on_run(j, out, a_j)
            if progress_cb is not None:
                try:
                    progress_cb(j + 1, n)
                except Exception:
                    pass
    finally:
        if restore:
            set_port_excitation(sim, orig)

    return SMatrixResult(
        True,
        f"S matrix: {n} ports × {len(freqs)} frequencies "
        f"({n} one-hot runs)",
        freq_hz=freqs,
        s=S,
        z_ref=z,
        steps_run=steps,
        wall_time_s=time.time() - t0,
    )
