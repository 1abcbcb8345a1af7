"""Embedded element patterns and phased-array synthesis.

Counterpart of ``fdtd_solver_antennas_tpu/solvers/array_synth.py``. The N
one-hot runs of the S-matrix extractor (``solvers/sparams.py``) give the
scene's **embedded element patterns**: each port's far field per unit
incident root-power wave, with all mutual coupling, the finite ground
plane and the neighbours' scattering in it. The far field of any complex
port weighting then follows without another FDTD run:

    E(θ,φ; w) = Σ_j w_j · ê_j(θ,φ),      ê_j = E_j / a_j

FDTD is linear, so this is exact: beam steering, amplitude taper and
phase-error studies cost one tensor contraction each. Directivity and
realized gain of a synthesized pattern come from sphere quadrature of
the radiation intensity and from the incident power ½Σ|w_j|².

Weights use the peak-phasor root-power convention: ``w_j`` is the
incident wave a_j at port j in √W, so P_inc = ½·Σ|w_j|². ``a_inc`` holds
the incident spectra of the one-hot runs, so a physical excitation (the
all-in-phase drive) can be expressed exactly in the same basis.

Everything here runs on the host in NumPy, apart from the runs and the
near-to-far-field integrals, which run on the simulation's device.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np

from ..physics import C0, ETA0
from ..post.nf2ff import nf2ff_transform, select_face_freqs
from .sparams import SMatrixResult, compute_s_matrix


def _sphere_quadrature(theta: np.ndarray, phi: np.ndarray):
    """Quadrature weights w[t, p] with ∮ f dΩ ≈ Σ w·f, plus a flag for
    grids that do not span the full sphere (their integrals are partial).

    θ uses trapezoid weights on sinθ; φ uses uniform Δφ when the grid is
    an evenly spaced full circle without a duplicated endpoint (the
    solvers' 0..355° convention), trapezoid otherwise.
    """
    theta = np.asarray(theta, float)
    phi = np.asarray(phi, float)

    def trapw(x):
        w = np.zeros_like(x)
        if len(x) > 1:
            d = np.diff(x)
            w[:-1] += d / 2
            w[1:] += d / 2
        return w

    wt = trapw(theta) * np.sin(theta)
    full_theta = theta.min() < 1e-6 and theta.max() > np.pi - 1e-3

    if len(phi) > 1:
        dphi = np.diff(phi)
        even = np.allclose(dphi, dphi[0], rtol=1e-6)
        wraps = even and abs((phi[-1] + dphi[0]) - (phi[0] + 2 * np.pi)) < 1e-6
    else:
        even = wraps = False
    if wraps:
        wp = np.full(len(phi), float(np.diff(phi)[0]))
        full_phi = True
    else:
        wp = trapw(phi)
        full_phi = len(phi) > 1 and (phi.max() - phi.min()) > 2 * np.pi - 1e-3
    return wt[:, None] * wp[None, :], not (full_theta and full_phi)


@dataclasses.dataclass
class ArrayPattern:
    """Far field of one synthesized port weighting at one frequency."""

    freq_hz: float
    theta: np.ndarray  # radians (nth,)
    phi: np.ndarray  # radians (nph,)
    weights: np.ndarray  # (N,) complex, √W incident waves
    E_theta: np.ndarray  # (nth, nph) complex at r = 1 m
    E_phi: np.ndarray
    U: np.ndarray  # (nth, nph) radiation intensity, W/sr
    P_rad: float  # sphere-quadrature radiated power, W
    P_inc: float  # ½ Σ|w|², W
    partial_sphere: bool  # True → P_rad (hence D) is partial-sphere

    @property
    def E_norm(self) -> np.ndarray:
        return np.sqrt(np.abs(self.E_theta) ** 2 + np.abs(self.E_phi) ** 2)

    @property
    def directivity(self) -> np.ndarray:
        """Linear directivity grid 4πU/P_rad."""
        if self.P_rad <= 0:
            return np.zeros_like(self.U)
        return 4.0 * np.pi * self.U / self.P_rad

    @property
    def realized_gain(self) -> np.ndarray:
        """Linear realized gain 4πU/P_inc (includes mismatch + coupling
        loss — the array designer's figure of merit)."""
        if self.P_inc <= 0:
            return np.zeros_like(self.U)
        return 4.0 * np.pi * self.U / self.P_inc

    def directivity_dbi(self) -> np.ndarray:
        return 10.0 * np.log10(np.maximum(self.directivity, 1e-30))

    def realized_gain_dbi(self) -> np.ndarray:
        return 10.0 * np.log10(np.maximum(self.realized_gain, 1e-30))

    def peak_direction_deg(self):
        """(θ°, φ°) of the intensity peak."""
        t, p = np.unravel_index(int(np.argmax(self.U)), self.U.shape)
        return float(np.degrees(self.theta[t])), float(np.degrees(self.phi[p]))


@dataclasses.dataclass
class EmbeddedPatternSet:
    ok: bool
    message: str
    freq_hz: Optional[np.ndarray] = None  # (nfsel,) transformed freqs
    theta: Optional[np.ndarray] = None  # radians (nth,)
    phi: Optional[np.ndarray] = None  # radians (nph,)
    # (N, nfsel, nth, nph) complex — far field at r=1 m per unit incident
    # wave (1 √W) at that port, everything else matched-terminated
    e_theta: Optional[np.ndarray] = None
    e_phi: Optional[np.ndarray] = None
    a_inc: Optional[np.ndarray] = None  # (N, nfsel) one-hot-run incident waves
    port_centers_m: Optional[np.ndarray] = None  # (N, 3)
    smatrix: Optional[SMatrixResult] = None  # from the same N runs
    wall_time_s: float = 0.0

    @property
    def n_ports(self) -> int:
        return 0 if self.e_theta is None else self.e_theta.shape[0]

    def synthesize(self, weights, fi: int = 0) -> ArrayPattern:
        """Far field of incident-wave weighting ``weights`` (N complex,
        √W) at frequency row ``fi`` — a tensor contraction, no FDTD."""
        w = np.asarray(weights, complex).ravel()
        if w.shape != (self.n_ports,):
            raise ValueError(f"expected {self.n_ports} weights, got {w.shape}")
        Eth = np.tensordot(w, self.e_theta[:, fi], axes=(0, 0))
        Eph = np.tensordot(w, self.e_phi[:, fi], axes=(0, 0))
        U = (np.abs(Eth) ** 2 + np.abs(Eph) ** 2) / (2.0 * ETA0)
        quad, partial = _sphere_quadrature(self.theta, self.phi)
        return ArrayPattern(
            freq_hz=float(self.freq_hz[fi]),
            theta=self.theta,
            phi=self.phi,
            weights=w,
            E_theta=Eth,
            E_phi=Eph,
            U=U,
            P_rad=float(np.sum(quad * U)),
            P_inc=0.5 * float(np.sum(np.abs(w) ** 2)),
            partial_sphere=partial,
        )

    def steering_weights(
        self,
        theta_deg: float,
        phi_deg: float,
        fi: int = 0,
        kind: str = "conjugate",
    ) -> np.ndarray:
        """Weights that point the beam at (θ°, φ°), normalized to the
        same incident power as all-ones (Σ|w|² = N).

        ``kind="conjugate"``: generalized conjugate-field match at the
        nearest grid direction — the leading eigenvector of the rank-2
        intensity matrix ê_θê_θᴴ + ê_φê_φᴴ, which maximizes the total
        radiation intensity U(θ₀,φ₀) over all equal-power weightings
        (Rayleigh quotient; reduces to conj(ê) of the dominant
        polarization when the other vanishes), automatically
        compensating mutual coupling and element pattern differences.
        ``kind="geometric"``: classic progressive phase e^{−jk r̂₀·r_j}
        from the port center positions (no coupling compensation; what
        a hardware phase shifter would do).
        """
        n = self.n_ports
        ti = int(np.argmin(np.abs(np.degrees(self.theta) - theta_deg)))
        pi = int(np.argmin(np.abs(np.degrees(self.phi) - phi_deg)))
        if kind == "conjugate":
            eth = self.e_theta[:, fi, ti, pi]
            eph = self.e_phi[:, fi, ti, pi]
            if not (np.any(np.abs(eth) > 0) or np.any(np.abs(eph) > 0)):
                return np.ones(n, complex)
            # U(w) ∝ |ethᵀw|² + |ephᵀw|² = wᴴ A w with the PSD rank-≤2
            # matrix below; the top eigenvector maximizes the Rayleigh
            # quotient (its global phase is arbitrary — U is invariant)
            a = np.outer(np.conj(eth), eth) + np.outer(np.conj(eph), eph)
            _, vecs = np.linalg.eigh(a)
            w = vecs[:, -1]
        elif kind == "geometric":
            th, ph = np.radians(theta_deg), np.radians(phi_deg)
            rhat = np.array(
                [np.sin(th) * np.cos(ph), np.sin(th) * np.sin(ph), np.cos(th)]
            )
            k = 2.0 * np.pi * float(self.freq_hz[fi]) / C0
            w = np.exp(-1j * k * (self.port_centers_m @ rhat))
        else:
            raise ValueError(f"unknown steering kind {kind!r}")
        return w * np.sqrt(n / np.sum(np.abs(w) ** 2))


def compute_embedded_patterns(
    prep_or_sim,
    *,
    theta_deg=None,
    phi_deg=None,
    freq_idx=None,
    center_m=None,
    restore: bool = True,
    progress_cb=None,
    abort_cb=None,
    step_progress_cb=None,
) -> EmbeddedPatternSet:
    """Extract embedded element patterns (and the S matrix) of a
    prepared multi-port scene from N one-hot FDTD runs.

    ``theta_deg``/``phi_deg`` default to a full 5°-step sphere (0..180 ×
    0..355) so synthesized directivities are properly normalized.
    ``freq_idx`` selects rows of ``sim.nf_freqs_hz`` (default: all).
    The incident-wave normalization interpolates each run's driven-port
    spectrum from ``sim.port_freqs_hz`` onto the selected NF2FF
    frequencies, so the port grid must cover them.
    """
    sim = getattr(prep_or_sim, "sim", prep_or_sim)
    if sim is None:
        return EmbeddedPatternSet(False, "prepared simulation missing")
    theta_deg = np.arange(0.0, 181.0, 5.0) if theta_deg is None else np.asarray(theta_deg, float)
    phi_deg = np.arange(0.0, 360.0, 5.0) if phi_deg is None else np.asarray(phi_deg, float)
    nf_all = np.asarray(sim.nf_freqs_hz, float)
    sel = (np.arange(len(nf_all)) if freq_idx is None
           else np.atleast_1d(np.asarray(freq_idx, int)))
    if sel.size == 0 or sel.min() < 0 or sel.max() >= len(nf_all):
        return EmbeddedPatternSet(
            False,
            f"freq_idx must index rows of nf_freqs_hz (0..{len(nf_all) - 1})",
        )
    freqs = nf_all[sel]
    pf = np.asarray(sim.port_freqs_hz, float)
    if freqs.min() < pf.min() - 1e-3 or freqs.max() > pf.max() + 1e-3:
        return EmbeddedPatternSet(
            False,
            "selected NF2FF frequencies fall outside port_freqs_hz — the "
            "incident-wave normalization cannot be interpolated",
        )

    t0 = time.time()
    fields = {}

    def on_run(j, out, a_raw):
        ff = nf2ff_transform(
            sim.faces,
            select_face_freqs(out["nf_e"], sel),
            select_face_freqs(out["nf_h"], sel),
            sim.dft_dt,
            freqs,
            theta_deg,
            phi_deg,
            center_m=center_m,
            device=sim.device,
        )
        # physical incident spectrum on the selected NF2FF frequencies
        a_phys = np.asarray(a_raw) * sim.dft_dt
        a = np.interp(freqs, pf, a_phys.real) + 1j * np.interp(
            freqs, pf, a_phys.imag
        )
        fields[j] = (ff, a)

    sm = compute_s_matrix(
        sim, restore=restore, progress_cb=progress_cb, on_run=on_run,
        abort_cb=abort_cb, step_progress_cb=step_progress_cb,
    )
    if not sm.ok:
        return EmbeddedPatternSet(False, sm.message)

    n = len(fields)
    ff0 = fields[0][0]
    nth, nph = len(ff0.theta), len(ff0.phi)
    eth = np.zeros((n, len(freqs), nth, nph), complex)
    eph = np.zeros_like(eth)
    a_inc = np.zeros((n, len(freqs)), complex)
    for j in range(n):
        ff, a = fields[j]
        bad = np.abs(a) <= 0
        a_safe = np.where(bad, 1.0, a)
        eth[j] = np.where(bad[:, None, None], np.nan, ff.E_theta / a_safe[:, None, None])
        eph[j] = np.where(bad[:, None, None], np.nan, ff.E_phi / a_safe[:, None, None])
        a_inc[j] = a

    centers = np.array(
        [
            (np.asarray(p.spec.start, float) + np.asarray(p.spec.stop, float))
            / 2.0
            * 1e-3
            for p in sim.ports
        ]
    )
    return EmbeddedPatternSet(
        True,
        f"embedded patterns: {n} ports × {len(freqs)} frequencies × "
        f"{nth}×{nph} angles",
        freq_hz=freqs,
        theta=ff0.theta,
        phi=ff0.phi,
        e_theta=eth,
        e_phi=eph,
        a_inc=a_inc,
        port_centers_m=centers,
        smatrix=sm,
        wall_time_s=time.time() - t0,
    )


def pick_resonance(sm: SMatrixResult, f0_hz: float, gate_db: float = -10.0):
    """Array synthesis frequency: the mean active-port return-loss dip.

    Applies the reference's resonance contract (the dip must clear
    −10 dB, ``solver_fdtd_openems_microstrip.py:406-424``) to the mean
    of the S-matrix diagonal; without the gate, band-edge noise wins the
    argmin on coarse meshes. Returns ``(f_hz, resonant)`` —
    ``resonant=False`` means no dip cleared the gate and ``f0_hz`` (the
    design frequency) is returned instead.
    """
    diag_db = 20.0 * np.log10(
        np.maximum(np.abs(np.einsum("iif->if", sm.s)), 1e-12)
    )
    mean_db = diag_db.mean(axis=0)
    cand = np.where(mean_db < gate_db)[0]
    if cand.size == 0:
        return float(f0_hz), False
    return float(sm.freq_hz[cand[np.argmin(mean_db[cand])]]), True


@dataclasses.dataclass
class ArrayDesignResult:
    """One-stop nx×ny patch-array characterization (``design_array``)."""

    ok: bool
    message: str
    patterns: Optional[EmbeddedPatternSet] = None
    prep: Optional[object] = None  # the multi-patch SolverPrepared
    spacing_mm: float = 0.0
    margin_mm: float = 0.0  # per-element substrate margin actually used
    feed_mm: float = 0.0  # feed-line stub length actually used
    f_synth_hz: float = 0.0  # synthesis frequency (resonance or design f0)
    fi: int = 0  # row of patterns.freq_hz nearest f_synth_hz
    resonant: bool = False  # True when a mean-S11 dip cleared −10 dB

    @property
    def smatrix(self) -> Optional[SMatrixResult]:
        return None if self.patterns is None else self.patterns.smatrix

    def synthesize(self, weights) -> ArrayPattern:
        """Pattern of ``weights`` at the synthesis frequency row."""
        return self.patterns.synthesize(weights, fi=self.fi)

    def steer(self, theta_deg: float, phi_deg: float,
              kind: str = "conjugate") -> ArrayPattern:
        """Steered beam at the synthesis frequency row."""
        w = self.patterns.steering_weights(
            theta_deg, phi_deg, fi=self.fi, kind=kind
        )
        return self.patterns.synthesize(w, fi=self.fi)


def array_run_summary(
    design: "ArrayDesignResult",
    steer_theta_deg: float,
    steer_phi_deg: float,
    kind: str = "conjugate",
):
    """Synthesize broadside + steered beams and collect headline numbers.

    Used by the CLI's ``array`` command.
    Returns ``(summary_dict, broadside, steered, weights)``.
    """
    eps = design.patterns
    n = eps.n_ports
    broadside = design.synthesize(np.ones(n, complex))
    w_steer = eps.steering_weights(
        steer_theta_deg, steer_phi_deg, fi=design.fi, kind=kind
    )
    steered = eps.synthesize(w_steer, fi=design.fi)
    sm = eps.smatrix
    fj = int(np.argmin(np.abs(sm.freq_hz - eps.freq_hz[design.fi])))
    s_db = 20.0 * np.log10(np.maximum(np.abs(sm.s[:, :, fj]), 1e-12))
    off_diag = s_db[~np.eye(n, dtype=bool)]
    summary = {
        "n_ports": n,
        "synth_freq_ghz": float(eps.freq_hz[design.fi]) / 1e9,
        "f_res_ghz": design.f_synth_hz / 1e9,
        "resonant": design.resonant,
        "spacing_mm": design.spacing_mm,
        "s11_db": [float(s_db[k, k]) for k in range(n)],
        "max_coupling_db": float(off_diag.max()) if n > 1 else None,
        "broadside_gain_dbi": float(broadside.realized_gain_dbi().max()),
        "broadside_peak_deg": broadside.peak_direction_deg(),
        "steered_gain_dbi": float(steered.realized_gain_dbi().max()),
        "steered_peak_deg": steered.peak_direction_deg(),
        "steering_weights": [[float(w.real), float(w.imag)] for w in w_steer],
    }
    return summary, broadside, steered, w_steer


def design_array(
    params,
    nx: int = 2,
    ny: int = 1,
    spacing_mm: Optional[float] = None,
    *,
    mesh_quality: int = 3,
    theta_step_deg: float = 5.0,
    phi_step_deg: float = 5.0,
    verbose: int = 0,
    progress_cb=None,
    abort_cb=None,
    log_cb=None,
    device="cuda",
) -> ArrayDesignResult:
    """Prepare an nx×ny patch array and extract its embedded patterns.

    The array workflow of the CLI's ``array`` command: place nx×ny
    copies of ``params`` on a ``spacing_mm`` pitch (default free-space
    λ0/2), auto-fit each element's substrate margin and feed stub to the
    pitch (the reference-faithful 30 mm margin from
    ``solver_fdtd_openems_microstrip.py:137`` only fits pitches
    > ~115 mm), run one FDTD per port, and pick the synthesis frequency
    by the measured mean-S11 resonance (``pick_resonance``).

    ``progress_cb(done_runs, total_runs, ratio)`` reports overall
    progress with sub-run resolution (ratio advances inside each run);
    ``abort_cb() -> bool`` cancels mid-flight (checked after every
    chunk). The runs go on ``device``: the card by default, ``"cpu"``
    for the plain PyTorch twins.
    """
    # local imports: frontends.designer imports solvers — avoid a cycle
    from ..frontends.designer import PatchInstance
    from .multi_patch_3d import _patch_dims_mm, prepare_multi_patch_3d

    def _log(msg: str) -> None:
        if log_cb is not None:
            log_cb(msg)
        elif verbose:
            print(msg)

    if nx < 1 or ny < 1:
        return ArrayDesignResult(False, "nx and ny must be >= 1")
    d_mm = spacing_mm
    if d_mm is None:
        d_mm = C0 / float(params.frequency_hz) / 2.0 * 1e3
    d_mm = float(d_mm)

    patch_W_mm, patch_L_mm, _ = _patch_dims_mm(params)
    # tightest inter-element gap along either populated axis (the patch
    # is W wide along x and L long along y in local coordinates)
    gaps = []
    if nx > 1:
        gaps.append(d_mm - patch_W_mm)
    if ny > 1:
        gaps.append(d_mm - patch_L_mm)
    gap = min(gaps) if gaps else float("inf")
    if gap <= 4.0:
        return ArrayDesignResult(
            False,
            f"spacing {d_mm:.1f} mm leaves only {gap:.1f} mm between "
            f"patch edges (patch is {patch_W_mm:.1f}×{patch_L_mm:.1f} mm)"
            " — increase the pitch",
            spacing_mm=d_mm,
        )
    margin_mm = float(min(30.0, 0.35 * gap))
    feed_mm = float(min(20.0, max(2.0, 0.7 * gap - margin_mm)))
    if margin_mm < 30.0:
        _log(
            f"pitch {d_mm:.1f} mm: element margin {margin_mm:.1f} mm, "
            f"feed stub {feed_mm:.1f} mm (auto-shrunk to fit)"
        )

    patches = [
        PatchInstance(
            name=f"p{i}{j}",
            params=params,
            center_x_m=(i - (nx - 1) / 2.0) * d_mm * 1e-3,
            center_y_m=(j - (ny - 1) / 2.0) * d_mm * 1e-3,
        )
        for i in range(nx)
        for j in range(ny)
    ]
    prep = prepare_multi_patch_3d(
        patches,
        device=device,
        mesh_quality=mesh_quality,
        verbose=verbose,
        element_margin_mm=margin_mm,
        feed_line_length_mm=feed_mm,
        log_cb=log_cb,
    )
    if not prep.ok:
        return ArrayDesignResult(
            False, f"prepare failed: {prep.message}",
            spacing_mm=d_mm, margin_mm=margin_mm, feed_mm=feed_mm,
        )

    n_total = nx * ny
    run_state = {"done": 0}

    def _run_progress(j, n):
        run_state["done"] = int(j)
        if progress_cb is not None:
            try:
                progress_cb(int(j), int(n), j / max(n, 1))
            except Exception:
                pass

    def _step_progress(steps_done, n_steps_max, e_ratio):
        if progress_cb is not None:
            frac = min(steps_done / max(n_steps_max, 1), 1.0)
            try:
                progress_cb(
                    run_state["done"], n_total,
                    (run_state["done"] + frac) / n_total,
                )
            except Exception:
                pass

    eps = compute_embedded_patterns(
        prep,
        theta_deg=np.arange(0.0, 181.0, float(theta_step_deg)),
        phi_deg=np.arange(0.0, 360.0, float(phi_step_deg)),
        progress_cb=_run_progress,
        abort_cb=abort_cb,
        step_progress_cb=_step_progress,
    )
    if not eps.ok:
        return ArrayDesignResult(
            False, f"extraction failed: {eps.message}",
            prep=prep, spacing_mm=d_mm, margin_mm=margin_mm, feed_mm=feed_mm,
        )

    f_res, resonant = pick_resonance(eps.smatrix, float(params.frequency_hz))
    fi = int(np.argmin(np.abs(eps.freq_hz - f_res)))
    if not resonant:
        _log(
            "no mean-S11 dip cleared -10 dB; synthesizing at the design "
            f"frequency {params.frequency_hz / 1e9:.3f} GHz"
        )
    return ArrayDesignResult(
        True,
        f"array {nx}×{ny}: {eps.message}",
        patterns=eps,
        prep=prep,
        spacing_mm=d_mm,
        margin_mm=margin_mm,
        feed_mm=feed_mm,
        f_synth_hz=f_res,
        fi=fi,
        resonant=resonant,
    )
