"""Gradient-based (adjoint) patch metallization design: inverse design.

Counterpart of ``fdtd_solver_antennas_tpu/solvers/inverse.py``. The FDTD
time loop is differentiated with reverse-mode autodiff (here
``torch.autograd``), so a continuous metallization density on the patch
plane is optimized directly against the port spectrum or the broadside
realized gain.

- A **base scene** (substrate, ground, lumped feed port: everything but
  the patch metal) is built once through :func:`ops.fdtd.build_simulation`.
- The design region is a rectangle on the substrate top plane. A density
  image ``rho ∈ [0,1]^(Ni,Nj)`` (one pixel per primary mesh cell) scales
  the tangential-E update coefficients there, ``ca/cb → (1 − m)·base``,
  ``m`` being ``rho`` resampled onto the staggered Ex/Ey positions.
  ``m = 1`` gives the voxelizer's PEC sheet stamp (``ca = cb = 0``)
  exactly, so a binarized density is bit-identical to stamping metal.
- The forward model runs the engine's exposed step
  (:class:`ops.fdtd.ExposedStep`: the same H/E update, boundaries and port
  source as every run, written out of place) for a **fixed** number of
  steps, with ``torch.utils.checkpoint`` over chunks of ``remat_chunk``
  steps, so the reverse pass stores one carry per chunk and recomputes
  the steps inside it. Port V/I are DFT-accumulated at the loss
  frequencies every step; S11 follows the engine's contract
  (``uf_inc = ½(uf + Z·if)``, ``s11 = uf_ref/uf_inc``).
- The gradient of ``loss(rho)`` is the adjoint field solution: one
  reverse sweep gives the sensitivity of the whole band to every pixel.

The differentiated loop runs PyTorch's operations on the simulation's
device, not a hand-written kernel: the JAX package runs XLA ops there too
(its Pallas kernels are not differentiated). The workflow is optimize →
threshold → :meth:`InverseDesignProblem.validate`, which re-runs the
binary design through the standard engine (K1's ``chunk_steps`` on the
card) with energy-criterion termination.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..models.params import PatchAntennaParams
from ..models.scene import Scene
from ..ops.fdtd import ExposedStep, FDTDConfig, PreparedSimulation, build_simulation
from ..ops.mesh import MeshBuilder
from ..physics import C0, ETA0, design_patch_for_frequency, substrate_conductivity
from ..post.ports import find_resonance, port_spectra


@dataclass
class DesignRegion:
    """Index bookkeeping of the rectangular design region.

    The region spans primary cells ``i0..i1-1`` × ``j0..j1-1`` on plane
    ``k`` (mesh-line indices; ``i1``/``j1`` are the exclusive cell ends =
    inclusive node ends). A PEC sheet over the full region stamps
    tangential-E cells:

        ex: i ∈ [i0, i1),  j ∈ [j0, j1]   (x-edges: cell in x, node in y)
        ey: i ∈ [i0, i1],  j ∈ [j0, j1)   (y-edges: node in x, cell in y)
    """

    i0: int
    i1: int
    j0: int
    j1: int
    k: int
    x_mm: Tuple[float, float]
    y_mm: Tuple[float, float]

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.i1 - self.i0, self.j1 - self.j0)


def _cell_to_ex_ey(rho: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Resample a cell-centered density onto Ex / Ey staggered positions.

    Interior staggered nodes average the two adjacent cells; boundary
    nodes copy the single available cell, so ``rho ≡ 1`` maps to exactly
    1 everywhere (PEC parity) and ``rho ≡ 0`` to 0 (no metal).
    Ex: (Ni, Nj+1) — cell in x, node in y. Ey: (Ni+1, Nj).
    """
    mex = torch.cat(
        [rho[:, :1], 0.5 * (rho[:, 1:] + rho[:, :-1]), rho[:, -1:]], dim=1)
    mey = torch.cat(
        [rho[:1, :], 0.5 * (rho[1:, :] + rho[:-1, :]), rho[-1:, :]], dim=0)
    return mex, mey


def _pattern_consts(faces, theta_deg, phi_deg, f0_hz: float, device) -> dict:
    """Constants of the differentiable far-field evaluation, on ``device``.

    Reuses the engine transform's geometry and angle assembly
    (``post/nf2ff.py::_face_geometry`` / ``_angles``), so the traced
    transform below cannot drift from the validated one.
    """
    from ..post.nf2ff import _angles, _face_geometry

    pts, w, u_hat, v_hat, normals, slices = _face_geometry(faces)
    theta, phi, rhat, trig = _angles(theta_deg, phi_deg)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device)

    return dict(
        pts=t(pts),
        w=t(w),
        u_hat=t(u_hat),
        v_hat=t(v_hat),
        normals=t(normals),
        slices=slices,
        rhat=t(rhat),
        trig=tuple(t(a) for a in trig),
        k0=np.float32(2.0 * np.pi * f0_hz / C0),
        theta=theta,
        phi=phi,
    )


def _directivity_ri(consts: dict, face_e, face_h):
    """Differentiable single-frequency far-field directivity from face DFTs.

    The real-pair twin of the engine transform chain
    ``post/nf2ff.py::_surface_currents → _radiation_integrals →
    _assemble_far_field`` at ONE frequency: ``face_e[i]``/``face_h[i]``
    are the (2 re/im, 2 u/v, nu, nv) float32 DFT sums of Huygens face
    ``i``. Returns ``(D (A,), P_rad)``: directivity at the ``consts``
    angle grid and the Poynting-flux radiated power. The Fourier dt factor
    is not applied (as on the S11 path): U ∝ dt² and P_rad ∝ dt², so it
    cancels in D, and ``P_rad`` is returned in these scaled units, used
    only as the normalizer.
    """
    u_hat, v_hat = consts["u_hat"], consts["v_hat"]
    normals, w = consts["normals"], consts["w"]
    E_parts, H_parts = [], []
    for sl, fe, fh in zip(consts["slices"], face_e, face_h):
        # (2 re/im, n) tangential components → (2, n, 3) vectors
        eu, ev = fe[:, 0].reshape(2, -1), fe[:, 1].reshape(2, -1)
        hu, hv = fh[:, 0].reshape(2, -1), fh[:, 1].reshape(2, -1)
        E_parts.append(eu[..., None] * u_hat[sl] + ev[..., None] * v_hat[sl])
        H_parts.append(hu[..., None] * u_hat[sl] + hv[..., None] * v_hat[sl])
    E = torch.cat(E_parts, dim=1)  # (2, P, 3)
    H = torch.cat(H_parts, dim=1)
    cross = torch.linalg.cross
    J = cross(normals.expand_as(H), H)  # n̂ × H (linear: same map re/im)
    M = -cross(normals.expand_as(E), E)  # −n̂ × E
    # ½ Re(E × H*) = ½ (E_re × H_re + E_im × H_im)
    S = 0.5 * (cross(E[0], H[0]) + cross(E[1], H[1]))
    P_rad = torch.einsum("pc,pc,p->", S, normals, w)

    k0 = float(consts["k0"])
    ph = k0 * (consts["pts"] @ consts["rhat"].T)  # (P, A)
    c, s = torch.cos(ph), torch.sin(ph)

    def integrals(X):
        xw_re = (X[0] * w[:, None]).T  # (3, P)
        xw_im = (X[1] * w[:, None]).T
        return xw_re @ c - xw_im @ s, xw_re @ s + xw_im @ c  # (3, A) ×2

    N_re, N_im = integrals(J)
    L_re, L_im = integrals(M)
    ct, st, cp, sp = consts["trig"]

    def to_theta_phi(re_, im_):
        th = (re_[0] * ct * cp + re_[1] * ct * sp - re_[2] * st,
              im_[0] * ct * cp + im_[1] * ct * sp - im_[2] * st)
        phc = (-re_[0] * sp + re_[1] * cp, -im_[0] * sp + im_[1] * cp)
        return th, phc

    (N_th_re, N_th_im), (N_ph_re, N_ph_im) = to_theta_phi(N_re, N_im)
    (L_th_re, L_th_im), (L_ph_re, L_ph_im) = to_theta_phi(L_re, L_im)
    eta = float(np.float32(ETA0))
    pref = float(consts["k0"] / np.float32(4.0 * np.pi))
    # E_θ = −j·pref·(L_φ + η0 N_θ);  E_φ = +j·pref·(L_θ − η0 N_φ)
    x_re, x_im = L_ph_re + eta * N_th_re, L_ph_im + eta * N_th_im
    y_re, y_im = L_th_re - eta * N_ph_re, L_th_im - eta * N_ph_im
    e_th_re, e_th_im = pref * x_im, -pref * x_re
    e_ph_re, e_ph_im = -pref * y_im, pref * y_re
    U = (e_th_re**2 + e_th_im**2 + e_ph_re**2 + e_ph_im**2) / (2.0 * eta)
    D = 4.0 * np.pi * U / torch.clamp_min(P_rad, 1e-20)
    return D, P_rad


@dataclass
class InverseDesignProblem:
    """A differentiable patch-design problem over a prepared base scene,
    on the simulation's device."""

    sim: PreparedSimulation
    region: DesignRegion
    freqs_hz: np.ndarray
    n_steps: int
    f0: float
    remat_chunk: int = 50
    _step: ExposedStep = field(default=None, repr=False)
    _s11_fn: Callable = field(default=None, repr=False)
    _pattern_fns: Dict = field(default=None, repr=False)

    @property
    def device(self) -> torch.device:
        return self.sim.device

    def _density(self, rho) -> torch.Tensor:
        return torch.as_tensor(rho, dtype=torch.float32, device=self.device)

    # -- differentiable forward --------------------------------------------

    def overlay_coeffs(self, rho: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Coefficient dict with the density applied to the design plane;
        new tensors for the four Ex/Ey coefficients, the base ones for
        the rest (the base is not written)."""
        r = self.region
        mex, mey = _cell_to_ex_ey(self._density(rho))
        coeffs = dict(self.sim.coeffs)
        for comp, m, (i0, i1, j0, j1) in (
            ("ex", mex, (r.i0, r.i1, r.j0, r.j1 + 1)),
            ("ey", mey, (r.i0, r.i1 + 1, r.j0, r.j1)),
        ):
            keep = 1.0 - m
            for name in (f"ca_{comp}", f"cb_{comp}"):
                a = coeffs[name]
                out = a.clone()
                out[i0:i1, j0:j1, r.k] = a[i0:i1, j0:j1, r.k] * keep
                coeffs[name] = out
        return coeffs

    def _build_forward_fn(self, pattern: Optional[dict] = None) -> Callable:
        """The differentiable forward: ``rho → S11 (2, n_f)``, or, with
        ``pattern`` constants from :func:`_pattern_consts`, ``rho → (S11,
        D (A,))``, where the Huygens faces' tangential fields are also
        DFT-accumulated at f0 every step and go through
        :func:`_directivity_ri`."""
        sim = self.sim
        dev = self.device
        if self._step is None:
            self._step = ExposedStep(sim)
        step = self._step
        chunk = max(1, int(self.remat_chunk))
        n_chunks = -(-int(self.n_steps) // chunk)
        n_total = n_chunks * chunk
        # pad the waveform so the trailing (n_total − n_steps) steps
        # inject zeros rather than read past the source
        wf = np.zeros(max(n_total, len(sim.waveform)), np.float32)
        wf[:len(sim.waveform)] = sim.waveform
        wf = torch.from_numpy(wf).to(dev)

        # the DFT phases, float32 as the JAX package forms them: after
        # step n the E sample sits at (n+1)·dt, H half a step earlier
        dt = np.float32(sim.dt)
        t_e = (np.arange(n_total, dtype=np.float32) + np.float32(1.0)) * dt
        t_h = t_e - np.float32(0.5) * dt

        def phases(w):
            w = np.asarray(w, np.float32)
            out = []
            for t in (t_e, t_h):
                ang = torch.from_numpy(t[:, None] * w[None, :]).to(dev)
                out += [torch.cos(ang), torch.sin(ang)]
            return out  # cos/sin at t_e, cos/sin at t_h, (n_total, n_w)

        ce, se, ch, sh = phases(2 * np.pi * np.asarray(self.freqs_hz))
        if pattern is not None:
            ce0, se0, ch0, sh0 = phases([2.0 * np.pi * self.f0])
        n_f = len(self.freqs_hz)
        T = sim.n_face_slots
        z_ref = float(np.float32(sim.ports[0].spec.resistance))
        n_p = len(sim.ports)
        rows = step.port_rows if pattern is None else step.all_rows

        def chunk_body(state, n0, operands):
            E, H, psi_e, psi_h, acc, fe_acc, fh_acc = state
            samples = []
            for n in range(n0, n0 + chunk):
                E, H, psi_e, psi_h = step.step(E, H, psi_e, psi_h, *operands,
                                               wf[n])
                samples.append(step.sample(E, H, rows))
            S = torch.stack(samples)  # (chunk, rows): port 0's V and I at 0, n_p
            V, I = S[:, 0], S[:, n_p]
            sl = slice(n0, n0 + chunk)
            acc = acc + torch.stack(
                [V @ ce[sl], -(V @ se[sl]), I @ ch[sl], -(I @ sh[sl])])
            if pattern is not None:
                FE, FH = S[:, 2 * n_p:2 * n_p + T], S[:, 2 * n_p + T:]
                fe_acc = fe_acc + torch.cat(
                    [ce0[sl].T @ FE, -(se0[sl].T @ FE)])
                fh_acc = fh_acc + torch.cat(
                    [ch0[sl].T @ FH, -(sh0[sl].T @ FH)])
            return E, H, psi_e, psi_h, acc, fe_acc, fh_acc

        def forward(rho):
            operands = step.operands(self.overlay_coeffs(rho))
            f32 = dict(dtype=torch.float32, device=dev)
            E = torch.zeros((3, *sim.padded_shape), **f32)
            psi = (torch.zeros((6, *sim.padded_shape), **f32)
                   if step.psi_bc is not None else None)
            # undecimated port DFTs at the loss frequencies (uf re/im, if
            # re/im) and, for the pattern, the faces' at f0
            state = (E, E, psi, psi, torch.zeros((4, n_f), **f32),
                     torch.zeros((2, T), **f32), torch.zeros((2, T), **f32))
            for c in range(n_chunks):
                state = checkpoint(chunk_body, state, c * chunk, operands,
                                   use_reentrant=False,
                                   preserve_rng_state=False)
            acc, fe_acc, fh_acc = state[4:]
            # real-pair arithmetic throughout, as in the JAX package. The
            # Fourier-integral dt factor (post/ports.py multiplies raw
            # sums by dt) cancels in the uf_ref/uf_inc ratio and is
            # deliberately NOT applied: dt² ≈ 1e-24 under float32
            # squaring drives the backward pass to 0/NaN.
            uf_re, uf_im, if_re, if_im = acc
            inc_re = 0.5 * (uf_re + z_ref * if_re)
            inc_im = 0.5 * (uf_im + z_ref * if_im)
            ref_re = uf_re - inc_re
            ref_im = uf_im - inc_im
            den = inc_re * inc_re + inc_im * inc_im
            s_re = (ref_re * inc_re + ref_im * inc_im) / den
            s_im = (ref_im * inc_re - ref_re * inc_im) / den
            s11 = torch.stack([s_re, s_im])  # (2, n_f)
            if pattern is None:
                return s11
            lay = sim.face_layout
            faces_e = [fe_acc[:, o:o + 2 * nu * nv].reshape(2, 2, nu, nv)
                       for o, nu, nv in lay]
            faces_h = [fh_acc[:, o:o + 2 * nu * nv].reshape(2, 2, nu, nv)
                       for o, nu, nv in lay]
            D, _ = _directivity_ri(pattern, faces_e, faces_h)
            return s11, D

        return forward

    @property
    def s11_fn(self) -> Callable:
        """``rho (Ni,Nj) → S11 at freqs_hz as (2, n_f) re/im``,
        differentiable."""
        if self._s11_fn is None:
            self._s11_fn = self._build_forward_fn(pattern=None)
        return self._s11_fn

    def s11(self, rho) -> np.ndarray:
        """Host-side convenience: complex S11 at ``freqs_hz``."""
        with torch.no_grad():
            ri = self.s11_fn(self._density(rho)).cpu().numpy()
        return ri[0] + 1j * ri[1]

    def loss(self, rho, weights=None) -> torch.Tensor:
        """Mean |S11|² over the loss band (optionally weighted)."""
        ri = self.s11_fn(rho)
        p = ri[0] ** 2 + ri[1] ** 2
        if weights is not None:
            w = torch.as_tensor(weights, dtype=torch.float32, device=self.device)
            return torch.sum(p * w) / torch.sum(w)
        return torch.mean(p)

    # -- far-field (pattern) objective ---------------------------------------

    def pattern_fn(
        self,
        theta_deg: Sequence[float] = (0.0,),
        phi_deg: Sequence[float] = (0.0,),
    ) -> Callable:
        """``rho → (s11 (2, n_f), D (nθ·nφ,))``: the differentiable forward
        extended with far-field directivity at the given angles (f0 only),
        through the NF2FF surface-equivalence math, so the gradient carries
        pattern sensitivity back through the transform and the time loop.
        Built and cached per angle grid."""
        key = (tuple(float(t) for t in np.atleast_1d(theta_deg)),
               tuple(float(p) for p in np.atleast_1d(phi_deg)))
        if self._pattern_fns is None:
            self._pattern_fns = {}
        if key not in self._pattern_fns:
            consts = _pattern_consts(self.sim.faces, np.asarray(key[0]),
                                     np.asarray(key[1]), self.f0, self.device)
            self._pattern_fns[key] = self._build_forward_fn(pattern=consts)
        return self._pattern_fns[key]

    def broadside_gain_loss(self, rho) -> torch.Tensor:
        """Negative broadside realized gain: ``−D(θ=0)·(1−|S11(f0)|²)``.

        Directivity alone would reward detuning the feed (P_rad shrinks
        faster than U), so the mismatch factor keeps the optimizer honest
        about accepted power."""
        s11, D = self.pattern_fn((0.0,), (0.0,))(rho)
        i_f0 = int(np.argmin(np.abs(np.asarray(self.freqs_hz) - self.f0)))
        p_f0 = s11[0, i_f0] ** 2 + s11[1, i_f0] ** 2
        return -(D[0] * (1.0 - p_f0))

    # -- optimization -------------------------------------------------------

    def optimize(
        self,
        rho0: Optional[np.ndarray] = None,
        *,
        n_iters: int = 40,
        lr: float = 0.05,
        beta_sharpen: float = 1.0,
        weights: Optional[np.ndarray] = None,
        callback: Optional[Callable] = None,
        objective: str = "s11_band",
    ) -> "InverseDesignResult":
        """Adam descent on logits θ with ``rho = sigmoid(β·θ)``.

        ``torch.optim.Adam`` with optax's defaults (b1 0.9, b2 0.999, eps
        1e-8, no weight decay; the same bias-corrected update). ``rho0``
        seeds the density (default 0.5 everywhere); ``callback`` (if
        given) receives ``(iteration, loss, rho)`` per step. ``objective``
        is ``"s11_band"`` (mean |S11|² over ``freqs_hz``, optionally
        weighted) or ``"broadside_gain"`` (:meth:`broadside_gain_loss`;
        ``weights`` is ignored).
        """
        if objective == "s11_band":
            def loss_of(rho):
                return self.loss(rho, weights=weights)
        elif objective == "broadside_gain":
            loss_of = self.broadside_gain_loss
        else:
            raise ValueError(
                f"unknown objective {objective!r} "
                "(expected 's11_band' or 'broadside_gain')"
            )
        if rho0 is None:
            rho0 = 0.5 * np.ones(self.region.shape, np.float32)
        rho0 = np.clip(np.asarray(rho0, np.float32), 1e-4, 1 - 1e-4)
        theta = torch.tensor(np.log(rho0 / (1 - rho0)) / beta_sharpen,
                             dtype=torch.float32, device=self.device,
                             requires_grad=True)
        opt = torch.optim.Adam([theta], lr=lr, betas=(0.9, 0.999), eps=1e-8)
        history: List[float] = []
        t0 = time.perf_counter()
        for it in range(n_iters):
            opt.zero_grad(set_to_none=True)
            val = loss_of(torch.sigmoid(beta_sharpen * theta))
            val.backward()
            opt.step()
            history.append(val.item())
            if callback is not None:
                with torch.no_grad():
                    rho_it = torch.sigmoid(beta_sharpen * theta).cpu().numpy()
                callback(it, history[-1], rho_it)
        with torch.no_grad():
            rho = torch.sigmoid(beta_sharpen * theta).cpu().numpy()
        s11 = self.s11(rho)
        return InverseDesignResult(
            rho=rho,
            history=history,
            s11=s11,
            freqs_hz=np.asarray(self.freqs_hz),
            wall_s=time.perf_counter() - t0,
            problem=self,
            objective=objective,
        )

    # -- validation through the standard engine -----------------------------

    def validate(self, rho: np.ndarray, threshold: float = 0.5,
                 pattern: bool = False) -> dict:
        """Re-run the *binarized* design through the standard engine path.

        The hard-overlay coefficients are copied into the base
        simulation's ca/cb tensors in place, the run goes to the
        configured termination criterion, and the base values are copied
        back in a ``finally``. In place, because launches hold the
        coefficients by address: ``sim.operands.ca/cb`` are the same
        tensors as ``sim.coeffs``, and K1's packed launch arguments point
        at them (its resident form copies them to shared memory at the
        start of each launch, its streamed form reads them in every pass),
        so rebinding ``sim.coeffs`` would run the scene without the patch.
        On the card the run is K1's ``chunk_steps``.

        Returns the engine's S11 sweep and resonance for the thresholded
        design. With ``pattern=True`` the run's NF2FF sums go through the
        standard transform (``post/nf2ff.py``, on the simulation's device)
        at f0, and the dict gains ``broadside_directivity`` (linear, θ=0),
        ``Dmax`` and ``broadside_realized_gain_dbi`` (directivity ×
        (1−|S11(f0)|²) in dBi)."""
        hard = (np.asarray(rho) >= threshold).astype(np.float32)
        sim = self.sim
        with torch.no_grad():
            over = self.overlay_coeffs(hard)
        changed = [k for k, v in over.items() if v is not sim.coeffs[k]]
        saved = {k: sim.coeffs[k].clone() for k in changed}
        try:
            for k in changed:
                sim.coeffs[k].copy_(over[k])
            out = sim.run()
        finally:
            for k in changed:
                sim.coeffs[k].copy_(saved[k])
        spec = port_spectra(sim.port_freqs_hz, out["uf"][0], out["if_"][0],
                            sim.dft_dt, z_ref=sim.ports[0].spec.resistance)
        f_res, s11_db = find_resonance(spec, self.f0)
        result = {
            "spectra": spec,
            "f_res_hz": f_res,
            "s11_db": s11_db,
            "steps": int(out["steps"]),
            "rho_binary": hard,
        }
        if pattern:
            from ..post.nf2ff import nf2ff_transform, select_face_freqs

            fi = int(np.argmin(np.abs(sim.nf_freqs_hz - self.f0)))
            ff = nf2ff_transform(
                sim.faces,
                select_face_freqs(out["nf_e"], fi),
                select_face_freqs(out["nf_h"], fi),
                sim.dft_dt,
                sim.nf_freqs_hz[fi : fi + 1],
                np.arange(0.0, 91.0, 5.0),
                np.array([0.0, 90.0]),
                device=sim.device,
            )
            d_bs = float(ff.directivity[0, 0, 0])
            i_f0 = int(np.argmin(np.abs(spec.freq_hz - self.f0)))
            mismatch = 1.0 - min(abs(spec.s11[i_f0]) ** 2, 1.0)
            result["far_field"] = ff
            result["broadside_directivity"] = d_bs
            result["Dmax"] = float(ff.Dmax[0])
            result["broadside_realized_gain_dbi"] = float(
                10.0 * np.log10(max(d_bs * mismatch, 1e-12))
            )
        return result


@dataclass
class InverseDesignResult:
    rho: np.ndarray
    history: List[float]
    s11: np.ndarray
    freqs_hz: np.ndarray
    wall_s: float
    problem: InverseDesignProblem
    objective: str = "s11_band"

    def s11_db(self) -> np.ndarray:
        return 20.0 * np.log10(np.maximum(np.abs(self.s11), 1e-12))


def prepare_patch_inverse(
    params: PatchAntennaParams,
    *,
    region_mm: Optional[Sequence[float]] = None,
    freqs_hz: Optional[Sequence[float]] = None,
    n_steps: Optional[int] = None,
    fc_hz: Optional[float] = None,
    mesh_divisor: float = 20.0,
    sub_mm: float = 60.0,
    box_mm: Sequence[float] = (120.0, 120.0, 80.0),
    substrate_cells: int = 4,
    feed_pos_mm: float = -6.0,
    feed_r_ohm: float = 50.0,
    remat_chunk: int = 50,
    boundary: str = "MUR",
    n_steps_max_validate: int = 30_000,
    device="cuda",
) -> InverseDesignProblem:
    """Build the base scene (no patch) and the differentiable problem on
    ``device`` ('cuda' by default; 'cpu' runs everything on the CPU).

    The scene mirrors the canonical fixed-solver geometry
    (``solvers/patch_fixed.py``) with the patch left out: substrate,
    ground sheet and a z-directed lumped feed. ``region_mm`` is the design
    rectangle ``(x0, x1, y0, y1)`` on the substrate top (default: the
    Hammerstad–Jensen patch footprint grown by 25% per side). ``freqs_hz``
    are the loss frequencies (default: 5 points across ±10% of f0).
    ``n_steps`` is the fixed differentiable-forward step budget; the
    default covers the Gaussian source plus half again for ring-down. An
    explicit ``n_steps`` shorter than the source is rejected: with no
    incident energy in the DFTs, ``1/|uf_inc|²`` overflows float32 in the
    backward pass and the gradient is NaN. ``fc_hz`` widens the
    excitation band (default f0/2); ``fc_hz = f0`` halves the source
    duration.
    """
    f0 = params.frequency_hz
    fc = float(fc_hz) if fc_hz else f0 / 2.0
    h = params.h_m * 1e3
    L_m, W_m, _ = design_patch_for_frequency(f0, params.eps_r, params.h_m)
    if region_mm is None:
        gx = 0.25 * W_m * 1e3
        gy = 0.25 * L_m * 1e3
        region_mm = (
            -W_m / 2 * 1e3 - gx,
            W_m / 2 * 1e3 + gx,
            -L_m / 2 * 1e3 - gy,
            L_m / 2 * 1e3 + gy,
        )
    x0, x1, y0, y1 = (float(v) for v in region_mm)
    kappa = substrate_conductivity(f0, params.eps_r, params.loss_tangent)

    scene = Scene()
    scene.add_material_box(
        "substrate", params.eps_r, kappa,
        [-sub_mm / 2, -sub_mm / 2, 0.0], [sub_mm / 2, sub_mm / 2, h],
        priority=0,
    )
    scene.add_metal_box(
        "gnd", [-sub_mm / 2, -sub_mm / 2, 0.0],
        [sub_mm / 2, sub_mm / 2, 0.0], priority=10,
    )
    scene.add_lumped_port(
        1, feed_r_ohm, [feed_pos_mm, 0.0, 0.0], [feed_pos_mm, 0.0, h],
        direction="z", excite=1.0,
    )

    mesh_res = C0 / (f0 + fc) / 1e-3 / mesh_divisor  # mm
    mb = MeshBuilder()
    mb.add_line("x", [-box_mm[0] / 2, box_mm[0] / 2])
    mb.add_line("y", [-box_mm[1] / 2, box_mm[1] / 2])
    mb.add_line("z", [-box_mm[2] / 3, box_mm[2] * 2 / 3])
    # resolve the design region uniformly (a density pixel per cell)
    nx = max(2, int(np.ceil((x1 - x0) / mesh_res)))
    ny = max(2, int(np.ceil((y1 - y0) / mesh_res)))
    mb.add_line("x", np.linspace(x0, x1, nx + 1))
    mb.add_line("y", np.linspace(y0, y1, ny + 1))
    mb.add_metal_edges(
        [-sub_mm / 2, -sub_mm / 2, 0.0], [sub_mm / 2, sub_mm / 2, 0.0],
        dirs="xy",
    )
    mb.add_line("z", np.linspace(0.0, h, substrate_cells + 1))
    mb.add_line("x", [feed_pos_mm])
    mb.add_line("y", [0.0])
    grid = mb.build(mesh_res, ratio=1.4)

    cfg = FDTDConfig(
        n_steps_max=n_steps_max_validate,
        end_criteria=1e-4,
        boundary=boundary,
        probe_decimation=1,
    )
    if freqs_hz is None:
        freqs_hz = np.linspace(0.9 * f0, 1.1 * f0, 5)
    freqs_hz = np.asarray(freqs_hz, np.float64)
    sim = build_simulation(
        scene, grid, f0=f0, fc=fc, cfg=cfg, device=device,
        port_freqs_hz=np.linspace(max(1e8, f0 * 0.5), f0 * 1.5, 201),
        nf_freqs_hz=np.array([f0]),
    )
    if n_steps is None:
        n_steps = int(1.5 * sim.n_source_steps)
    elif n_steps < sim.n_source_steps:
        raise ValueError(
            f"n_steps={n_steps} is shorter than the Gaussian source "
            f"({sim.n_source_steps} steps): the port DFTs would hold no "
            "incident energy and the S11 gradient NaNs (1/|uf_inc|² "
            "overflow). Raise n_steps or widen the band via fc_hz."
        )

    tol = 1e-6
    gi = grid.lines["x"]
    gj = grid.lines["y"]
    gk = grid.lines["z"]
    i0 = int(np.searchsorted(gi, x0 - tol))
    i1 = int(np.searchsorted(gi, x1 - tol))
    j0 = int(np.searchsorted(gj, y0 - tol))
    j1 = int(np.searchsorted(gj, y1 - tol))
    k = int(np.searchsorted(gk, h - tol))
    for name, idx, lines, want in (
        ("x0", i0, gi, x0), ("x1", i1, gi, x1),
        ("y0", j0, gj, y0), ("y1", j1, gj, y1), ("z", k, gk, h),
    ):
        if abs(lines[idx] - want) > 1e-5:
            raise ValueError(
                f"design-region edge {name}={want} mm not on a mesh line "
                f"(nearest {lines[idx]:.4f})"
            )
    region = DesignRegion(
        i0=i0, i1=i1, j0=j0, j1=j1, k=k, x_mm=(x0, x1), y_mm=(y0, y1)
    )
    return InverseDesignProblem(
        sim=sim,
        region=region,
        freqs_hz=freqs_hz,
        n_steps=int(n_steps),
        f0=f0,
        remat_chunk=remat_chunk,
    )
