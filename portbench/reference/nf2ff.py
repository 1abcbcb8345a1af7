"""Near-field → far-field transform (surface equivalence).

A frozen copy of the port's transform, with the radiation integrals in
float64. The time loop accumulated tangential E/H DFTs on the Huygens box; this module applies
the equivalence theorem

    J_s = n̂ × H,   M_s = −n̂ × E
    N(θ,φ) = ∬ J_s e^{+jk r̂·r'} dA,   L(θ,φ) = ∬ M_s e^{+jk r̂·r'} dA
    E_θ = −jk/(4πr)·(L_φ + η0 N_θ),   E_φ = +jk/(4πr)·(L_θ − η0 N_φ)

with the radiation integrals as float64 matmuls over surface points ×
angle grid.
Radiated power comes from the Poynting flux through the same surface, so
``Dmax``/``E_norm`` follow the openEMS result contract (dBi grid =
20·log10(E/Emax) + 10·log10(Dmax)). Phase-center shifts are applied as
the exact post-factor e^{−jk r̂·c} on the integrals.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from .physics import C0, ETA0

# Cap on P·A_chunk elements per intermediate (~512 MB of f64); larger
# angle grids are processed in chunks of rhat.
_MAX_CHUNK_ELEMS = 64 * 1024 * 1024


@dataclass
class FarField:
    """openEMS-compatible far-field result (fields indexed by frequency)."""

    freq_hz: np.ndarray  # (nf,)
    theta: np.ndarray  # radians (nth,)
    phi: np.ndarray  # radians (nph,)
    E_theta: np.ndarray  # (nf, nth, nph) complex, at r = 1 m
    E_phi: np.ndarray
    E_norm: np.ndarray  # (nf, nth, nph) |E|
    Dmax: np.ndarray  # (nf,)
    P_rad: np.ndarray  # (nf,) watts
    directivity: np.ndarray  # (nf, nth, nph) linear

    def intensity_dbi(self, fi: int = 0) -> np.ndarray:
        """The reference's dBi grid."""
        e = self.E_norm[fi]
        e_max = e.max()
        if e_max <= 0:
            return np.full_like(e, -50.0)
        return 20.0 * np.log10(np.maximum(e / e_max, 1e-15)) + 10.0 * np.log10(
            self.Dmax[fi]
        )


def _radiation_integrals(pts, w, F_re, F_im, G_re, G_im, k_arr, rhat):
    """All radiation integrals, float64 tensors on one device.

    pts: (P, 3); w: (P,); F_*/G_* (J_s and M_s): (K, P, 3); k_arr: (K,);
    rhat: (A, 3). Returns float64 (K, 2, 2, 3, A): axes (row, N/L, re/im,
    xyz, angle).
    """
    KR0 = pts @ rhat.T  # (P, A)
    wcol = w[:, None]

    def integ(re_, im_, c, s):
        wre = (re_ * wcol).T  # (3, P)
        wim = (im_ * wcol).T
        return torch.stack([wre @ c - wim @ s, wre @ s + wim @ c])

    rows = []
    for r in range(k_arr.shape[0]):
        ph = k_arr[r] * KR0
        c, s = torch.cos(ph), torch.sin(ph)
        rows.append(torch.stack([integ(F_re[r], F_im[r], c, s),
                                 integ(G_re[r], G_im[r], c, s)]))
    return torch.stack(rows)


def _face_geometry(faces: Sequence):
    """Concatenate the Huygens faces into one point cloud.

    Returns (pts (P,3), w (P,), u_hat (P,3), v_hat (P,3), normals (P,3),
    slices) — ``slices[i]`` selects face i's points in the concatenation.
    """
    pts, w, u_hats, v_hats, normals, slices = [], [], [], [], [], []
    off = 0
    for face in faces:
        p = face.centers_m.reshape(-1, 3)
        n = p.shape[0]
        pts.append(p)
        w.append(face.areas_m2.reshape(-1))
        uh = np.zeros((n, 3))
        uh[:, face.u_axis] = 1.0
        u_hats.append(uh)
        vh = np.zeros((n, 3))
        vh[:, face.v_axis] = 1.0
        v_hats.append(vh)
        normals.append(np.broadcast_to(face.normal, (n, 3)))
        slices.append(slice(off, off + n))
        off += n
    return (
        np.concatenate(pts),
        np.concatenate(w),
        np.concatenate(u_hats),
        np.concatenate(v_hats),
        np.concatenate(normals),
        slices,
    )


def _surface_currents(geo, nf_e, nf_h, dt: float):
    """Tangential fields → (J_s, M_s, P_rad) for a (nf,)-leading stack.

    nf_e[i]/nf_h[i]: (nf, 2, nu, nv) complex accumulators for face i.
    Returns J_s, M_s: (nf, P, 3) complex128; P_rad: (nf,).
    """
    pts, w, u_hat, v_hat, normals, slices = geo
    nf = nf_e[0].shape[0]
    P = pts.shape[0]
    E_t = np.zeros((nf, P, 3), np.complex128)
    H_t = np.zeros_like(E_t)
    for sl, acc_e, acc_h in zip(slices, nf_e, nf_h):
        Eu = acc_e[:, 0].reshape(nf, -1) * dt
        Ev = acc_e[:, 1].reshape(nf, -1) * dt
        Hu = acc_h[:, 0].reshape(nf, -1) * dt
        Hv = acc_h[:, 1].reshape(nf, -1) * dt
        E_t[:, sl] = Eu[..., None] * u_hat[sl] + Ev[..., None] * v_hat[sl]
        H_t[:, sl] = Hu[..., None] * u_hat[sl] + Hv[..., None] * v_hat[sl]
    J_s = np.cross(np.broadcast_to(normals, E_t.shape), H_t)
    M_s = -np.cross(np.broadcast_to(normals, E_t.shape), E_t)
    S = 0.5 * np.real(np.cross(E_t, np.conj(H_t)))  # (nf, P, 3)
    P_rad = np.einsum("fpc,pc,p->f", S, normals, w)
    return J_s, M_s, P_rad


def _angles(theta_deg, phi_deg):
    theta = np.deg2rad(np.asarray(theta_deg, float)).ravel()
    phi = np.deg2rad(np.asarray(phi_deg, float)).ravel()
    th, ph = np.meshgrid(theta, phi, indexing="ij")
    st, ct = np.sin(th), np.cos(th)
    sp, cp = np.sin(ph), np.cos(ph)
    rhat = np.stack([st * cp, st * sp, ct], axis=-1).reshape(-1, 3)
    trig = (ct.reshape(-1), st.reshape(-1), cp.reshape(-1), sp.reshape(-1))
    return theta, phi, rhat, trig


def _run_integrals(pts, w, J_s, M_s, k_rows, rhat, device):
    """Chunked loop over the angle grid; returns N, L (K, 3, A) complex."""
    K, P, _ = J_s.shape
    A = rhat.shape[0]
    chunk = max(1, min(A, _MAX_CHUNK_ELEMS // max(P, 1)))

    def t64(a):
        return torch.as_tensor(np.asarray(a, np.float64), device=device)

    pts64, w64 = t64(pts), t64(w)
    F_re, F_im = t64(J_s.real), t64(J_s.imag)
    G_re, G_im = t64(M_s.real), t64(M_s.imag)
    k64 = t64(k_rows)
    N = np.zeros((K, 3, A), np.complex128)
    L = np.zeros((K, 3, A), np.complex128)
    for a0 in range(0, A, chunk):
        rh = t64(rhat[a0 : a0 + chunk])
        out = _radiation_integrals(
            pts64, w64, F_re, F_im, G_re, G_im, k64, rh).cpu().numpy()
        N[:, :, a0 : a0 + chunk] = out[:, 0, 0] + 1j * out[:, 0, 1]
        L[:, :, a0 : a0 + chunk] = out[:, 1, 0] + 1j * out[:, 1, 1]
    return N, L


def _assemble_far_field(N, L, k_rows, rhat, trig, centers, P_rad, nth, nph):
    """N/L integrals → per-row E_θ/E_φ with center phase post-factors."""
    ct, st, cp, sp = trig
    K = N.shape[0]
    E_theta = np.zeros((K, nth, nph), np.complex128)
    E_phi = np.zeros_like(E_theta)
    for r in range(K):
        k = k_rows[r]
        # exact phase-center shift: e^{+jk r̂·(r'−c)} = e^{+jk r̂·r'}·e^{−jk r̂·c}
        shift = np.exp(-1j * k * (rhat @ centers[r]))
        Nr = N[r] * shift
        Lr = L[r] * shift
        N_th = Nr[0] * ct * cp + Nr[1] * ct * sp - Nr[2] * st
        N_ph = -Nr[0] * sp + Nr[1] * cp
        L_th = Lr[0] * ct * cp + Lr[1] * ct * sp - Lr[2] * st
        L_ph = -Lr[0] * sp + Lr[1] * cp
        pref = 1j * k / (4.0 * np.pi)  # r = 1 m, e^{−jkr} phase dropped
        E_theta[r] = (-pref * (L_ph + ETA0 * N_th)).reshape(nth, nph)
        E_phi[r] = (pref * (L_th - ETA0 * N_ph)).reshape(nth, nph)
    E_norm = np.sqrt(np.abs(E_theta) ** 2 + np.abs(E_phi) ** 2)
    U = E_norm**2 / (2.0 * ETA0)  # r = 1 m
    with np.errstate(divide="ignore", invalid="ignore"):
        # a non-positive radiated power means the row holds numerical
        # noise — mark it NaN instead of inventing directivity
        directivity = np.where(
            P_rad[:, None, None] > 0.0,
            4.0 * np.pi * U / np.maximum(P_rad[:, None, None], 1e-300),
            np.nan,
        )
    Dmax = directivity.reshape(K, -1).max(axis=1)
    return E_theta, E_phi, E_norm, directivity, Dmax


def nf2ff_transform(
    faces: Sequence,
    nf_e: Sequence[np.ndarray],
    nf_h: Sequence[np.ndarray],
    dt: float,
    freq_hz: np.ndarray,
    theta_deg: np.ndarray,
    phi_deg: np.ndarray,
    center_m: np.ndarray | None = None,
    device="cuda",
) -> FarField:
    """Transform accumulated Huygens-box DFTs to the far field.

    ``faces`` are ``ops.fdtd.FaceRuntime``; ``nf_e[i]``/``nf_h[i]`` are the
    (nf, 2, nu, nv) complex accumulators for face i (tangential u, v
    components in face order). The radiation integrals run on ``device``:
    the card by default, where asking for CUDA without one raises.
    """
    device = torch.device(device)
    nf_e = [np.asarray(a, np.complex128) for a in nf_e]
    nf_h = [np.asarray(a, np.complex128) for a in nf_h]
    freq_hz = np.atleast_1d(np.asarray(freq_hz, float))
    nf = len(freq_hz)
    if nf_e[0].shape[0] != nf:
        raise ValueError(
            f"accumulators hold {nf_e[0].shape[0]} frequency rows but "
            f"freq_hz has {nf}; slice with select_face_freqs() first"
        )
    theta, phi, rhat, trig = _angles(theta_deg, phi_deg)
    nth, nph = len(theta), len(phi)
    center = np.zeros(3) if center_m is None else np.asarray(center_m, float)

    geo = _face_geometry(faces)
    J_s, M_s, P_rad = _surface_currents(geo, nf_e, nf_h, dt)
    k_rows = 2.0 * np.pi * freq_hz / C0
    N, L = _run_integrals(geo[0], geo[1], J_s, M_s, k_rows, rhat, device)
    centers = np.broadcast_to(center, (nf, 3))
    E_theta, E_phi, E_norm, directivity, Dmax = _assemble_far_field(
        N, L, k_rows, rhat, trig, centers, P_rad, nth, nph
    )
    return FarField(
        freq_hz=freq_hz,
        theta=theta,
        phi=phi,
        E_theta=E_theta,
        E_phi=E_phi,
        E_norm=E_norm,
        Dmax=Dmax,
        P_rad=P_rad,
        directivity=directivity,
    )
