"""CPML walls for the plain reference: profiles, the build, the step and
the run.

The convolutional PML the port documents (Roden–Gedney, κ = 1; the port's
``ops/fdtd.py::_cpml_profiles``), worked out again:

- σ graded as a cubic (m = 3) over each slab's physical depth, with
  σ_max = −(m + 1)·ln(R0) / (2·η0·L_slab) per side and R0 = 1e-8; α
  graded linearly from α_max = 0.05 at the slab's inner face to 0 at the
  wall; b = exp(−(σ + α)·dt/ε0) and c = σ/(σ + α)·(b − 1), in float64 at
  the nodes (ψ_e) and half cells (ψ_h) of each axis, then cast;
- each ψ lives on the two slabs of its derivative's axis only: the
  ``npml`` nodes or half cells at each end, where the profile is graded
  (elsewhere b = 1 and c = 0, so a ψ there would stay 0);
- ψ' = b·ψ + c·∂F, and ∂F + ψ' takes ∂F's place in the curl;
- the outer walls are PEC, as the port closes a CPML box: E tangential to
  a wall plane is held at 0 (ca = cb = 0 there), and no MUR update runs;
- the Huygens box keeps ``npml + 3`` cells from the walls, at least 4.

:func:`run` is :func:`yee.run` with this step in place of the MUR one:
the same chunks, probes, float64 DFT sums, energy checks and stops. The
fields step in the dtype asked for (float32 for the reference) by
elementwise operations; every matrix product is float64 or complex128,
so TF32 never enters.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .build import RefSim, build
from .physics import EPS0, ETA0
from .scene import Scene
from .yee import Probes, RefRun, Stepper, _bdiff, _fdiff

M_GRADE = 3.0
R0 = 1e-8
ALPHA_MAX = 0.05

# ψ keys: the field component, then the derivative's axis
PSI_KEYS = ("xy", "xz", "yz", "yx", "zx", "zy")
_AXIS = {"x": 0, "y": 1, "z": 2}


def npml_of(boundary: str) -> int:
    """The slab depth in cells of a ``PML_N`` boundary, 0 for any other."""
    b = boundary.upper()
    return int(b.split("_")[1]) if b.startswith("PML_") else 0


def profiles(grid, dt: float, npml: int, r0: float = R0):
    """``{axis: {"node" | "half": (b, c)}}``, float64 arrays of the grid's
    length on that axis (the half cells' last slot is past the last cell:
    b = 1, c = 0)."""
    out = {}
    for a, name in enumerate("xyz"):
        lines = grid.lines[name] * grid.unit
        q = len(lines)
        if 2 * npml + 4 > q:
            raise ValueError(f"axis {name} has {q} lines, too few for PML_{npml}")
        x_lo, x_hi = lines[npml], lines[q - 1 - npml]
        depth_lo, depth_hi = x_lo - lines[0], lines[-1] - x_hi
        prof = {}
        for kind in ("node", "half"):
            pos = np.full(q, 0.5 * (x_lo + x_hi))
            if kind == "node":
                pos[:] = lines
            else:
                pos[:-1] = 0.5 * (lines[:-1] + lines[1:])
            d = np.zeros(q)
            s_max = np.zeros(q)
            lo, hi = pos < x_lo, pos > x_hi
            d[lo] = (x_lo - pos[lo]) / depth_lo
            d[hi] = (pos[hi] - x_hi) / depth_hi
            s_max[lo] = -(M_GRADE + 1.0) * math.log(r0) / (2.0 * ETA0 * depth_lo)
            s_max[hi] = -(M_GRADE + 1.0) * math.log(r0) / (2.0 * ETA0 * depth_hi)
            d = np.clip(d, 0.0, 1.0)
            sigma = s_max * d ** M_GRADE
            alpha = np.where(d > 0, ALPHA_MAX * (1.0 - d), 0.0)
            b = np.exp(-(sigma + alpha) * dt / EPS0)
            both = sigma + alpha
            c = np.where(both > 0, sigma / np.where(both > 0, both, 1.0)
                         * (b - 1.0), 0.0)
            prof[kind] = (b, c)
        out[a] = prof
    return out


def slab_starts(q: int, npml: int, kind: str) -> Tuple[int, int]:
    """Where the two slabs of ``npml`` entries start on an axis of ``q``
    lines: the first nodes or half cells and the last ones."""
    return 0, (q - npml if kind == "node" else q - 1 - npml)


@dataclasses.dataclass
class CpmlSim(RefSim):
    npml: int = 0
    pml: Optional[Dict] = None  # profiles() cast to float32


def build_cpml(scene: Scene, grid, *, f0: float, fc: float, boundary: str,
               n_steps_max: int, courant: float = 0.95,
               r0: float = R0) -> CpmlSim:
    """:func:`build.build` of ``scene`` with PEC walls and the CPML
    profiles of ``boundary`` (``PML_N``) in place of MUR."""
    npml = npml_of(boundary)
    if npml <= 0:
        raise ValueError(f"not a CPML boundary: {boundary}")
    base = build(scene, grid, f0=f0, fc=fc, boundary="MUR",
                 n_steps_max=n_steps_max, courant=courant,
                 nf_margin_cells=max(4, npml + 3))
    ca = [a.copy() for a in base.ca]
    for m in range(3):  # E tangential to a wall is held at 0
        for axis in (a for a in range(3) if a != m):
            for i in (0, grid.shape[axis] - 1):
                sl = [slice(None)] * 3
                sl[axis] = i
                ca[m][tuple(sl)] = 0.0
    prof = profiles(grid, base.dt, npml, r0)
    for a, q in enumerate(grid.shape):
        for kind in ("node", "half"):
            b, c = (v.astype(np.float32) for v in prof[a][kind])
            keep = np.zeros(q, bool)
            for s in slab_starts(q, npml, kind):
                keep[s:s + npml] = True
            if not (np.all(b[~keep] == 1) and np.all(c[~keep] == 0)):
                raise ValueError("a CPML profile is graded outside its slabs")
            prof[a][kind] = (b, c)
    fields = {f.name: getattr(base, f.name)
              for f in dataclasses.fields(RefSim)}
    fields.update(ca=tuple(ca), mur=None)
    return CpmlSim(**fields, npml=npml, pml=prof)


class CpmlStepper(Stepper):
    """:class:`yee.Stepper` with the CPML ψ on their slabs and PEC walls."""

    def __init__(self, sims: Sequence[CpmlSim], device, dtype):
        super().__init__(sims, device, dtype)
        s0 = sims[0]
        n = s0.npml
        B = len(sims)
        self.slabs = {}  # (kind, key) → [(start, b, c, ψ) per slab]
        for kind in ("half", "node"):
            for key in PSI_KEYS:
                ax = _AXIS[key[1]]
                q = s0.grid.shape[ax]
                b, c = s0.pml[ax][kind]
                shape = [1, 1, 1, 1]
                shape[ax + 1] = n
                psi_shape = [B, *s0.grid.shape]
                psi_shape[ax + 1] = n
                rows = []
                for start in slab_starts(q, n, kind):
                    def vec(v):
                        return torch.as_tensor(v[start:start + n]).to(
                            self.dev).to(dtype).view(shape)
                    rows.append((start, vec(b), vec(c),
                                 torch.zeros(psi_shape, device=self.dev,
                                             dtype=dtype)))
                self.slabs[kind, key] = rows

    def _convolve(self, d: Dict[str, torch.Tensor], kind: str) -> None:
        """ψ' = b·ψ + c·∂F on each slab, then ∂F += ψ' there."""
        for key in PSI_KEYS:
            dim = _AXIS[key[1]] + 1
            for start, b, c, psi in self.slabs[kind, key]:
                part = d[key].narrow(dim, start, psi.shape[dim])
                psi.mul_(b).addcmul_(c, part)
                part.add_(psi)

    def step(self, s: float) -> None:
        Ex, Ey, Ez = self.E
        Hx, Hy, Hz = self.H
        ipx, ipy, ipz = self.ip
        d = {"xy": _fdiff(Ez, 2) * ipy, "xz": _fdiff(Ey, 3) * ipz,
             "yz": _fdiff(Ex, 3) * ipz, "yx": _fdiff(Ez, 1) * ipx,
             "zx": _fdiff(Ey, 1) * ipx, "zy": _fdiff(Ex, 2) * ipy}
        self._convolve(d, "half")
        Hx.sub_(self.dtmu * (d["xy"] - d["xz"]))
        Hy.sub_(self.dtmu * (d["yz"] - d["yx"]))
        Hz.sub_(self.dtmu * (d["zx"] - d["zy"]))
        idx, idy, idz = self.id
        d = {"xy": _bdiff(Hz, 2) * idy, "xz": _bdiff(Hy, 3) * idz,
             "yz": _bdiff(Hx, 3) * idz, "yx": _bdiff(Hz, 1) * idx,
             "zx": _bdiff(Hy, 1) * idx, "zy": _bdiff(Hx, 2) * idy}
        self._convolve(d, "node")
        curl = (d["xy"] - d["xz"], d["yz"] - d["yx"], d["zx"] - d["zy"])
        En = []
        for m in range(3):
            e = self.ca[m] * self.E[m] + self.cb[m] * curl[m]
            if self.src[m] is not None:
                e = e + self.src[m] * s
            En.append(e)
        self.E = En


def run(sims: Sequence[CpmlSim], *, device, dtype, decim: int,
        stop_steps: Optional[Sequence[int]], check_every: int,
        port_freqs_hz, nf_freqs_hz, end_criteria: float = 0.0,
        n_steps_max: int = 0) -> RefRun:
    """:func:`yee.run` line for line, stepping with :class:`CpmlStepper`."""
    s0 = sims[0]
    B = len(sims)
    D = int(decim)
    n_sub = max(1, int(check_every) // D)
    chunk = n_sub * D
    own = stop_steps is None
    stop = [None] * B if own else [int(x) for x in stop_steps]
    n_end = int(n_steps_max) if own else max(stop)
    st = CpmlStepper(sims, device, dtype)
    pr = Probes(s0, device)
    dev = st.dev
    f64 = dict(dtype=torch.float64, device=dev)
    w_p = torch.as_tensor(2 * math.pi * np.asarray(port_freqs_hz), **f64)
    w_n = torch.as_tensor(2 * math.pi * np.asarray(nf_freqs_hz), **f64)
    n_f = len(s0.faces)
    uf = torch.zeros((B, len(s0.ports), len(w_p)), dtype=torch.complex128,
                     device=dev)
    if_ = torch.zeros_like(uf)
    nf_e = [torch.zeros((B, len(w_n), 2, f.u1 - f.u0, f.v1 - f.v0),
                        dtype=torch.complex128, device=dev) for f in s0.faces]
    nf_h = [torch.zeros_like(a) for a in nf_e]
    wf = np.zeros(max(n_end, len(s0.waveform)) + chunk, np.float32)
    wf[:len(s0.waveform)] = s0.waveform
    wf = wf.tolist()
    live = torch.ones(B, dtype=torch.bool, device=dev)
    e_max = torch.zeros(B, **f64)
    checks, ratios = [], []
    n = 0
    while n < n_end:
        n0 = n
        v_s, i_s, fe_s, fh_s = [], [], [[] for _ in range(n_f)], \
            [[] for _ in range(n_f)]
        for _j in range(n_sub):
            for _ in range(D):
                st.step(wf[n])
                n += 1
            v_s.append(pr.port_v(st.E))
            i_s.append(pr.port_i(st.H))
            for k, a in enumerate(pr.face_e(st.E)):
                fe_s[k].append(a)
            for k, a in enumerate(pr.face_h(st.H)):
                fh_s[k].append(a)
        t_e = (np.arange(1, n_sub + 1) * D + n0) * s0.dt
        t_h = t_e - 0.5 * s0.dt
        t_e = torch.as_tensor(t_e, **f64)
        t_h = torch.as_tensor(t_h, **f64)

        def phase(w, t):
            return torch.exp(-1j * (w[:, None] * t[None, :]))  # (Nf, n_sub)

        pe, ph = phase(w_p, t_e), phase(w_p, t_h)
        V = torch.stack(v_s, -1).to(torch.complex128)  # (B, ports, n_sub)
        I = torch.stack(i_s, -1).to(torch.complex128)
        uf += torch.where(live.view(-1, 1, 1), V @ pe.T, 0)
        if_ += torch.where(live.view(-1, 1, 1), I @ ph.T, 0)
        pe, ph = phase(w_n, t_e), phase(w_n, t_h)
        for k in range(n_f):
            Se = torch.stack(fe_s[k], -1).to(torch.complex128)  # (B,2,nu,nv,S)
            Sh = torch.stack(fh_s[k], -1).to(torch.complex128)
            de = torch.einsum("bcuvs,fs->bfcuv", Se, pe)
            dh = torch.einsum("bcuvs,fs->bfcuv", Sh, ph)
            nf_e[k] += torch.where(live.view(-1, 1, 1, 1, 1), de, 0)
            nf_h[k] += torch.where(live.view(-1, 1, 1, 1, 1), dh, 0)
        energy = sum((e.to(torch.float64) ** 2).sum(dim=(1, 2, 3)) for e in st.E)
        e_max = torch.maximum(e_max, energy)
        r = torch.where(e_max > 0, energy / e_max, torch.ones_like(e_max))
        checks.append(n)
        ratios.append(r.cpu().numpy())
        if own:
            for b in range(B):
                if stop[b] is None and ((ratios[-1][b] < end_criteria
                                         and n > s0.n_source_steps)
                                        or n >= n_end):
                    stop[b] = n
            if all(x is not None for x in stop):
                break
        live = torch.tensor([x is None or n < x for x in stop], device=dev)
    return RefRun(
        uf=uf.cpu().numpy(), if_=if_.cpu().numpy(),
        nf_e=[a.cpu().numpy() for a in nf_e],
        nf_h=[a.cpu().numpy() for a in nf_h],
        checks=np.asarray(checks), ratios=np.stack(ratios, 1),
        steps=np.asarray([n if x is None else x for x in stop]),
    )
