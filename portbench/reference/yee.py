"""The plain Yee leapfrog, its probes, DFTs and energy check.

Plain PyTorch on one device, in the precision it is asked for (float32
for the reference, a lower one for the control), over B variants of one
grid at once (a leading variant axis; B = 1 for a single design). The
update follows the port's plain twins (``ops/fdtd_cuda.py``'s
``h_update_plain``, ``e_update_plain`` and ``mur_faces_plain``, walls x,
then y, then z); the probes sample after every D steps, E at that time and
H half a step earlier, and fold into float64 DFT sums once a chunk of
``n_sub = check_every // D`` intervals; the energy of E is checked after
every chunk.

The run follows the stop the program reported for each variant (its
``steps``): a variant's sums stop at its own stop, and the ratio of every
check up to it is kept, so :func:`stop_gap` can say whether the program
stopped where the reference's energy says it should.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence

import numpy as np
import torch

from .build import RefSim
from .physics import MU0


@dataclasses.dataclass
class RefRun:
    uf: np.ndarray  # (B, ports, Nf) complex: Σ V(t)·e^{−jωt}
    if_: np.ndarray
    nf_e: List[np.ndarray]  # per face (B, Nnf, 2, nu, nv) complex
    nf_h: List[np.ndarray]
    checks: np.ndarray  # (n_checks,) step of each energy check
    ratios: np.ndarray  # (B, n_checks) energy ratio at each check (float64)
    steps: np.ndarray  # (B,) the step each variant's sums stopped at


def _fdiff(a, dim):
    return torch.diff(a, dim=dim, append=torch.zeros_like(a.narrow(dim, 0, 1)))


def _bdiff(a, dim):
    return torch.diff(a, dim=dim, prepend=torch.zeros_like(a.narrow(dim, 0, 1)))


def _vec(v, axis, dev, dtype):
    shape = [1, 1, 1, 1]
    shape[axis + 1] = -1
    return torch.as_tensor(v, device=dev).to(dtype).view(shape)


class Stepper:
    """B variants' fields and coefficients on ``device`` in ``dtype``."""

    def __init__(self, sims: Sequence[RefSim], device, dtype):
        s0 = sims[0]
        self.dev, self.dtype = torch.device(device), dtype
        shape = (len(sims), *s0.grid.shape)

        def stack(arrs):
            return torch.from_numpy(np.stack(arrs)).to(self.dev).to(dtype)

        self.ca = [stack([s.ca[m] for s in sims]) for m in range(3)]
        self.cb = [stack([s.cb[m] for s in sims]) for m in range(3)]
        zero = np.zeros(s0.grid.shape, np.float32)
        self.src = [stack([s.src.get(m, zero) for s in sims])
                    if m in s0.src else None for m in range(3)]
        self.ip = [_vec(s0.inv_p[a], a, self.dev, dtype) for a in range(3)]
        self.id = [_vec(s0.inv_d[a], a, self.dev, dtype) for a in range(3)]
        self.dtmu = float(np.float32(s0.dt / MU0))
        self.mur = s0.mur
        self.shape = shape
        self.E = [torch.zeros(shape, device=self.dev, dtype=dtype)
                  for _ in range(3)]
        self.H = [torch.zeros(shape, device=self.dev, dtype=dtype)
                  for _ in range(3)]

    def step(self, s: float) -> None:
        Ex, Ey, Ez = self.E
        Hx, Hy, Hz = self.H
        ipx, ipy, ipz = self.ip
        Hx.sub_(self.dtmu * (_fdiff(Ez, 2) * ipy - _fdiff(Ey, 3) * ipz))
        Hy.sub_(self.dtmu * (_fdiff(Ex, 3) * ipz - _fdiff(Ez, 1) * ipx))
        Hz.sub_(self.dtmu * (_fdiff(Ey, 1) * ipx - _fdiff(Ex, 2) * ipy))
        idx, idy, idz = self.id
        curl = (_bdiff(Hz, 2) * idy - _bdiff(Hy, 3) * idz,
                _bdiff(Hx, 3) * idz - _bdiff(Hz, 1) * idx,
                _bdiff(Hy, 1) * idx - _bdiff(Hx, 2) * idy)
        Eo = self.E
        En = []
        for m in range(3):
            e = self.ca[m] * Eo[m] + self.cb[m] * curl[m]
            if self.src[m] is not None:
                e = e + self.src[m] * s
            En.append(e)
        for axis in range(3):  # first-order MUR walls, x then y then z
            dim = axis + 1
            n = self.shape[dim]
            for side, wall in enumerate((0, n - 1)):
                nb = wall - 1 if side else wall + 1
                c = self.mur[axis][side]
                for comp in range(3):
                    if comp == axis:
                        continue
                    new = (Eo[comp].select(dim, nb)
                           + c * (En[comp].select(dim, nb)
                                  - Eo[comp].select(dim, wall)))
                    En[comp].select(dim, wall).copy_(new)
        self.E = En


class Probes:
    """The samples of one interval: port V and I, and each face's
    tangential E (two edges averaged) and H (four faces averaged)."""

    def __init__(self, sim: RefSim, device):
        self.sim = sim
        self.dev = torch.device(device)

    def port_v(self, E) -> torch.Tensor:
        out = []
        for p in self.sim.ports:
            col = E[p.axis][(slice(None), *p.sl)].to(torch.float64)
            w = torch.as_tensor(-p.dl_m, device=self.dev, dtype=torch.float64)
            out.append((col * w).sum(-1))
        return torch.stack(out, 1)  # (B, ports)

    def port_i(self, H) -> torch.Tensor:
        out = []
        for p in self.sim.ports:
            acc = 0.0
            for comp, idx, w in p.i_terms:
                acc = acc + H[comp][(slice(None), *idx)].to(torch.float64) * w
            out.append(acc)
        return torch.stack(out, 1)

    @staticmethod
    def _plane(F, axis, m):
        return F.select(axis + 1, m)  # (B, a, b): the other two axes in order

    def face_e(self, E) -> List[torch.Tensor]:
        out = []
        for f in self.sim.faces:
            u = self._plane(E[f.u_axis], f.axis, f.m).to(torch.float64)
            v = self._plane(E[f.v_axis], f.axis, f.m).to(torch.float64)
            u = u[:, f.u0:f.u1, f.v0:f.v1 + 1]
            v = v[:, f.u0:f.u1 + 1, f.v0:f.v1]
            eu = 0.5 * u[:, :, :-1] + 0.5 * u[:, :, 1:]
            ev = 0.5 * v[:, :-1, :] + 0.5 * v[:, 1:, :]
            out.append(torch.stack([eu, ev], 1))  # (B, 2, nu, nv)
        return out

    def face_h(self, H) -> List[torch.Tensor]:
        out = []
        for f in self.sim.faces:
            def two(F):
                a = self._plane(F, f.axis, f.m - 1).to(torch.float64)
                b = self._plane(F, f.axis, f.m).to(torch.float64)
                return a, b
            ua, ub = two(H[f.u_axis])
            va, vb = two(H[f.v_axis])
            su = (ua + ub)[:, f.u0:f.u1 + 1, f.v0:f.v1]
            sv = (va + vb)[:, f.u0:f.u1, f.v0:f.v1 + 1]
            hu = 0.25 * (su[:, :-1] + su[:, 1:])
            hv = 0.25 * (sv[:, :, :-1] + sv[:, :, 1:])
            out.append(torch.stack([hu, hv], 1))
        return out


def run(sims: Sequence[RefSim], *, device, dtype, decim: int,
        stop_steps: Optional[Sequence[int]], check_every: int,
        port_freqs_hz, nf_freqs_hz, end_criteria: float = 0.0,
        n_steps_max: int = 0) -> RefRun:
    """Step B variants (one :class:`RefSim` each, one grid) until every
    variant has reached its ``stop_steps``; sample every ``decim`` steps.

    ``stop_steps`` None: each variant stops on its own energy criterion
    (ratio below ``end_criteria`` after the source has run out) or at
    ``n_steps_max``, as the program's loop decides (the control's run)."""
    s0 = sims[0]
    B = len(sims)
    D = int(decim)
    n_sub = max(1, int(check_every) // D)
    chunk = n_sub * D
    own = stop_steps is None
    stop = [None] * B if own else [int(x) for x in stop_steps]
    n_end = int(n_steps_max) if own else max(stop)
    st = Stepper(sims, device, dtype)
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


def stop_gap(ref: RefRun, b: int, steps: int, n_steps_max: int,
             n_source_steps: int, end: float) -> float:
    """How far the reference's energy ratio lies from the criterion where
    it and the program decide differently, as |ln(ratio / end)|: 0 where
    every decision agrees, inf where the program stopped between checks or
    before the source had run out."""
    checks = list(ref.checks)
    if steps not in checks:
        return math.inf
    gap = 0.0
    for i, n in enumerate(checks):
        if n > steps:
            break
        r = float(ref.ratios[b, i])
        met = r < end and n > n_source_steps
        if n < steps:  # the program went on: the criterion was not met
            if met:
                gap = max(gap, abs(math.log(r / end)))
        elif steps < n_steps_max:  # the program stopped on the criterion
            if n <= n_source_steps:
                return math.inf
            if not met:
                gap = max(gap, abs(math.log(max(r, 1e-300) / end)))
    return gap
