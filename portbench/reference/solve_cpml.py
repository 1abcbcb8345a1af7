"""The CPML jobs end to end in the reference: scene, build, run, post.

:func:`solve_microstrip` (the GUI's Microstrip 3D job) and
:func:`solve_sweep_cpml` (the canonical patch's sweep under ``PML_N``)
return a :class:`solve.Solved`, as :func:`solve.solve_design` and
:func:`solve.solve_sweep` do for MUR, from :func:`cpml.run` in place of
:func:`yee.run`; the post-processing follows :func:`solve._solve`.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from . import cpml
from .microstrip import microstrip_scene
from .nf2ff import nf2ff_transform
from .ports import find_resonance, port_spectra
from .scenes import CHECK_EVERY, RunSpec, sweep_scenes
from .solve import Answer, Solved, directivity


def _solve(sims, spec: RunSpec, targets, *, device, dtype, decim: int,
           stop_steps, fi_from=None) -> Solved:
    s0 = sims[0]
    r = cpml.run(sims, device=device, dtype=dtype, decim=decim,
                 stop_steps=stop_steps, check_every=CHECK_EVERY,
                 port_freqs_hz=spec.port_freqs_hz,
                 nf_freqs_hz=spec.nf_freqs_hz, end_criteria=spec.end_criteria,
                 n_steps_max=spec.n_steps_max)
    dft_dt = s0.dt * decim
    B, n_ports = r.uf.shape[:2]
    s11 = np.empty_like(r.uf)
    f_res = np.empty(B)
    for b in range(B):
        for p in range(n_ports):
            sp = port_spectra(spec.port_freqs_hz, r.uf[b, p], r.if_[b, p],
                              dft_dt)
            s11[b, p] = sp.s11
            if p == 0:
                f_res[b] = find_resonance(sp, targets[b])[0]
    e_ratio = np.array([r.ratios[b, list(r.checks).index(r.steps[b])]
                        for b in range(B)])
    ans = Answer(steps=r.steps, e_ratio=e_ratio, uf=r.uf, if_=r.if_,
                 nf_e=r.nf_e, nf_h=r.nf_h, s11=s11, f_res=f_res,
                 decim=int(decim))
    if spec.theta is not None:
        f_at = f_res[0] if fi_from is None else fi_from
        fi = int(np.argmin(np.abs(spec.nf_freqs_hz - f_at)))
        ff = nf2ff_transform(
            s0.faces, [a[0, fi:fi + 1] for a in r.nf_e],
            [a[0, fi:fi + 1] for a in r.nf_h], dft_dt,
            spec.nf_freqs_hz[fi:fi + 1], spec.theta, spec.phi,
            center_m=spec.nf_center, device=device)
        ans.pattern = directivity(ff)
    return Solved(answer=ans, ratios=r.ratios, checks=r.checks,
                  n_steps_max=spec.n_steps_max,
                  n_source_steps=s0.n_source_steps,
                  end_criteria=spec.end_criteria, decim_max=s0.decim_max,
                  freq_hz=spec.port_freqs_hz)


def solve_microstrip(config: dict, traffic: dict, loss_tangent: float, *,
                     device, dtype=torch.float32, decim: int,
                     stop_steps: Optional[int] = None,
                     pattern_f_hz: Optional[float] = None) -> Solved:
    """The Microstrip 3D job: ``stop_steps`` None stops on the reference's
    own energy criterion; ``pattern_f_hz`` picks the far-field row (None:
    the reference's own resonance)."""
    spec = microstrip_scene(config, traffic["boundary"], loss_tangent)
    sim = cpml.build_cpml(spec.scene, spec.grid, f0=spec.f0, fc=spec.fc,
                          boundary=spec.boundary,
                          n_steps_max=spec.n_steps_max)
    return _solve([sim], spec, [spec.f0], device=device, dtype=dtype,
                  decim=decim,
                  stop_steps=None if stop_steps is None else [stop_steps],
                  fi_from=pattern_f_hz)


def solve_sweep_cpml(config: dict, traffic: dict, loss_tangent: float, *,
                     device, dtype=torch.float32, decim: int,
                     stop_steps: Optional[Sequence[int]] = None) -> Solved:
    """The sweep's job under CPML: every variant built in full on the
    union grid."""
    scenes, spec = sweep_scenes(config, traffic, traffic["boundary"],
                                loss_tangent)
    sims = [cpml.build_cpml(s, spec.grid, f0=spec.f0, fc=spec.fc,
                            boundary=spec.boundary,
                            n_steps_max=spec.n_steps_max)
            for s in scenes]
    return _solve(sims, spec, [spec.f0] * len(sims), device=device,
                  dtype=dtype, decim=decim, stop_steps=stop_steps)
