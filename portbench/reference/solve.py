"""A benchmark job end to end in the reference: scene, build, run, post.

:func:`solve_design` and :func:`solve_sweep` return an :class:`Answer`,
the form in which the harness also holds the program's answer, so that
``portbench/check.py`` compares the two field by field.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from .build import RefSim, build
from .nf2ff import nf2ff_transform
from .ports import find_resonance, port_spectra
from .scenes import CHECK_EVERY, RunSpec, design_scene, sweep_scenes
from .yee import run


@dataclasses.dataclass
class Answer:
    """One job's answer, with a leading variant axis (B = 1 for a design)."""

    steps: np.ndarray  # (B,) int
    e_ratio: np.ndarray  # (B,)
    uf: np.ndarray  # (B, ports, Nf) complex
    if_: np.ndarray
    nf_e: List[np.ndarray]  # per face (B, Nnf, 2, nu, nv) complex
    nf_h: List[np.ndarray]
    s11: np.ndarray  # (B, ports, Nf) complex
    f_res: np.ndarray  # (B,) Hz, port 1's resonance
    decim: int
    pattern: Optional[np.ndarray] = None  # (nth, nph) linear directivity


@dataclasses.dataclass
class Solved:
    """The reference's answer with what the comparison also needs."""

    answer: Answer
    ratios: np.ndarray  # (B, n_checks)
    checks: np.ndarray  # (n_checks,)
    n_steps_max: int
    n_source_steps: int
    end_criteria: float
    decim_max: int
    freq_hz: np.ndarray  # the port sweep


def directivity(ff, fi: int = 0) -> np.ndarray:
    """The dBi grid as linear directivity, as the program's grid reads."""
    e = ff.E_norm[fi]
    db = 20.0 * np.log10(np.maximum(e / e.max(), 1e-15)) + 10.0 * np.log10(
        ff.Dmax[fi])
    return 10.0 ** (db / 10.0)


def _solve(sims: Sequence[RefSim], spec: RunSpec, targets, *, device, dtype,
           decim: int, stop_steps, fi_from=None) -> Solved:
    s0 = sims[0]
    r = run(sims, device=device, dtype=dtype, decim=decim,
            stop_steps=stop_steps, check_every=CHECK_EVERY,
            port_freqs_hz=spec.port_freqs_hz, nf_freqs_hz=spec.nf_freqs_hz,
            end_criteria=spec.end_criteria, n_steps_max=spec.n_steps_max)
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


def design_target_hz(config: dict) -> float:
    """The frequency the designer resolves at: the highest instance's."""
    return max(p["frequency_ghz"] * 1e9
               for p in config.get("patches", []) + config.get("horns", []))


def solve_design(config: dict, traffic: dict, loss_tangent: float, *,
                 device, dtype=torch.float32, decim: int,
                 stop_steps: Optional[int] = None,
                 pattern_f_hz: Optional[float] = None) -> Solved:
    """The designer's job: ``stop_steps`` None stops on the reference's
    own energy criterion; ``pattern_f_hz`` picks the far-field row (None:
    the reference's own resonance)."""
    spec = design_scene(config, traffic["boundary"], loss_tangent)
    sim = build(spec.scene, spec.grid, f0=spec.f0, fc=spec.fc,
                boundary=spec.boundary, n_steps_max=spec.n_steps_max)
    return _solve([sim], spec, [design_target_hz(config)], device=device,
                  dtype=dtype, decim=decim,
                  stop_steps=None if stop_steps is None else [stop_steps],
                  fi_from=pattern_f_hz)


def solve_sweep(config: dict, traffic: dict, loss_tangent: float, *,
                device, dtype=torch.float32, decim: int,
                stop_steps: Optional[Sequence[int]] = None) -> Solved:
    """The sweep's job: every variant built in full on the union grid."""
    scenes, spec = sweep_scenes(config, traffic, traffic["boundary"],
                                loss_tangent)
    sims = [build(s, spec.grid, f0=spec.f0, fc=spec.fc,
                  boundary=spec.boundary, n_steps_max=spec.n_steps_max)
            for s in scenes]
    f0 = config["frequency_ghz"] * 1e9
    return _solve(sims, spec, [f0] * len(sims), device=device, dtype=dtype,
                  decim=decim, stop_steps=stop_steps)
