"""The numbers that decide ``correct``: the program's answer against the
plain reference's (``portbench/reference``), each held to its limit.

Each number is a gap between two answers to one job, worst over the
job's variants, ports, faces and frequencies:

- ``decim_excess``: how far the program's probe decimation lies above the
  largest the reference's sampling rule allows (exact: limit 0);
- ``stop_gap``: where the program and the reference's energy decide the
  stop differently, |ln(ratio / criterion)| of the reference's ratio
  there (0 where every decision agrees);
- ``e_ratio_gap``: |ln| of the program's energy ratio at its stop over the
  reference's at the same step;
- ``port_dft_gap``: the port V and I DFT sums, the largest difference
  over the largest reference magnitude of each port's row;
- ``face_dft_gap``: the Huygens faces' E and H DFT sums, the same per
  frequency over all faces;
- ``s11_gap``: the largest complex difference of S11 over the sweep;
- ``res_gap_db``: the reference's |S11| in dB at the program's resonance
  less its own at its resonance;
- ``pattern_gap`` (designs): the largest difference of the far-field
  directivity grid over its largest reference value.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np

from .reference.solve import Answer, Solved
from .reference.yee import RefRun, stop_gap


def _ratio(num: np.ndarray, den: np.ndarray) -> float:
    """max(num / den), 0/0 read as 0; inf where num is not finite."""
    if not np.all(np.isfinite(num)):
        return math.inf
    q = np.where(den > 0, num / np.maximum(den, 1e-300),
                 np.where(num > 0, np.inf, 0.0))
    return float(np.max(q))


def _rel(p: np.ndarray, r: np.ndarray, axes) -> float:
    return _ratio(np.abs(p - r).max(axis=axes), np.abs(r).max(axis=axes))


def _db(s11: np.ndarray) -> np.ndarray:
    return 20.0 * np.log10(np.maximum(np.abs(s11), 1e-30))


def compare(prog: Answer, ref: Solved) -> Dict[str, float]:
    """The gaps of ``prog`` from the reference's answer ``ref``."""
    r = ref.answer
    out: Dict[str, float] = {}
    out["decim_excess"] = float(max(0, prog.decim - ref.decim_max))
    run = RefRun(uf=r.uf, if_=r.if_, nf_e=r.nf_e, nf_h=r.nf_h,
                 checks=ref.checks, ratios=ref.ratios, steps=r.steps)
    B = len(r.steps)
    if len(prog.steps) != B or np.any(np.asarray(prog.steps) != r.steps):
        # the reference ran to the program's steps: a mismatch means the
        # answers are of different runs
        return {**out, "stop_gap": math.inf}
    out["stop_gap"] = max(
        stop_gap(run, b, int(prog.steps[b]), ref.n_steps_max,
                 ref.n_source_steps, ref.end_criteria) for b in range(B))
    pe = np.asarray(prog.e_ratio, np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        g = np.abs(np.log(pe / r.e_ratio))
    out["e_ratio_gap"] = float(g.max()) if np.all(np.isfinite(g)) else math.inf
    out["port_dft_gap"] = max(_rel(prog.uf, r.uf, 2), _rel(prog.if_, r.if_, 2))
    gaps = []
    for key in ("nf_e", "nf_h"):  # per (variant, frequency), over all faces
        pp, rr = getattr(prog, key), getattr(r, key)
        if [a.shape for a in pp] != [b.shape for b in rr]:
            gaps.append(math.inf)
            continue
        num = np.max([np.abs(a - b).max(axis=(2, 3, 4))
                      for a, b in zip(pp, rr)], axis=0)
        den = np.max([np.abs(b).max(axis=(2, 3, 4)) for b in rr], axis=0)
        gaps.append(_ratio(num, den))
    out["face_dft_gap"] = max(gaps)
    d = np.abs(prog.s11 - r.s11)
    both_nan = np.isnan(prog.s11) & np.isnan(r.s11)
    d = np.where(both_nan, 0.0, d)
    out["s11_gap"] = float(d.max()) if np.all(np.isfinite(d)) else math.inf
    res = []
    f = ref.freq_hz
    for b in range(B):
        if prog.f_res[b] == r.f_res[b]:
            res.append(0.0)
            continue
        ip = int(np.argmin(np.abs(f - prog.f_res[b])))
        ir = int(np.argmin(np.abs(f - r.f_res[b])))
        db = _db(r.s11[b, 0])
        res.append(float(abs(db[ip] - db[ir])))
    out["res_gap_db"] = max(res)
    if r.pattern is not None:
        if prog.pattern is None or prog.pattern.shape != r.pattern.shape:
            out["pattern_gap"] = math.inf
        else:
            out["pattern_gap"] = _rel(prog.pattern, r.pattern, None)
    return out


def verdict(numbers: Dict[str, float], limits: Dict[str, float]):
    """``(ok, rows)``: every number within its limit, and the rows
    ``(name, value, limit)`` in the limits' order. A number the limits do
    not name, or a limit with no number, fails."""
    rows = []
    ok = True
    for name in sorted(set(numbers) | set(limits)):
        v = numbers.get(name, math.inf)
        lim = limits.get(name, -math.inf)
        good = math.isfinite(v) and v <= lim
        ok = ok and good
        rows.append((name, v, lim))
    return ok, rows
