"""The stream route's operating point on the card: the march's time at
each T.

Counterpart of ``examples/stream_tune.py``. The JAX script times the TPU
stream kernel at every legal (swap, Bx, T) on the tall patch
(161×121×160 lines, a fixed 4,000-step run). ``swap`` and ``Bx`` are that
kernel's lane orientation and its VMEM tile along x: the TPU layout, which
does not carry over (the march walks a y–z tile along x, ``csrc/fdtd_stream.cu``).
What carries over is T, the leapfrog steps per launch, which the
resolver (``ops/fdtd.py::resolve_pallas_mode``) sets to the deepest the
march allows. This script forces stream mode (``pallas_mode="stream"``)
at each T of ``--T`` through ``FDTDConfig.stream_T``; a T the resolver
refuses prints a ``skip`` line, as the JAX script does on ``ValueError``.

Every T runs at one probe decimation: the largest multiple of every T
the march allows that is at most the automatic one (84 on the tall grid,
where the automatic one is 86 and T reaches 4). So every T runs the same
steps and samples the same rows, the walls compare like for like, and
each T's ``uf`` is held against the first T's at rtol 2e-4, atol
1e-5·max; the largest gap is printed (bit-equal is expected: each cell's
update is the same arithmetic in the same order whatever T is).

Each T runs once to warm up, then the best wall of two runs, the card
synchronized before and after. Prints one JSON line per T (``T``,
``gcells_per_s``, ``wall_s``, ``steps``, ``uf_gap``), then the ``best``
line.

Usage:
    python -m fdtd_solver_antennas_tpu_torch.examples.stream_tune [--T 1,2,3,4,5] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import math
import time

import numpy as np
import torch

from ..ops import fdtd_stream
from ..ops.fdtd import FDTDConfig, build_simulation
from ..utils.backend import ensure_backend
from .scenes import tall_scene

RTOL, ATOL_REL = 2e-4, 1e-5
N_STEPS = 4000  # the JAX script's fixed run


def build(T, decim=None, *, make_scene=tall_scene, n_steps=N_STEPS,
          device="cuda", pallas_mode="stream"):
    """The scene of ``make_scene`` (the tall patch) for a fixed
    ``n_steps``-step run (energy criterion off, a check every 500 steps),
    forced to ``pallas_mode`` at ``stream_T=T`` and the probe decimation
    ``decim`` (None: automatic)."""
    scene, grid, f0, fc = make_scene()
    cfg = FDTDConfig(n_steps_max=n_steps, end_criteria=1e-30, check_every=500,
                     pallas_mode=pallas_mode, stream_T=T,
                     probe_decimation=decim)
    return build_simulation(
        scene, grid, f0=f0, fc=fc, cfg=cfg, device=device,
        port_freqs_hz=np.linspace(2e9, 3e9, 51),
        nf_freqs_hz=np.array([2.45e9]),
    )


def common_decimation(Ts, *, make_scene=tall_scene, n_steps=N_STEPS,
                      device="cuda") -> int:
    """The largest multiple of every T in ``Ts`` the march allows on the
    scene's grid that is at most the automatic probe decimation (raises
    where there is none)."""
    sim = build(None, make_scene=make_scene, n_steps=n_steps, device=device,
                pallas_mode="chunk")
    auto = int(sim.probe_decim)
    t_max = fdtd_stream.max_T(sim.padded_shape,
                              sim.cfg.boundary.upper().startswith("MUR"),
                              sim.cfg.pml_cells() > 0)
    legal = [t for t in Ts if 1 <= t <= min(t_max, auto)]
    step = math.lcm(*legal) if legal else 1
    if step > auto:
        raise ValueError(
            f"no probe decimation up to the automatic {auto} is a multiple "
            f"of every T in {legal}; time fewer T values at once")
    return auto // step * step


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def stream_tune(*, Ts=(1, 2, 3, 4, 5), device="cuda", make_scene=None,
                n_steps=None, reps: int = 2, decim=None):
    """Time each T (one warm-up run, the best of ``reps``); print the JSON
    lines. Returns ``(records, outputs)``: the printed records and each
    timed T's last run output, by T. ``make_scene`` None is the tall patch
    (:func:`scenes.tall_scene`), ``n_steps`` None :data:`N_STEPS`, ``decim``
    None :func:`common_decimation`."""
    make_scene = make_scene or tall_scene
    n_steps = n_steps or N_STEPS
    if decim is None:
        decim = common_decimation(Ts, make_scene=make_scene, n_steps=n_steps,
                                  device=device)
    results, outs, first = [], {}, None
    for t in Ts:
        try:
            sim = build(t, decim, make_scene=make_scene, n_steps=n_steps,
                        device=device)
        except ValueError as e:
            print(json.dumps({"T": t, "skip": str(e)[:120]}), flush=True)
            continue
        out = sim.run()
        wall = float("inf")
        for _ in range(reps):
            _sync(sim.device)
            t0 = time.perf_counter()
            out = sim.run()
            _sync(sim.device)
            wall = min(wall, time.perf_counter() - t0)
        steps = int(out["steps"])
        uf = np.asarray(out["uf"])
        assert np.isfinite(uf).all(), f"T={t}: uf not finite"
        if first is None:
            first = uf
        atol = ATOL_REL * float(np.abs(first).max())
        if not np.allclose(uf, first, rtol=RTOL, atol=atol):
            raise AssertionError(f"T={t}: uf differs from T={Ts[0]}'s past "
                                 f"rtol {RTOL}, atol {atol:.3e}")
        g = sim.grid.num_cells * steps / wall / 1e9
        rec = {"T": t, "gcells_per_s": round(g, 3), "wall_s": round(wall, 3),
               "steps": steps,
               "uf_gap": float(np.abs(uf - first).max())}
        results.append(rec)
        outs[t] = out
        print(json.dumps(rec), flush=True)
    if results:
        best = max(results, key=lambda r: r["gcells_per_s"])
        print(json.dumps({"best": best}), flush=True)
    return results, outs


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--T", type=str, default="1,2,3,4,5",
                    help="comma list of steps per launch to try")
    ap.add_argument("--device", type=str, default="cuda",
                    help="'cuda' runs the CUDA kernels, 'cpu' their plain "
                         "PyTorch twins")
    args = ap.parse_args(argv)
    ensure_backend(args.device)
    stream_tune(Ts=tuple(int(v) for v in args.T.split(",")),
                device=args.device)


if __name__ == "__main__":
    main()
