"""The marched form's operating point on the card: its time at each core
tile at the 8-variant sweep.

``fdtd_cuda.chunk_steps_batch`` takes the marched form
(``ops/chunk_march.py``, ``csrc/fdtd_chunk_march.cu``) where a batch
spills the L2 under MUR or PEC, at the y–z core tile that
``chunk_march.plan_layout`` picks (``chunk_march._pick``: the least
rounds × planes × warps). This script times one launch of one chunk
(2 × 244 steps) of ``bench.py``'s 8-variant sweep (100×109×50 cells a
variant, from a seeded random state at E buffer 1) at the plan's pick and
at each core of ``--cores``, beside the streamed form on the same state,
three launches behind a sleep kernel twice (the better kept). Each core's
model cost (``chunk_march._cost``) is printed beside its time, and the
correlation of the two over the cores.

Prints one JSON line per form and core (``form``, ``core``,
``us_per_launch``, ``us_per_step``, ``model``), then the ``summary`` line
with the card's name and power limit.

Usage:
    python -m fdtd_solver_antennas_tpu_torch.examples.march_tune [--cores 14x25,16x17] [--device cuda]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..ops import chunk_march, fdtd_cuda
from ..ops.fdtd import chunk_geometry
from ..solvers.sweep import prepare_patch_geometry_sweep
from ..utils.backend import ensure_backend
from .scenes import card_line, device_ms, sweep_operands, sweep_variants

CORES = ((14, 17), (16, 17), (19, 17), (10, 25), (11, 25), (13, 25),
         (22, 13), (28, 10))


def parse_cores(text: str):
    """``"14x25,16x17"`` as ``((14, 25), (16, 17))``."""
    out = []
    for item in filter(None, text.split(",")):
        cy, cz = item.split("x")
        out.append((int(cy), int(cz)))
    return tuple(out)


def march_tune(*, cores=CORES, device="cuda", seed=113):
    """The lines the script prints, as dicts."""
    variants = sweep_variants()
    B = len(variants)
    prep = prepare_patch_geometry_sweep(variants, n_steps_max=2000,
                                        end_criteria=1e-4, device=device)
    sim, ops = prep.sim, sweep_operands(prep)
    D, n_sub, _, _ = chunk_geometry(sim)
    steps = n_sub * D
    rng = np.random.default_rng(seed)
    st = fdtd_cuda.new_batch_state(sim.padded_shape, sim.device, False, B)
    for t in (*st.e[0], *st.e[1], *st.h):
        t.copy_(torch.from_numpy(rng.standard_normal(t.shape).astype(np.float32)))
    st.parity = [1] * B
    wf = torch.from_numpy(rng.uniform(-1.0, 1.0, 7 + steps).astype(
        np.float32)).to(sim.device)
    bufs = torch.zeros((B, n_sub, ops.probes.n_rows), device=sim.device)
    act = tuple([True] * B)
    sms = torch.cuda.get_device_properties(sim.device).multi_processor_count

    def timed(fn):
        return min(device_ms(fn, reps=3, warmup=1) for _ in range(2)) * 1e3

    rows = [dict(form="streamed", us_per_launch=timed(
        lambda: fdtd_cuda.chunk_steps_batch(ops, st, wf, 7, n_sub, D, bufs,
                                            act, form="streamed")))]
    pick = chunk_march.plan(ops, B)
    runs = [pick.core] + [core for core in cores if core != pick.core]
    for core in runs:
        plan = chunk_march.plan(ops, B, core=core)
        mask = fdtd_cuda._device_mask(st, act)
        us = timed(lambda: chunk_march.chunk_steps(ops, st, wf, 7, n_sub, D,
                                                   bufs, act, plan, mask))
        model = chunk_march._cost(plan.core, plan.segments,
                                  plan.items_per_variant * B,
                                  plan.blocks_per_sm * sms)
        rows.append(dict(form="marched", T=plan.T, core=list(plan.core),
                         tiles=list(plan.tiles), segments=list(plan.segments),
                         blocks=plan.blocks, threads=plan.threads,
                         picked=core == pick.core, us_per_launch=us,
                         model=model))
    for r in rows:
        r["us_per_step"] = r["us_per_launch"] / steps
    marched = [r for r in rows if r["form"] == "marched"]
    corr = float(np.corrcoef([r["model"] for r in marched],
                             [r["us_per_launch"] for r in marched])[0, 1])
    best = min(marched, key=lambda r: r["us_per_launch"])
    rows.append(dict(summary=True, steps_a_launch=steps, batch=B,
                     T=pick.T, pick=list(pick.core), best=best["core"],
                     model_time_correlation=corr, card=card_line()))
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cores", type=str, default=None,
                    help="cyxcz cores to time beside the plan's pick")
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)
    ensure_backend(args.device)
    cores = parse_cores(args.cores) if args.cores else CORES
    for row in march_tune(cores=cores, device=args.device):
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
