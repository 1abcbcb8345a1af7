"""Mid-run checkpoint and resume: run part of the steps, save the state to
an ``.npz``, load it into a fresh preparation and finish.

Counterpart of ``examples/checkpoint_resume.py``, with its lines. The JAX
script says the result is identical to a straight run; this one checks
it: the same 12,000-step preparation run straight, and the resumed run's
largest gaps from it in ``uf``, ``if_`` and the fields, its ``steps`` and
``e_ratio``, held at the north-star tolerance (rtol 2e-4, atol
1e-5·max|straight|), and whether the two are bit-equal. A run stops at a
chunk's end, so the first segment ends at the first chunk end past its
step budget and the resumed run walks the straight run's chunks.

Usage:
    python -m fdtd_solver_antennas_tpu_torch.examples.checkpoint_resume [--device cuda] [--outdir outputs]
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from ..models.params import PatchAntennaParams
from ..post.checkpoint import load_state, save_state
from ..solvers.patch_fixed import prepare_patch_fixed
from ..utils.backend import ensure_backend

RTOL, ATOL_REL = 2e-4, 1e-5  # the north-star tolerance


def _np(a) -> np.ndarray:
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _gap(a, b) -> float:
    a, b = _np(a), _np(b)
    return float(np.abs(a - b).max()) if a.size else 0.0


def _close(a, b) -> bool:
    a, b = _np(a), _np(b)
    atol = ATOL_REL * float(np.abs(b).max()) if b.size else 0.0
    return bool(np.allclose(a, b, rtol=RTOL, atol=atol))


def compare_runs(resumed: dict, straight: dict) -> dict:
    """The resumed run against the straight one: the largest gap of
    ``uf``, ``if_`` and the fields, both runs' ``steps`` and ``e_ratio``,
    ``close`` (same steps, everything at rtol 2e-4, atol 1e-5·max) and
    ``bit_equal``."""
    pairs = {"uf": (resumed["uf"], straight["uf"]),
             "if_": (resumed["if_"], straight["if_"])}
    for i, (a, b) in enumerate(zip(resumed["fields"], straight["fields"])):
        pairs[f"field_{i}"] = (a, b)
    gaps = {k: _gap(a, b) for k, (a, b) in pairs.items()}
    steps = (int(resumed["steps"]), int(straight["steps"]))
    ratio = (float(resumed["e_ratio"]), float(straight["e_ratio"]))
    close = steps[0] == steps[1] and all(_close(a, b)
                                         for a, b in pairs.values())
    bit = steps[0] == steps[1] and ratio[0] == ratio[1] and all(
        np.array_equal(_np(a), _np(b)) for a, b in pairs.values())
    return dict(gaps=gaps, steps=steps, e_ratio=ratio, close=close,
                bit_equal=bit)


def checkpoint_resume(*, outdir="outputs", device="cuda",
                      n_steps_first: int = 4000,
                      n_steps_max: int = 12_000) -> dict:
    """Segment 1 to ``n_steps_first`` (energy criterion off), saved to
    ``<outdir>/patch_ckpt.npz``; segment 2 resumed from the file in a new
    preparation of ``n_steps_max`` steps; then the check against a straight
    run of that preparation (raises when the two disagree)."""
    params = PatchAntennaParams.from_user_units(
        frequency_ghz=2.45, er=4.3, h_mm=1.6, loss_tangent=0.02)
    outdir = Path(outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    path = outdir / "patch_ckpt.npz"

    # segment 1: stop early, checkpoint
    prep = prepare_patch_fixed(params, n_steps_max=n_steps_first,
                               end_criteria=1e-30, device=device)
    assert prep.ok, prep.message
    out = prep.sim.run()
    save_state(path, out)
    print(f"checkpointed at step {int(out['steps'])} → {path}")

    # segment 2 (could be a new process): resume to completion
    prep2 = prepare_patch_fixed(params, n_steps_max=n_steps_max,
                                device=device)
    assert prep2.ok, prep2.message
    out2 = prep2.sim.run(resume_state=load_state(path))
    print(
        f"resumed and finished at step {int(out2['steps'])}, "
        f"energy ratio {float(out2['e_ratio']):.2e}"
    )

    # the same preparation run straight
    straight = prep2.sim.run()
    cmp = compare_runs(out2, straight)
    g = cmp["gaps"]
    fields = max(v for k, v in g.items() if k.startswith("field_"))
    print(
        f"straight run: step {cmp['steps'][1]}, energy ratio "
        f"{cmp['e_ratio'][1]:.2e}; resumed vs straight: max |gap| uf "
        f"{g['uf']:.3e}, if_ {g['if_']:.3e}, fields {fields:.3e}; within "
        f"rtol {RTOL:g}, atol {ATOL_REL:g}·max: {cmp['close']}; bit-equal: "
        f"{cmp['bit_equal']}"
    )
    if not cmp["close"]:
        raise AssertionError(f"the resumed run differs from the straight "
                             f"run: {cmp}")
    return dict(first=out, resumed=out2, straight=straight, path=path, **cmp)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--outdir", type=str, default="outputs")
    ap.add_argument("--device", type=str, default="cuda",
                    help="'cuda' runs the CUDA kernels, 'cpu' their plain "
                         "PyTorch twins")
    args = ap.parse_args(argv)
    ensure_backend(args.device)
    checkpoint_resume(outdir=args.outdir, device=args.device)


if __name__ == "__main__":
    main()
