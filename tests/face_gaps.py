"""Pairwise gaps of four runs of the z = 131 scene under PML_4, on the CPU.

The runs: the port's explicit run at one rank (K2's slab stepper, its
plain twin here), the port's single-card run, the JAX package's
single-device run and its explicit run on a 1-device mesh (the ``shard=``
stream kernel in interpret mode). For each step count given, prints every
near-field face (and every output) where a pair differs by more than
rtol 2e-4, atol 1e-5·max|ref|, and the first E and H faces always: each
pair's largest difference, the same over the face's max, and the count
of entries past the tolerance.

    JAX_PLATFORMS=cpu python tests/face_gaps.py 20 30 40
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from _explicit_jax import jax_explicit, jax_sim  # noqa: E402
from _explicit_ranks import port_sim  # noqa: E402
from fdtd_solver_antennas_tpu_torch.parallel import build_explicit_run  # noqa: E402

RTOL, ATOL_REL = 2e-4, 1e-5
PAIRS = (("port", "jax_single"), ("port", "jax_shard"),
         ("jax_shard", "jax_single"), ("port", "port_single"))


def surface(out) -> dict:
    d = {"uf": out["uf"], "if_": out["if_"]}
    for key in ("nf_e", "nf_h"):
        for i, a in enumerate(out[key]):
            d[f"{key}[{i}]"] = a
    for i, a in enumerate(out["fields"]):
        d[f"field{i}"] = a
    return {k: np.asarray(v) for k, v in d.items()}


def main(steps) -> None:
    torch.set_num_threads(2)
    for n in steps:
        ctl = dict(n_steps=n, check_every=n)
        runs = {
            "port": build_explicit_run(port_sim("tall_z", "PML_4", 1, **ctl))(),
            "port_single": port_sim("tall_z", "PML_4", 1, **ctl).run(),
            "jax_single": jax_sim("tall_z", "PML_4", 1, **ctl).run(),
            "jax_shard": jax_explicit("tall_z", "PML_4", 1, **ctl),
        }
        surf = {k: surface(v) for k, v in runs.items()}
        print(f"=== {n} steps: " + ", ".join(
            f"{k} {int(v['steps'])}" for k, v in runs.items()))
        for key in surf["port"]:
            line, past = [], False
            for a, b in PAIRS:
                ref = surf[b][key]
                top = float(np.abs(ref).max())
                d = np.abs(surf[a][key] - ref)
                over = int((d > RTOL * np.abs(ref) + ATOL_REL * top).sum())
                past |= over > 0
                line.append(f"{a}-{b} {d.max():.3e} ({d.max() / max(top, 1e-30):.2e}"
                            f" of max) over {over}")
            if past or key in ("nf_e[0]", "nf_h[0]"):
                top = float(np.abs(surf["jax_single"][key]).max())
                print(f"{key} max {top:.3e}: " + " | ".join(line))


if __name__ == "__main__":
    main([int(a) for a in sys.argv[1:]] or [20])
