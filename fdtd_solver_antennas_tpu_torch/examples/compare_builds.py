"""Compare two checkouts of the port on one card: the canonical
``chunk_steps`` launch's device time, and the persistent steppers' SASS.

Each ROOT is a checkout of the repository (for example a commit unpacked
with ``git archive``). Timing runs each root in a process of its own, in
the order given, so two commits alternate in one call:

    python fdtd_solver_antennas_tpu_torch/examples/compare_builds.py A B B A

prints one JSON line per root: µs per launch of one chunk of 5 × 89 steps
at the canonical patch (MUR, PEC, PML_8; from parity 1 on a seeded random
state, CUDA events behind a sleep kernel, three timings of ten launches)
and the card's name and power limit.

    python fdtd_solver_antennas_tpu_torch/examples/compare_builds.py --sass A B

builds the libraries of K1, K3 and K4 (``fdtd_chunk``, ``fdtd_shard``,
``fdtd_steps``) from both roots, disassembles them with ``cuobjdump
-sass`` and prints, per library, the kernels of A whose SASS is identical
in B (addresses and comments dropped), those that differ, and the kernels
only B has. Needs a CUDA card and the CUDA toolkit.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
from pathlib import Path

LIBS = ("fdtd_chunk", "fdtd_shard", "fdtd_steps")
BOUNDARIES = ("MUR", "PEC", "PML_8")


def _time_root(root: str) -> dict:
    """Device µs per canonical ``chunk_steps`` launch of the package
    under ``root`` (this process imports it from there)."""
    sys.path.insert(0, root)
    import numpy as np
    import torch

    from fdtd_solver_antennas_tpu_torch.models.params import PatchAntennaParams
    from fdtd_solver_antennas_tpu_torch.ops import fdtd_cuda
    from fdtd_solver_antennas_tpu_torch.ops.fdtd import FDTDConfig, build_simulation
    from fdtd_solver_antennas_tpu_torch.solvers.patch_fixed import build_patch_scene

    if not fdtd_cuda.__file__.startswith(str(Path(root).resolve())):
        raise RuntimeError(f"imported {fdtd_cuda.__file__}, not from {root}")

    def device_ms(fn, reps=10, warmup=2):
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(100_000_000)  # holds the stream while launches queue
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / reps

    scene, grid, f0, fc = build_patch_scene(PatchAntennaParams.from_user_units(
        frequency_ghz=2.45, er=4.3, h_mm=1.6, loss_tangent=0.02))
    n_sub, decim = 5, 89
    out = {}
    for boundary in BOUNDARIES:
        cfg = FDTDConfig(n_steps_max=n_sub * decim, check_every=n_sub * decim,
                         end_criteria=1e-30, boundary=boundary,
                         probe_decimation=decim, pallas_mode="chunk")
        sim = build_simulation(scene, grid, f0=f0, fc=fc, cfg=cfg, device="cuda",
                               port_freqs_hz=np.linspace(2e9, 3e9, 51),
                               nf_freqs_hz=np.array([2.45e9]))
        ops, D = sim.operands, sim.probe_decim
        rng = np.random.default_rng(83)
        st = fdtd_cuda.new_state(sim.padded_shape, sim.device, ops.pml is not None)
        for t in (*st.e[0], *st.e[1], *st.h, *st.psi_e, *st.psi_h):
            t.copy_(torch.from_numpy(rng.standard_normal(t.shape).astype(np.float32)))
        st.parity = 1
        wf = torch.from_numpy(np.random.default_rng(89).uniform(
            -1.0, 1.0, 7 + n_sub * D).astype(np.float32)).to(sim.device)
        bufs = torch.zeros((n_sub, ops.probes.n_rows), device=sim.device)
        out[boundary] = [round(device_ms(lambda: fdtd_cuda.chunk_steps(
            ops, st, wf, 7, n_sub, D, bufs)) * 1e3, 1) for _ in range(3)]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    return {"root": root, "us_per_launch": out, "card": card.splitlines()[0]}


def _build_root(root: str) -> dict:
    """Paths of the libraries built from ``root``'s sources, and of nvcc."""
    sys.path.insert(0, root)
    from fdtd_solver_antennas_tpu_torch.ops import _build

    return {"nvcc": _build.find_nvcc(),
            **{lib: str(_build.build(lib)[0]) for lib in LIBS}}


def _sass(path: str, nvcc: str) -> dict:
    """Kernel name → its instructions, addresses and comments dropped."""
    cuobjdump = Path(nvcc).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", path], capture_output=True,
                          text=True, check=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = []
        elif name is not None:
            ins = " ".join(re.sub(r"/\*.*?\*/", "", line).split())
            if ins:
                out[name].append(ins)
    return out


def _in_process(flag: str, root: str) -> dict:
    proc = subprocess.run([sys.executable, __file__, flag, root],
                          capture_output=True, text=True, check=True)
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main(argv) -> int:
    if len(argv) >= 2 and argv[0] in ("--one", "--build"):
        fn = _time_root if argv[0] == "--one" else _build_root
        print(json.dumps(fn(str(Path(argv[1]).resolve()))))
        return 0
    if argv and argv[0] == "--sass":
        if len(argv) != 3:
            raise SystemExit("--sass takes two roots")
        a, b = (_in_process("--build", r) for r in argv[1:])
        for lib in LIBS:
            sa, sb = _sass(a[lib], a["nvcc"]), _sass(b[lib], b["nvcc"])
            print(json.dumps({
                "library": lib,
                "identical": sorted(n for n in sa if sa[n] == sb.get(n)),
                "differ": sorted(n for n in sa if n in sb and sa[n] != sb[n]),
                "only_in_b": sorted(set(sb) - set(sa))}))
        return 0
    if not argv:
        raise SystemExit(__doc__)
    for root in argv:
        print(json.dumps(_in_process("--one", root)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
