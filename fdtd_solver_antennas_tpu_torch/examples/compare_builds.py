"""Compare two checkouts of the port on one card: the canonical
``chunk_steps`` launch's device time, K2's CPML route, the launch-bound
walk's host time, the 8-variant sweep's ``chunk_steps_batch`` launch, and
the persistent steppers' SASS.

Each ROOT is a checkout of the repository (for example a commit unpacked
with ``git archive``). Timing runs each root in a process of its own, in
the order given, so two commits alternate in one call:

    python fdtd_solver_antennas_tpu_torch/examples/compare_builds.py A B B A

prints one JSON line per root: µs per launch of one chunk of 5 × 89 steps
at the canonical patch (MUR, PEC, PML_8; from parity 1 on a seeded random
state, CUDA events behind a sleep kernel, three timings of ten launches)
and the card's name and power limit.

    python fdtd_solver_antennas_tpu_torch/examples/compare_builds.py --stream A B B A

prints one JSON line per root: µs per launch of K2's CPML route at T = 4
(whatever kernel the root launches for it) on the mixed patch+horn scene
under PML_8 (``stream_steps``), microstrip_3d at mesh quality 5 under
PML_8 (105×90×73, ``stream_steps``), the tall grid's one-rank PML_8 slab
(``stream_shard_steps``) and the 8-variant sweep under PML_8
(``stream_steps_batch``), each from a seeded random state whose ψ are 0
where the profile is flat (as a run leaves them), three timings of ten
launches behind a sleep kernel; the card's name and power limit. The
scenes and the timer are this directory's ``scenes.py``, run against the
root's package, so both roots are timed on the same scenes.

    python fdtd_solver_antennas_tpu_torch/examples/compare_builds.py --walk A B B A

prints one JSON line per root: the canonical patch run to its stop through
the explicit path's per-step walk (``build_explicit_run(sim,
use_kernel=False)``, one rank, no process group: a few launches a step,
each a few µs of device work, so the run is bound by the host's cost per
launch), a warm-up run and then eight timed runs, the card synchronized
around each (host clock, unrounded), with the steps, the best µs a step,
the launches of one run and the card's name and power limit; then the
mixed patch+horn scene (141×201×152) through the same walk to its stop,
two timed runs after its preparation, with its steps, µs a step and
launches. A root that launches through ``fdtd_cuda.launch`` alternates
its canonical runs with it and with an unchecked launch, and times one
call of it beside the stream query a launch made before.

    python fdtd_solver_antennas_tpu_torch/examples/compare_builds.py --sweep A B B A

prints one JSON line per root: µs per ``chunk_steps_batch`` launch of the
8-variant sweep (``bench.py``'s eight canonical-patch variants on their
100×109×50 union grid, one chunk of 2 × 244 steps from parity 1 on a
seeded random state, three timings of three launches behind a sleep
kernel) in the form the root's plan picks, and in each form the root
offers by name (``streamed``; ``marched`` where the root has it), with
the plan's form and the card's name and power limit.

    python fdtd_solver_antennas_tpu_torch/examples/compare_builds.py --sass A B

builds the libraries of K1, K3 and K4 (``fdtd_chunk``, ``fdtd_shard``,
``fdtd_steps``) from both roots, disassembles them with ``cuobjdump
-sass`` and prints, per library, the kernels of A whose SASS is identical
in B (addresses and comments dropped), those that differ, and the kernels
only B has. Needs a CUDA card and the CUDA toolkit.
"""

from __future__ import annotations

import importlib.util
import json
import re
import subprocess
import sys
from pathlib import Path

LIBS = ("fdtd_chunk", "fdtd_shard", "fdtd_steps")
BOUNDARIES = ("MUR", "PEC", "PML_8")


def _scenes():
    """``scenes.py`` from beside this file; its imports of the package
    resolve to the copy this process imported (the root's)."""
    spec = importlib.util.spec_from_file_location(
        "compare_scenes", Path(__file__).with_name("scenes.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


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
    sc = _scenes()

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
        out[boundary] = [round(sc.device_ms(lambda: fdtd_cuda.chunk_steps(
            ops, st, wf, 7, n_sub, D, bufs), reps=10, warmup=2) * 1e3, 1)
            for _ in range(3)]
    return {"root": root, "us_per_launch": out, "card": sc.card_line()}


def _time_stream(root: str) -> dict:
    """Device µs per launch of K2's CPML route in the package under
    ``root`` (this process imports it from there)."""
    sys.path.insert(0, root)
    import numpy as np
    import torch

    from fdtd_solver_antennas_tpu_torch.ops import fdtd_cuda, fdtd_stream
    from fdtd_solver_antennas_tpu_torch.solvers.microstrip_3d import (
        prepare_microstrip_patch_3d)
    from fdtd_solver_antennas_tpu_torch.solvers.sweep import prepare_patch_geometry_sweep

    if not fdtd_stream.__file__.startswith(str(Path(root).resolve())):
        raise RuntimeError(f"imported {fdtd_stream.__file__}, not from {root}")
    sc = _scenes()

    def fill(ops, st, seed):
        """Normal draws; each ψ 0 where its axis's profile is flat."""
        rng = np.random.default_rng(seed)
        for t in (*st.e[0], *st.e[1], *st.h, *st.psi_e, *st.psi_h):
            t.copy_(torch.from_numpy(rng.standard_normal(t.shape).astype(np.float32)))
        for side, group in (("e", st.psi_e), ("h", st.psi_h)):
            for t, ax in zip(group, (1, 2, 2, 0, 0, 1)):
                b, c = ops.pml["b" + side][ax], ops.pml["c" + side][ax]
                shape = [1, 1, 1]
                shape[ax] = -1
                t.mul_(((b != 1) | (c != 0)).view(shape))
        return st

    wf = [0.37, -0.21, 0.55, 0.13]
    out = {}
    scene = sc.mixed_designer()
    scene.controls.boundary = "PML_8"
    sim = scene.prepare().sim
    assert sim.stream_T == 4, sim.pallas_mode_reason
    st = fill(sim.operands, fdtd_cuda.new_state(sim.padded_shape, sim.device, True), 13)
    out["mixed_pml8"] = [round(sc.device_ms(lambda: fdtd_stream.stream_steps(
        sim.operands, st, wf), reps=10) * 1e3, 1) for _ in range(3)]
    del sim, st, scene
    sim = prepare_microstrip_patch_3d(sc.canonical_params(), device="cuda",
                                      mesh_quality=5, boundary="PML_8").sim
    assert sim.stream_T == 4, sim.pallas_mode_reason
    st = fill(sim.operands, fdtd_cuda.new_state(sim.padded_shape, sim.device, True), 17)
    out["microstrip_q5_pml8"] = [round(sc.device_ms(lambda: fdtd_stream.stream_steps(
        sim.operands, st, wf), reps=10) * 1e3, 1) for _ in range(3)]
    del sim, st
    sh = fdtd_stream.build_stream_shard_stepper(
        sc.shard_sim(sc.tall_scene, "PML_8", 1, 48), 1, 0, t_steps=4)
    st = fill(sh.ops, sh.new_state(), 37)
    out["tall_slab_pml8"] = [round(sc.device_ms(lambda: fdtd_stream.stream_shard_steps(
        sh.ops, st, wf), reps=10) * 1e3, 1) for _ in range(3)]
    del sh, st
    prep = prepare_patch_geometry_sweep(sc.sweep_variants(), n_steps_max=1,
                                        boundary="PML_8", pallas_mode="stream",
                                        device="cuda")
    ops, B = sc.sweep_operands(prep), len(sc.sweep_variants())
    assert prep.sim.stream_T == 4
    st = fill(prep.sim.operands, fdtd_cuda.new_batch_state(
        prep.sim.padded_shape, prep.sim.device, True, B), 157)
    st.parity = [1] * B
    out["sweep_pml8"] = [round(sc.device_ms(lambda: fdtd_stream.stream_steps_batch(
        ops, st, wf, [True] * B), reps=10) * 1e3, 1) for _ in range(3)]
    return {"root": root, "cpml_us_per_launch": out, "card": sc.card_line()}


def _time_sweep(root: str) -> dict:
    """Device µs per ``chunk_steps_batch`` launch of the 8-variant sweep in
    the package under ``root`` (this process imports it from there)."""
    sys.path.insert(0, root)
    import numpy as np
    import torch

    from fdtd_solver_antennas_tpu_torch.ops import fdtd_cuda, persist
    from fdtd_solver_antennas_tpu_torch.ops.fdtd import chunk_geometry
    from fdtd_solver_antennas_tpu_torch.solvers.sweep import prepare_patch_geometry_sweep

    if not fdtd_cuda.__file__.startswith(str(Path(root).resolve())):
        raise RuntimeError(f"imported {fdtd_cuda.__file__}, not from {root}")
    sc = _scenes()
    variants = sc.sweep_variants()
    B = len(variants)
    prep = prepare_patch_geometry_sweep(variants, n_steps_max=2000,
                                        end_criteria=1e-4, device="cuda")
    sim, ops = prep.sim, sc.sweep_operands(prep)
    D, n_sub, _, _ = chunk_geometry(sim)
    rng = np.random.default_rng(113)
    st = fdtd_cuda.new_batch_state(sim.padded_shape, sim.device, False, B)
    for t in (*st.e[0], *st.e[1], *st.h):
        t.copy_(torch.from_numpy(rng.standard_normal(t.shape).astype(np.float32)))
    st.parity = [1] * B
    wf = torch.from_numpy(rng.uniform(-1.0, 1.0, 7 + n_sub * D).astype(
        np.float32)).to(sim.device)
    bufs = torch.zeros((B, n_sub, ops.probes.n_rows), device=sim.device)
    picked = fdtd_cuda.chunk_launch_plan(ops, st).form
    out = {}
    for form in (None, "streamed", "marched"):
        if form is not None and form not in persist.FORMS:
            continue
        out[form or f"plan ({picked})"] = [
            round(sc.device_ms(lambda: fdtd_cuda.chunk_steps_batch(
                ops, st, wf, 7, n_sub, D, bufs, [True] * B, form=form),
                reps=3, warmup=1) * 1e3, 1) for _ in range(3)]
    return {"root": root, "batch": B, "steps_a_launch": n_sub * D,
            "us_per_launch": out, "card": sc.card_line()}


def _time_walk(root: str) -> dict:
    """Host seconds of the canonical patch's run through the walk in the
    package under ``root`` (this process imports it from there). Where
    the package launches through ``fdtd_cuda.launch`` (each launch on its
    tensors' device), the runs alternate with it and with a launch that
    takes the raw stream and no device check (on, off, off, on, ...), and
    the host cost of one call is timed over 100,000 calls: ``launch`` of a
    function that does nothing, the raw stream alone, and the stream query
    every launch made before (``torch.cuda.current_stream(dev)``)."""
    sys.path.insert(0, root)
    import time

    import torch

    from fdtd_solver_antennas_tpu_torch.ops import fdtd_cuda
    from fdtd_solver_antennas_tpu_torch.parallel import build_explicit_run
    from fdtd_solver_antennas_tpu_torch.solvers.patch_fixed import prepare_patch_fixed

    if not fdtd_cuda.__file__.startswith(str(Path(root).resolve())):
        raise RuntimeError(f"imported {fdtd_cuda.__file__}, not from {root}")
    sc = _scenes()
    prep = prepare_patch_fixed(sc.canonical_params(), device="cuda")
    assert prep.ok, prep.message
    run = build_explicit_run(prep.sim, use_kernel=False)
    run()  # warm-up: builds the library, plans, first launches
    guarded = getattr(fdtd_cuda, "launch", None)

    def unchecked(dev, fn, *args):
        return fn(*args, fdtd_cuda._stream(dev))

    walls = {"guard": [], "no_guard": []}
    for i in range(8):
        on = guarded is None or i % 4 in (0, 3)
        if guarded is not None:
            fdtd_cuda.launch = guarded if on else unchecked
        fdtd_cuda.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        walls["guard" if on else "no_guard"].append(time.perf_counter() - t0)
    if guarded is not None:
        fdtd_cuda.launch = guarded
    steps = int(out["steps"])
    res = {"root": root, "steps": steps,
           "launches": {k: v for k, v in fdtd_cuda.launches.items() if v},
           "card": sc.card_line()}
    dev, n = prep.sim.device, 100_000

    def per_call(fn):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        return (time.perf_counter() - t0) / n * 1e9

    res["ns_per_call"] = {
        "current_stream": per_call(
            lambda: torch.cuda.current_stream(dev).cuda_stream),
        "empty": per_call(lambda: None)}
    if guarded is not None:
        res["ns_per_call"].update(
            launch=per_call(lambda: guarded(dev, lambda s: s)),
            raw_stream=per_call(lambda: fdtd_cuda._stream(dev)))
    res["walk_walls_s"] = walls if guarded is not None else walls["guard"]
    res["best_us_per_step"] = {k: min(v) / steps * 1e6
                               for k, v in walls.items() if v}
    mixed = sc.mixed_designer().prepare()
    assert mixed.ok, mixed.message
    run = build_explicit_run(mixed.sim, use_kernel=False)
    mixed_walls = []
    for _ in range(2):
        fdtd_cuda.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        mixed_walls.append(time.perf_counter() - t0)
    steps = int(out["steps"])
    res["mixed"] = {"steps": steps, "walls_s": mixed_walls,
                    "us_per_step": [t / steps * 1e6 for t in mixed_walls],
                    "launches": {k: v for k, v in fdtd_cuda.launches.items()
                                 if v}}
    return res


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
    if len(argv) >= 2 and argv[0] in ("--one", "--build", "--one-stream",
                                      "--one-walk", "--one-sweep"):
        fn = {"--one": _time_root, "--build": _build_root,
              "--one-stream": _time_stream, "--one-walk": _time_walk,
              "--one-sweep": _time_sweep}[argv[0]]
        print(json.dumps(fn(str(Path(argv[1]).resolve()))))
        return 0
    if argv and argv[0] in ("--stream", "--walk", "--sweep"):
        for root in argv[1:]:
            print(json.dumps(_in_process(f"--one-{argv[0][2:]}", root)),
                  flush=True)
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
