"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and the script
exits non-zero without printing a result:

1. environment: torch/CUDA versions, the card, its power limit;
2. build: compile ``csrc/fdtd_chunk.cu`` with nvcc for sm_90a;
3. kernel vs plain: one 500-step chunk of the small test scene and of the
   canonical patch under MUR, PEC and CPML, through the CUDA kernels and
   through their plain PyTorch twins on the same card; then each kernel
   alone against its twin at the canonical shape, with its time;
4. main path: ``prepare_patch_fixed`` + ``run_prepared_fixed`` on the
   canonical 2.45 GHz FR-4 patch, with the kernel launch counts;
5. golden physics: the openEMS Simple_Patch_Antenna tutorial scene;
6. times: kernel and plain at the canonical and the 161×121×160 grids.

The next-to-last line is the kernel table as JSON, the last line
``{"ok": true, "device": {...}}``. Needs no network and one card. It
exits non-zero when CUDA is unavailable.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

RTOL = 2e-4  # the JAX package's own kernel-vs-XLA tolerance
ATOL_REL = 1e-5  # atol = 1e-5 · max|plain|
SOURCE = "fdtd_solver_antennas_tpu_torch/csrc/fdtd_chunk.cu"
REPLACES = "fdtd_solver_antennas_tpu/ops/fdtd_pallas.py:1376"


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def card_line() -> str:
    """Name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def close(name, got, ref) -> float:
    """Assert got ≈ ref at RTOL / ATOL_REL·max|ref|; return max |got−ref|."""
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = ref.detach().cpu().numpy() if torch.is_tensor(ref) else np.asarray(ref)
    atol = ATOL_REL * max(float(np.abs(ref).max()), 1e-20)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=atol, err_msg=name)
    return float(np.abs(got - ref).max()) if got.size else 0.0


def small_scene():
    """The small scene of the JAX package's kernel tests."""
    from fdtd_solver_antennas_tpu_torch.models.scene import Scene
    from fdtd_solver_antennas_tpu_torch.ops.mesh import MeshBuilder

    mb = MeshBuilder()
    mb.add_line("x", [-40, 40, 0.0, -6.0])
    mb.add_line("y", [-40, 40, 0.0])
    mb.add_line("z", [-20, 30])
    mb.add_line("z", np.linspace(0, 1.6, 3))
    grid = mb.build(5.0)
    scene = Scene()
    scene.add_material_box("sub", 4.3, 0.005, [-20, -20, 0], [20, 20, 1.6], 0)
    scene.add_metal_box("patch", [-15, -12, 1.6], [15, 12, 1.6], priority=10)
    scene.add_metal_box("gnd", [-20, -20, 0], [20, 20, 0], priority=10)
    scene.add_lumped_port(1, 50.0, [-6, 0, 0], [-6, 0, 1.6], direction="z")
    return scene, grid, 2.45e9, 1.225e9


def canonical_params():
    from fdtd_solver_antennas_tpu_torch.models.params import PatchAntennaParams

    return PatchAntennaParams.from_user_units(
        frequency_ghz=2.45, er=4.3, h_mm=1.6, loss_tangent=0.02)


def canonical_scene():
    from fdtd_solver_antennas_tpu_torch.solvers.patch_fixed import build_patch_scene

    return build_patch_scene(canonical_params())


def tall_scene():
    """The tall patch: 161×121×160 lines, 3.05M cells."""
    from fdtd_solver_antennas_tpu_torch.models.scene import Scene
    from fdtd_solver_antennas_tpu_torch.ops.mesh import MeshBuilder

    mb = MeshBuilder()
    mb.add_line("x", list(np.linspace(-60, 60, 161)) + [-6.0])
    mb.add_line("y", np.linspace(-45, 45, 121))
    mb.add_line("z", np.linspace(-40, 56, 160))
    grid = mb.build(4.0)
    scene = Scene()
    scene.add_material_box("sub", 4.3, 0.005, [-20, -20, 0], [20, 20, 1.6], 0)
    scene.add_metal_box("patch", [-15, -12, 1.6], [15, 12, 1.6], priority=10)
    scene.add_metal_box("gnd", [-20, -20, 0], [20, 20, 0], priority=10)
    scene.add_lumped_port(1, 50.0, [-6, 0, 0], [-6, 0, 1.6], direction="z")
    return scene, grid, 2.45e9, 1.225e9


def one_chunk_sim(make_scene, boundary, n_steps=500):
    """Exactly one chunk: ``n_steps`` steps, a probe sample every 50."""
    from fdtd_solver_antennas_tpu_torch.ops.fdtd import FDTDConfig, build_simulation

    scene, grid, f0, fc = make_scene()
    cfg = FDTDConfig(n_steps_max=n_steps, check_every=n_steps,
                     end_criteria=1e-30, boundary=boundary,
                     probe_decimation=50)
    return build_simulation(
        scene, grid, f0=f0, fc=fc, cfg=cfg, device="cuda",
        port_freqs_hz=np.linspace(2e9, 3e9, 51),
        nf_freqs_hz=np.array([2.45e9]))


def timed_run(sim, impl):
    from fdtd_solver_antennas_tpu_torch.ops.fdtd import run_simulation

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run_simulation(sim, impl)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def host_ms(fn, reps=50, warmup=5) -> float:
    """Wall milliseconds per call, host clock, ending in a synchronize:
    what a caller waits for, launch overhead included."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def device_ms(fn, reps=20, warmup=5) -> float:
    """Device milliseconds per call: a sleep kernel holds the stream while
    the calls are queued behind it, so the CUDA events bracket device work
    only, not the host's launch overhead (reps stays small enough that the
    queue never fills)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)  # ~50 ms at the H100's clocks
    t0 = time.perf_counter()
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    queued = time.perf_counter() - t0
    b.synchronize()
    if queued > 0.04:
        raise RuntimeError(f"queueing took {queued * 1e3:.1f} ms, past the "
                           "sleep: the device time would include host time")
    return a.elapsed_time(b) / reps


def phase_kernel_vs_plain():
    from fdtd_solver_antennas_tpu_torch.ops import fdtd_cuda

    worst = 0.0
    for label, make, boundaries in (
        ("small", small_scene, ("MUR", "PEC", "PML_4")),
        ("canonical", canonical_scene, ("MUR", "PEC", "PML_8")),
    ):
        for boundary in boundaries:
            sim = one_chunk_sim(make, boundary)
            ko, tk = timed_run(sim, fdtd_cuda.kernels)
            po, tp = timed_run(sim, fdtd_cuda.plain)
            assert ko["steps"] == po["steps"], (ko["steps"], po["steps"])
            err = 0.0
            for i, (a, b) in enumerate(zip(ko["fields"], po["fields"])):
                err = max(err, close(f"field {i}", a, b))
            for key in ("uf", "if_"):
                err = max(err, close(key, ko[key], po[key]))
            for key in ("nf_e", "nf_h"):
                for a, b in zip(ko[key], po[key]):
                    err = max(err, close(key, a, b))
            for grp in ("psi_e", "psi_h"):
                for k, v in po["state"][grp].items():
                    err = max(err, close(f"{grp} {k}", ko["state"][grp][k], v))
            worst = max(worst, err)
            say("3", f"{label} {sim.grid.shape} {boundary}: {ko['steps']} steps "
                     f"kernel == plain (rtol {RTOL}, atol {ATOL_REL}*max|plain|), "
                     f"max |err| {err:.3e}; kernel {tk:.3f} s, plain {tp:.3f} s")
    return worst


def random_state(sim, seed):
    """A state of ``sim``'s shape with fields and ψ from a seeded normal
    draw (numpy), on the card."""
    from fdtd_solver_antennas_tpu_torch.ops import fdtd_cuda

    rng = np.random.default_rng(seed)
    st = fdtd_cuda.new_state(sim.padded_shape, sim.device,
                             sim.operands.pml is not None)
    for t in (*st.e[0], *st.e[1], *st.h, *st.psi_e, *st.psi_h):
        t.copy_(torch.from_numpy(
            rng.standard_normal(t.shape).astype(np.float32)))
    return st


def clone_state(st):
    from fdtd_solver_antennas_tpu_torch.ops import fdtd_cuda

    return fdtd_cuda.YeeState(
        e=[tuple(t.clone() for t in st.e[0]), tuple(t.clone() for t in st.e[1])],
        h=tuple(t.clone() for t in st.h),
        psi_e=tuple(t.clone() for t in st.psi_e),
        psi_h=tuple(t.clone() for t in st.psi_h),
        parity=st.parity,
    )


def phase_each_kernel(sim, phase="3"):
    """Each kernel against its plain twin on the same inputs at ``sim``'s
    shapes; both timed on the device and on the host clock."""
    from fdtd_solver_antennas_tpu_torch.ops import fdtd_cuda as fc

    ops = sim.operands
    rows = ops.probe_idx.shape[0]
    base = random_state(sim, seed=7)
    calls = {
        "h_update": lambda m, st, out: m.h_update(ops, st),
        "e_update": lambda m, st, out: m.e_update(ops, st, 0.37),
        "mur_faces": lambda m, st, out: m.mur_faces(ops, st, 0),
        "probe_gather": lambda m, st, out: m.probe_gather(ops, st, out),
    }
    outputs = {
        "h_update": lambda st, out: st.h,
        "e_update": lambda st, out: st.e[1],
        "mur_faces": lambda st, out: st.e[1],
        "probe_gather": lambda st, out: (out,),
    }
    result = {}
    for name, call in calls.items():
        sk, sp = clone_state(base), clone_state(base)
        out_k, out_p = (torch.zeros(rows, device=sim.device) for _ in range(2))
        if name == "mur_faces":  # all three axes, in the run's order
            for axis in range(3):
                fc.mur_faces(ops, sk, axis)
                fc.plain.mur_faces(ops, sp, axis)
        else:
            call(fc.kernels, sk, out_k)
            call(fc.plain, sp, out_p)
        torch.cuda.synchronize()
        err = max(close(f"{name} {i}", a, b) for i, (a, b) in
                  enumerate(zip(outputs[name](sk, out_k), outputs[name](sp, out_p))))
        t = dict(
            ms=device_ms(lambda: call(fc.kernels, sk, out_k)),
            plain_ms=device_ms(lambda: call(fc.plain, sp, out_p)),
            host_ms=host_ms(lambda: call(fc.kernels, sk, out_k)),
            plain_host_ms=host_ms(lambda: call(fc.plain, sp, out_p)),
        )
        result[name] = dict(max_abs_err=err, **t)
        say(phase, f"{name} at {sim.grid.shape}: kernel == plain, max |err| "
                   f"{err:.3e}; device {t['ms'] * 1e3:.1f} us/launch (plain "
                   f"{t['plain_ms'] * 1e3:.1f} us), host clock "
                   f"{t['host_ms'] * 1e3:.1f} us/call (plain "
                   f"{t['plain_host_ms'] * 1e3:.1f} us)")
    return result


def phase_main_path():
    """The canonical patch through the library entry points the CLI
    calls; every kernel must have been launched by this run."""
    from fdtd_solver_antennas_tpu_torch.ops import fdtd_cuda
    from fdtd_solver_antennas_tpu_torch.solvers.patch_fixed import (
        prepare_patch_fixed, run_prepared_fixed)

    params = canonical_params()
    prep = prepare_patch_fixed(params, device="cuda")
    assert prep.ok, prep.message
    fdtd_cuda.reset_launch_counts()
    res = run_prepared_fixed(prep, frequency_hz=params.frequency_hz, verbose=0)
    counts = dict(fdtd_cuda.launches)
    assert res.ok, res.message
    for name in fdtd_cuda.KERNELS:
        assert counts[name] > 0, f"main path launched no {name}: {counts}"
    s11_db = 20 * np.log10(np.maximum(np.abs(res.s11), 1e-12))
    dmax_dbi = 10 * np.log10(res.Dmax)
    for arr in (res.s11, res.z_in, res.intensity):
        assert np.all(np.isfinite(arr)), "non-finite main-path output"
    assert np.isfinite(res.Dmax) and np.isfinite(res.f_res_hz)
    assert 5.0 < dmax_dbi < 8.0, f"Dmax {dmax_dbi:.2f} dBi outside 5-8"
    assert s11_db.min() < -8.0, f"|S11|min {s11_db.min():.2f} dB not < -8"
    say("4", f"canonical patch {prep.sim.grid.shape} on {prep.sim.device}: "
             f"{res.steps_run} steps in {res.wall_time_s:.3f} s, "
             f"{res.mcells_per_s:.1f} Mcell-updates/s; f_res "
             f"{res.f_res_hz / 1e9:.4f} GHz, |S11|min {s11_db.min():.2f} dB, "
             f"Dmax {dmax_dbi:.3f} dBi; launches {counts}")
    return prep, res, counts


def phase_golden():
    """The openEMS Simple_Patch_Antenna tutorial scene through the
    kernels, held to the JAX package's golden bands."""
    from fdtd_solver_antennas_tpu_torch.models.params import PatchAntennaParams
    from fdtd_solver_antennas_tpu_torch.solvers.patch_fixed import (
        prepare_patch_fixed, run_prepared_fixed)

    tut = PatchAntennaParams.from_user_units(
        frequency_ghz=2.0, er=3.38, h_mm=1.524, loss_tangent=1e-3,
        W_mm=32.0, L_mm=40.0)
    prep = prepare_patch_fixed(tut, device="cuda")
    assert prep.ok, prep.message
    res = run_prepared_fixed(prep, frequency_hz=2.0e9, verbose=0)
    assert res.ok, res.message
    rel = abs(res.f_res_hz - 2.40e9) / 2.40e9
    dip = float((20 * np.log10(np.abs(res.s11) + 1e-30)).min())
    dmax = 10 * np.log10(res.Dmax)
    assert rel < 0.015, f"tutorial f_res {res.f_res_hz / 1e9:.4f} GHz off by {rel:.2%}"
    assert dip <= -18.0, f"tutorial S11 dip {dip:.2f} dB shallower than -18"
    assert 6.2 < dmax < 7.4, f"tutorial Dmax {dmax:.2f} dBi outside 6.2-7.4"
    say("5", f"tutorial scene {prep.sim.grid.shape}: f_res "
             f"{res.f_res_hz / 1e9:.4f} GHz ({rel:.2%} from 2.40), dip "
             f"{dip:.2f} dB, Dmax {dmax:.3f} dBi, {res.steps_run} steps")


def phase_times(prep, res, counts, per_kernel, card):
    """Wall time and Mcell-updates/s, kernel and plain, at the canonical
    size (the whole run) and at the tall grid (one chunk); the device's
    busy share of the canonical run from the per-launch device times."""
    from fdtd_solver_antennas_tpu_torch.ops import fdtd_cuda

    sim = prep.sim
    _, t_plain = timed_run(sim, fdtd_cuda.plain)
    _, t_kern = timed_run(sim, fdtd_cuda.kernels)
    steps = res.steps_run
    cells = sim.grid.num_cells
    say("6", f"canonical {sim.grid.shape}, {steps} steps: kernel "
             f"{t_kern:.3f} s = {cells * steps / t_kern / 1e6:.1f} Mcell-updates/s; "
             f"plain {t_plain:.3f} s = {cells * steps / t_plain / 1e6:.1f} "
             f"Mcell-updates/s [{card}]")
    busy = sum(counts[k] * per_kernel[k]["ms"] for k in counts) / 1e3
    say("6", f"canonical run: kernels busy {busy:.3f} s of {t_kern:.3f} s wall "
             f"(sum of launches x device time per launch), idle share "
             f"{1 - busy / t_kern:.2f} [{card}]")
    t0 = time.perf_counter()
    tall = one_chunk_sim(tall_scene, "MUR")
    prep_tall = time.perf_counter() - t0
    tcells = tall.grid.num_cells
    # kernel, plain, kernel, plain: the first run of a new simulation also
    # pays its allocations and first touches
    for rnd in ("first", "second"):
        ko, tk = timed_run(tall, fdtd_cuda.kernels)
        po, tp = timed_run(tall, fdtd_cuda.plain)
        close("tall uf", ko["uf"], po["uf"])
        tsteps = ko["steps"]
        say("6", f"tall {tall.grid.shape} ({tcells} cells, prepare "
                 f"{prep_tall:.1f} s), {rnd} run of one {tsteps}-step chunk: "
                 f"kernel {tk:.3f} s = {tcells * tsteps / tk / 1e6:.1f} "
                 f"Mcell-updates/s; plain {tp:.3f} s = "
                 f"{tcells * tsteps / tp / 1e6:.1f} Mcell-updates/s [{card}]")
    per = phase_each_kernel(tall, phase="6")
    n_samples = tsteps // tall.probe_decim
    busy = (tsteps * (per["h_update"]["ms"] + per["e_update"]["ms"]
                      + 3 * per["mur_faces"]["ms"])
            + n_samples * per["probe_gather"]["ms"]) / 1e3
    say("6", f"tall second run: kernels busy {busy:.3f} s of {tk:.3f} s wall, "
             f"idle share {1 - busy / tk:.2f} [{card}]")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "test needs an NVIDIA GPU", file=sys.stderr)
        return 2

    # 1. environment
    card = card_line()
    dev_name = torch.cuda.get_device_name(0)
    say("1", f"python {sys.version.split()[0]}, torch {torch.__version__}, "
             f"CUDA {torch.version.cuda}, device {dev_name}, "
             f"count {torch.cuda.device_count()}")
    print(card, flush=True)

    # 2. build
    from fdtd_solver_antennas_tpu_torch.ops import _build, fdtd_cuda

    lib_path, build_s, log = _build.build("fdtd_chunk")
    say("2", f"built {lib_path.name} in {build_s:.1f} s (nvcc "
             f"{' '.join(_build.NVCC_FLAGS[:2])})")
    for ln in log.splitlines():
        if "registers" in ln:
            say("2", f"ptxas: {ln.strip()}")
    fdtd_cuda._library()

    # 3. kernel vs plain on the card
    worst = phase_kernel_vs_plain()
    say("3", f"all chunk comparisons agree; worst max |err| {worst:.3e}")
    per_kernel = phase_each_kernel(one_chunk_sim(canonical_scene, "MUR"))

    # 4.-6.
    prep, res, counts = phase_main_path()
    phase_golden()
    phase_times(prep, res, counts, per_kernel, card)

    table = {"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES,
         "launches": counts[name],
         **{k: per_kernel[name][k] for k in ("max_abs_err", "ms", "plain_ms")}}
        for name in fdtd_cuda.KERNELS
    ]}
    print(card, flush=True)
    print(json.dumps(table), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev_name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
