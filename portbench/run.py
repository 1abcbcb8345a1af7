"""The port's benchmark: one cell of ``BENCHMARK.json``, run once.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds the port
(``fdtd_solver_antennas_tpu_torch``). The cell names a configuration
(``portbench/configs/<config>.json``) and a traffic mix
(``portbench/traffic/<mix>.json``), whose ``job`` names a job kind
(``portbench/jobs/<kind>.py``); each metric is ``portbench/metrics/
<name>.py`` and each cell's limits ``portbench/limits/<cell>.json``. A new
cell, configuration, mix or metric is new files and new entries.

A run: set-up (libraries, the CUDA context, one warm job of the cell's
shapes), then a closed loop of whole jobs, one client, from the window's
open until the job in flight at ``--seconds`` ends; then the check of a
sample of the window's jobs, drawn from the seed, against the plain
reference (``portbench/reference``, ``portbench/check.py``). The last
line of standard output is one JSON object; the numbers compared, each
with its limit, end standard error and the line. With ``--trace 1`` the
window runs under ``torch.profiler`` and the line carries the per-layer
metrics; with ``--trace 0`` the end-to-end ones.
"""

import time

_T0 = time.perf_counter()  # the process's start, before torch is imported

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from contextlib import contextmanager, nullcontext  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "fdtd_solver_antennas_tpu")
EXIT_NO_CARD = 2
EXIT_FORBIDDEN = 3
CHECK_JOBS = 1  # jobs of a run worked out again by the reference
STRATA = 7  # jobs a cycle of draws, one in each stratum of the range


def cache_env(root: Path) -> None:
    """Keep every build and kernel cache inside the checkout, at fixed
    paths (the port builds its own libraries into its ``_build/``)."""
    cache = root / ".portbench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load_part(root: Path, folder: str, name: str):
    """``portbench/<folder>/<name>.py`` under ``root``, loaded by its path as
    a module of the package ``portbench.<folder>`` (so a file that a new
    cell adds is found by name alone)."""
    path = root / "portbench" / folder / f"{name}.py"
    mod_name = (f"portbench.{folder}._"
                + name.replace(".", "_").replace("-", "_"))
    importlib.import_module(f"portbench.{folder}")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def load_metric(root: Path, name: str):
    mod = load_part(root, "metrics", name)
    if getattr(mod, "NAME", None) != name:
        raise ValueError(f"metrics/{name}.py declares NAME "
                         f"{getattr(mod, 'NAME', None)!r}")
    return mod


class Cell:
    """A workload of ``BENCHMARK.json`` and every file it names."""

    def __init__(self, bench: dict, workload: str, root: Path = ROOT):
        cells = {w["name"]: w for w in bench["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
        self.entry = cells[workload]
        self.name = workload
        configs = {c["name"]: c for c in bench["configs"]}
        self.config = load_json(root / configs[self.entry["config"]]["file"])
        here = root / "portbench"
        self.traffic = load_json(here / "traffic" /
                                 f"{self.entry['traffic']}.json")
        self.limits = load_json(here / "limits" / f"{workload}.json")
        self.kind_module = load_part(root, "jobs", self.traffic["job"])

        def mine(m):
            return "workloads" not in m or workload in m["workloads"]

        self.end_to_end = [m for m in bench["end_to_end"] if mine(m)]
        self.per_layer = [m for m in bench["per_layer"] if mine(m)]


class Window:
    """What the window did: the record the metrics read.

    - ``jobs``: the window's job records (``jobs.JobRecord``), with their
      host-clock stamps, work and answers;
    - ``window_s``, ``setup_s``: the window's wall and the set-up before it;
    - ``kind``: the cell's job kind (``cells``, ``n_stamps``, ``config``,
      ``traffic``), and ``cpml``;
    - ``counters``: the port's launch counters over the window, one dict
      each, keyed ``<module>.<counter>`` (``fdtd_cuda.launches``,
      ``fdtd_cuda.launches_by_form``, ``fdtd_stream.launches_by_kernel``,
      …), and ``launches``, the kernels' launches summed;
    - ``peak``: the device's peak memory over the window, in bytes;
    - ``trace``: with ``--trace 1``, ``trace.reduce``'s whole reduction
      (busy time, device time and count by name, the spans by name, every
      idle gap); else None.
    """

    def __init__(self, jobs, window_s, setup_s, kind, cpml, counters=None,
                 peak=0, trace=None):
        self.jobs = jobs
        self.window_s = window_s
        self.setup_s = setup_s
        self.kind = kind
        self.cpml = cpml
        self.counters = counters or {}
        self.launches = sum(sum(d.values()) for k, d in self.counters.items()
                            if k.endswith(".launches"))
        self.peak = peak
        self.trace = trace

    @property
    def busy_s(self):
        return None if self.trace is None else self.trace["busy_s"]


def launch_counters():
    """The port's kernel-launch counters, one dict each."""
    from fdtd_solver_antennas_tpu_torch.ops import (fdtd_cuda, fdtd_shard,
                                                    fdtd_steps, fdtd_stream)

    return (fdtd_cuda, fdtd_stream, fdtd_shard, fdtd_steps)


def counters_now() -> dict:
    """Every launch counter of the port, ``<module>.<counter>`` → its dict."""
    out = {}
    for m in launch_counters():
        short = m.__name__.rsplit(".", 1)[-1]
        for attr in dir(m):
            val = getattr(m, attr)
            if attr.startswith("launches") and isinstance(val, dict):
                out[f"{short}.{attr}"] = dict(val)
    return out


def reset_launches() -> None:
    for m in launch_counters():
        m.reset_launch_counts()


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card_power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def fmt(v):
    """A number for the JSON line: finite as is, else its string."""
    return v if isinstance(v, (int, float)) and math.isfinite(v) else str(v)


def job_draws(seed: int, lo: float, hi: float):
    """Each job's loss tangent, endless: cycles of ``STRATA`` jobs, each
    job of a cycle in its own stratum of ``[lo, hi)``, the strata in an
    order and at points within them drawn from the seed. A sweep's variants
    freeze at steps that follow the loss, so uniform draws made the seed
    change a window's work; this way every seed gives the same spread of
    work in another order, and every job its own answer."""
    import numpy as np

    rng = np.random.default_rng([seed, 0])
    while True:
        for s in rng.permutation(STRATA):
            yield float(lo + (hi - lo) * (s + rng.uniform()) / STRATA)


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, *, device="cuda", chips_check=True, root: Path = ROOT,
         break_program=None) -> int:
    """One run of one cell. ``device``, ``chips_check`` and
    ``break_program`` (a callable run after set-up that breaks the timed
    path, or None) serve the benchmark's own tests; a run from the command
    line takes the defaults."""
    args = parse(argv)
    cache_env(root)
    import numpy as np
    import torch

    bench = load_json(root / "BENCHMARK.json")
    cell = Cell(bench, args.workload, root)
    chips = int(cell.entry["chips"])
    if chips_check and (not torch.cuda.is_available()
                        or torch.cuda.device_count() < chips):
        print(f"no card: the cell needs {chips} CUDA device(s), "
              f"torch.cuda.is_available()={torch.cuda.is_available()}",
              file=sys.stderr)
        return EXIT_NO_CARD
    kind = cell.kind_module.Kind(cell.config, cell.traffic, device)
    lo, hi = cell.traffic["loss_tangent"]
    draws = job_draws(args.seed, lo, hi)
    warm_draw = float(np.random.default_rng([args.seed, 1]).uniform(lo, hi))
    cpml = cell.traffic["boundary"].upper().startswith("PML")

    on_card = device == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    prof = None

    @contextmanager
    def spans(name):
        if prof is None:
            yield
        else:
            with torch.profiler.record_function("portbench." + name):
                yield

    warm = kind.run(warm_draw, spans)  # every shape of the cell, built
    if warm.failed:
        print(f"warm job failed: {warm.failed}", file=sys.stderr)
        return 1
    if break_program is not None:
        break_program()
    del warm
    if args.trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if on_card:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    reset_launches()
    sync()

    jobs = []
    t_open = time.perf_counter()
    setup_s = t_open - _T0
    win = (torch.profiler.record_function("portbench.window") if prof
           else nullcontext())
    with win:
        while True:
            jobs.append(kind.run(next(draws), spans))
            if time.perf_counter() - t_open >= args.seconds:
                break
        sync()
    t_close = time.perf_counter()
    counters = counters_now()
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    red = breakdown = None
    if prof is not None:
        from . import trace

        prof.stop()
        tdir = Path(os.environ.get("TMPDIR", "/tmp")) / "portbench_trace"
        tdir.mkdir(parents=True, exist_ok=True)
        tpath = tdir / f"{args.workload}.json"
        prof.export_chrome_trace(str(tpath))
        prof = None
        red = trace.reduce(str(tpath))
        tpath.unlink()
        breakdown = {"device_ops": red["device_ops"],
                     "idle_gaps": red["idle_gaps"]}
        print(f"trace: {red['n_device']} device events, busy "
              f"{red['busy_s']!r} s of {red['window_s']!r} s",
              file=sys.stderr)

    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {', '.join(bad)}", file=sys.stderr)
        return EXIT_FORBIDDEN

    w = Window(jobs, t_close - t_open, setup_s, kind, cpml, counters, peak,
               red)
    metrics = {}
    for m in (cell.per_layer if args.trace else cell.end_to_end):
        v = load_metric(root, m["name"]).read(w)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    failed = [j for j in jobs if j.failed]
    for j in failed:
        print(f"job failed: {j.failed}", file=sys.stderr)
    print("jobs (prepare, run, post s): " + ", ".join(
        f"({j.prepare_s:.3f}, {j.run_s:.3f}, {j.post_s:.3f})" for j in jobs),
        file=sys.stderr)

    # the check, once the window's state is gone
    from . import check

    if on_card:
        torch.cuda.empty_cache()
    done = [i for i, j in enumerate(jobs) if not j.failed]
    pick = np.random.default_rng([args.seed, 2])
    n_check = min(CHECK_JOBS, len(done))
    sample = sorted(pick.choice(done, size=n_check, replace=False)) if done else []
    numbers = {}
    t_ref = time.perf_counter()
    for i in sample:
        try:
            ref = kind.reference(jobs[i], device, torch.float32)
            got = check.compare(jobs[i].answer, ref)
        except Exception as e:  # a job whose answer cannot be compared
            print(f"check of job {i} raised {type(e).__name__}: {e}",
                  file=sys.stderr)
            got = {k: math.inf for k in cell.limits}
        for k, v in got.items():
            numbers[k] = max(numbers.get(k, 0.0), v)
    ok, rows = check.verdict(numbers, cell.limits)
    correct = bool(ok and not failed and sample)
    print(f"check: {len(sample)} of {len(jobs)} jobs against the reference "
          f"in {time.perf_counter() - t_ref:.1f} s", file=sys.stderr)
    if on_card:
        print(f"card: {card_power_limit()}; peak {peak} B", file=sys.stderr)
    for name, v, lim in rows:
        print(f"{name} {v!r} limit {lim!r}", file=sys.stderr)

    device_info = {
        "platform": "gpu" if on_card else "cpu",
        "kind": torch.cuda.get_device_name() if on_card else "cpu",
        "count": chips,
        "memory_peak_bytes": int(peak),
    }
    if args.trace:
        device_info["busy_s"] = w.busy_s
        device_info["window_s"] = t_close - t_open
    line = {
        "correct": correct,
        "attempted": len(jobs),
        "failed": len(failed),
        "metrics": metrics,
        "device": device_info,
    }
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = {name: {"value": fmt(v), "limit": fmt(lim)}
                      for name, v, lim in rows}
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
