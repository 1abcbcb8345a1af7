"""Sweeps and the rank worker of the sharded-sweep tests.

The worker runs in processes started by ``torch.multiprocessing.spawn``,
which import this module by name, so it imports nothing of JAX; the test
file builds the JAX package's side from the same scene functions.
"""

import dataclasses

import numpy as np

from _explicit_ranks import init_gloo

# the small scene of tests/test_sharding.py::_build (22×21×21) with its
# patch and substrate loss varied: (half L, half W, substrate kappa)
PATCHES = ((15.0, 12.0, 0.005), (13.0, 10.0, 0.005), (16.0, 13.0, 0.02),
           (11.0, 9.0, 0.01))
PATCH_RUN = dict(n_steps_max=120, end_criteria=1e-30, check_every=60,
                 probe_decimation=10)
SWEEP_KW = dict(f0=2.45e9, fc=1.225e9, port_freqs_hz=np.linspace(2e9, 3e9, 11),
                nf_freqs_hz=np.array([2.45e9]))
# three 12 GHz horn apertures (tests/test_sweep_shard.py) on a coarse mesh,
# one chunk of 5 probe intervals
APERTURES = [(30.0, 24.0, 30.0), (40.0, 30.0, 36.0), (55.0, 42.0, 45.0)]
HORN = dict(frequency_ghz=12.0, throat_a_mm=19.05, throat_b_mm=9.525,
            aperture_A_mm=48.0, aperture_B_mm=36.0, length_mm=40.0)
HORN_RUN = dict(mesh_ppw=6.0, n_steps_max=300, end_criteria=1e-12,
                theta_step_deg=15.0, phi_step_deg=30.0)
HORN_CHECK = 60  # steps a chunk (the prepare's default is 500)


def patch_scene(scene_cls, half_l, half_w, kappa):
    s = scene_cls()
    s.add_material_box("sub", 4.3, kappa, [-20, -20, 0], [20, 20, 1.6], 0)
    s.add_metal_box("patch", [-half_l, -half_w, 1.6], [half_l, half_w, 1.6],
                    priority=10)
    s.add_metal_box("gnd", [-20, -20, 0], [20, 20, 0], priority=10)
    s.add_lumped_port(1, 50.0, [-6, 0, 0], [-6, 0, 1.6], direction="z")
    return s


def patch_grid(mb_cls):
    mb = mb_cls()
    mb.add_line("x", [-40, 40, 0.0, -6.0])
    mb.add_line("y", [-40, 40, 0.0])
    mb.add_line("z", [-20, 30])
    mb.add_line("z", np.linspace(0, 1.6, 3))
    return mb.build(4.0)


def port_patch_sweep(n_var, device="cpu"):
    """The port's ``SweepPrepared`` of the first ``n_var`` patches."""
    import torch

    from fdtd_solver_antennas_tpu_torch.models.params import PatchAntennaParams
    from fdtd_solver_antennas_tpu_torch.models.scene import Scene
    from fdtd_solver_antennas_tpu_torch.ops.fdtd import FDTDConfig, build_simulation
    from fdtd_solver_antennas_tpu_torch.ops.mesh import MeshBuilder
    from fdtd_solver_antennas_tpu_torch.solvers import sweep

    grid = patch_grid(MeshBuilder)
    sims = [build_simulation(patch_scene(Scene, *p), grid,
                             cfg=FDTDConfig(**PATCH_RUN), device=device,
                             **SWEEP_KW)
            for p in PATCHES[:n_var]]
    params = PatchAntennaParams.from_user_units(frequency_ghz=2.45, er=4.3,
                                                h_mm=1.6)
    return sweep.SweepPrepared(
        True, "", sim=sims[0], variants=[params] * n_var,
        batched_coeffs={k: torch.stack([s.coeffs[k] for s in sims])
                        for k in sims[0].coeffs})


def short_chunks(sim):
    """``sim`` with chunks of :data:`HORN_CHECK` steps."""
    sim.cfg = dataclasses.replace(sim.cfg, check_every=HORN_CHECK)
    return sim


def port_horn_sweep(device="cpu"):
    from fdtd_solver_antennas_tpu_torch.models.params import HornAntennaParams
    from fdtd_solver_antennas_tpu_torch.solvers import sweep

    prep = sweep.prepare_horn_aperture_sweep(
        HornAntennaParams.from_user_units(**HORN), APERTURES, device=device,
        **HORN_RUN)
    assert prep.ok, prep.message
    short_chunks(prep.sim)
    return prep


def run_port_sweep(prep, horn=False):
    """``run_*_sweep(prep)`` and the raw batched output it read."""
    from fdtd_solver_antennas_tpu_torch.solvers import sweep

    raw = []

    def spy(prepared, impl=None):
        raw.append(inner(prepared, impl))
        return raw[-1]

    inner, sweep._run_batched = sweep._run_batched, spy
    try:
        res = (sweep.run_horn_aperture_sweep(prep) if horn
               else sweep.run_patch_geometry_sweep(prep))
    finally:
        sweep._run_batched = inner
    assert res.ok, res.message
    return res, raw[0][0]


def save_sweep(path, res, out):
    """The results a test compares, as numpy arrays."""
    arrs = dict(uf=out["uf"], if_=out["if_"], steps=out["steps"],
                e_ratio=out["e_ratio"], e_max=out["e_max"],
                f_res_hz=res.f_res_hz, s11_min_db=res.s11_min_db,
                res_steps=res.steps, res_e_ratio=res.e_ratio,
                wall=np.float64(res.wall_time_s),
                rate=np.float64(res.mcells_per_s),
                rows=np.asarray(out.get("rows", range(len(out["steps"])))))
    if res.Dmax_dbi is not None:
        arrs["Dmax_dbi"] = res.Dmax_dbi
    for key in ("nf_e", "nf_h"):
        for i, a in enumerate(out[key]):
            arrs[f"{key}{i}"] = a
    for i, f in enumerate(out["fields"]):
        arrs[f"field{i}"] = f.cpu().numpy()
    np.savez(path, **arrs)


def load_sweep(path) -> dict:
    npz = np.load(path)
    out = {k: npz[k] for k in npz.files}
    for key in ("nf_e", "nf_h"):
        out[key] = [npz[f"{key}{i}"] for i in range(sum(
            k.startswith(key) and k[len(key):].isdigit() for k in npz.files))]
    out["fields"] = [npz[f"field{i}"] for i in range(6)]
    return out


def sweep_worker(rank, world, store, jobs):
    """One rank of a gloo process group running each job ``(path, what,
    n_var, n_sweep, n_spatial)`` in turn: the sweep (``what`` "patch" or
    "horn") sharded over ``make_sweep_mesh(n_sweep, n_spatial)``; every
    rank writes its results to ``path.format(rank=rank)``."""
    import torch.distributed as dist

    from fdtd_solver_antennas_tpu_torch.parallel import make_sweep_mesh, shard_sweep

    init_gloo(rank, world, store)
    try:
        for path, what, n_var, n_sweep, n_spatial in jobs:
            horn = what == "horn"
            prep = port_horn_sweep() if horn else port_patch_sweep(n_var)
            shard_sweep(prep, make_sweep_mesh(n_sweep, n_spatial))
            res, out = run_port_sweep(prep, horn)
            save_sweep(path.format(rank=rank), res, out)
    finally:
        dist.destroy_process_group()


def spawn_sweeps(tmp_path, world, jobs):
    """Each job ``name: (what, n_var, n_sweep, n_spatial)`` over ``world``
    gloo ranks in one spawn; per name the list of every rank's results."""
    import torch.multiprocessing as mp

    specs = [(str(tmp_path / f"sweep-{name}-{{rank}}.npz"), *job)
             for name, job in jobs.items()]
    mp.spawn(sweep_worker, nprocs=world,
             args=(world, str(tmp_path / "store"), specs))
    return {name: [load_sweep(spec[0].format(rank=r)) for r in range(world)]
            for name, spec in zip(jobs, specs)}
