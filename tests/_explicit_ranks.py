"""Scenes and the rank worker of the explicit-path tests.

The worker runs in processes started by ``torch.multiprocessing.spawn``,
which import this module by name, so it imports nothing of JAX: the test
files that hold the port against the JAX package import JAX themselves.
"""

from datetime import timedelta

import numpy as np

FREQS = dict(port_freqs_hz=np.linspace(2e9, 3e9, 7),
             nf_freqs_hz=np.array([2.45e9]))
N_STEPS = 120


def scene(mesh_builder, scene_cls, kind):
    """``small``: the scene of tests/test_sharding.py::_build (22×21×21);
    ``straddle``: a 13-line x axis, so that at 4 ranks (Px = 16, n = 4)
    the top MUR wall, row 12, is the first row of the last block;
    ``tall_z``: the z = 131 scene of tests/test_sharding.py::_build_tall
    on 16 x lines (16×16×131, past the 128 z lines of K3's route);
    ``tall_straddle``: the same on 13 x lines, the straddle at z = 131;
    ``ystraddle``: ``straddle`` with x and y swapped, so that over 4 ranks
    along y (Py = 16, 4 planes a rank) the top y wall, plane 12, is the
    first plane of the last block."""
    mb = mesh_builder()
    sc = scene_cls()
    if kind in ("tall_z", "tall_straddle"):
        nx = 16 if kind == "tall_z" else 13
        mb.add_line("x", np.linspace(0, nx - 1, nx))
        mb.add_line("y", np.linspace(0, 15, 16))
        mb.add_line("z", np.linspace(0, 130, 131))
        grid = mb.build(1.0)
        c = (nx - 1) // 2
        sc.add_material_box("sub", 4.3, 0.005, [c - 4, 4, 60], [c + 4, 11, 64], 0)
        sc.add_metal_box("patch", [c - 3, 6, 64], [c + 3, 10, 64], priority=10)
        sc.add_metal_box("gnd", [c - 4, 4, 60], [c + 4, 11, 60], priority=10)
        sc.add_lumped_port(1, 50.0, [c, 8, 60], [c, 8, 64], direction="z")
    elif kind == "small":
        mb.add_line("x", [-40, 40, 0.0, -6.0])
        mb.add_line("y", [-40, 40, 0.0])
        mb.add_line("z", [-20, 30])
        mb.add_line("z", np.linspace(0, 1.6, 3))
        grid = mb.build(4.0)
        sc.add_material_box("sub", 4.3, 0.005, [-20, -20, 0], [20, 20, 1.6], 0)
        sc.add_metal_box("patch", [-15, -12, 1.6], [15, 12, 1.6], priority=10)
        sc.add_metal_box("gnd", [-20, -20, 0], [20, 20, 0], priority=10)
        sc.add_lumped_port(1, 50.0, [-6, 0, 0], [-6, 0, 1.6], direction="z")
    elif kind == "ystraddle":
        mb.add_line("x", np.linspace(0, 15, 16))
        mb.add_line("y", np.linspace(0, 12, 13))
        mb.add_line("z", np.linspace(0, 19, 20))
        grid = mb.build(1.0)
        sc.add_material_box("sub", 4.3, 0.005, [4, 3, 8], [11, 9, 10], 0)
        sc.add_metal_box("patch", [6, 4, 10], [10, 8, 10], priority=10)
        sc.add_metal_box("gnd", [4, 3, 8], [11, 9, 8], priority=10)
        sc.add_lumped_port(1, 50.0, [8, 6, 8], [8, 6, 10], direction="z")
    else:
        mb.add_line("x", np.linspace(0, 12, 13))
        mb.add_line("y", np.linspace(0, 15, 16))
        mb.add_line("z", np.linspace(0, 19, 20))
        grid = mb.build(1.0)
        sc.add_material_box("sub", 4.3, 0.005, [3, 4, 8], [9, 11, 10], 0)
        sc.add_metal_box("patch", [4, 6, 10], [8, 10, 10], priority=10)
        sc.add_metal_box("gnd", [3, 4, 8], [9, 11, 8], priority=10)
        sc.add_lumped_port(1, 50.0, [6, 8, 8], [6, 8, 10], direction="z")
    return sc, grid


def controls(boundary, n_steps=N_STEPS, decim=10, check_every=60):
    return dict(n_steps_max=n_steps, check_every=check_every,
                end_criteria=1e-30, boundary=boundary, probe_decimation=decim)


def build_kwargs(n_dev):
    """``n_dev`` ranks along x, or a ``pad_multiple`` tuple."""
    pad = tuple(n_dev) if isinstance(n_dev, (tuple, list)) else (n_dev, 1, 1)
    return dict(f0=2.45e9, fc=1.225e9, nf_margin_cells=2, pad_multiple=pad,
                **FREQS)


def port_sim(kind, boundary, n_dev, device="cpu", **ctl):
    from fdtd_solver_antennas_tpu_torch.models.scene import Scene
    from fdtd_solver_antennas_tpu_torch.ops.fdtd import FDTDConfig, build_simulation
    from fdtd_solver_antennas_tpu_torch.ops.mesh import MeshBuilder

    sc, grid = scene(MeshBuilder, Scene, kind)
    return build_simulation(sc, grid, cfg=FDTDConfig(**controls(boundary, **ctl)),
                            device=device, **build_kwargs(n_dev))


# ---------------------------------------------------------------------------
# outputs and checkpoints through .npz files
# ---------------------------------------------------------------------------

_STATE_KEYS = ("uf", "if_", "nf_e", "nf_h", "n", "e_max", "e_ratio", "decim")


def _state_arrays(st) -> dict:
    arrs = {f"field{i}": np.asarray(f) for i, f in enumerate(st["fields"])}
    for grp in ("psi_e", "psi_h"):
        arrs.update({f"{grp}:{k}": np.asarray(v)
                     for k, v in (st.get(grp) or {}).items()})
    for k in _STATE_KEYS:
        if st.get(k) is not None:
            arrs[f"state:{k}"] = np.asarray(st[k])
    return arrs


def save_out(path, out, fused=None):
    """A run's output surface and its state as numpy arrays, and ``fused``,
    each rank's ``Walk.fused`` (None: not a walk)."""
    from fdtd_solver_antennas_tpu_torch.ops.fdtd import state_to_numpy

    arrs = _state_arrays(state_to_numpy(out["state"]))
    arrs["uf"], arrs["if_"] = out["uf"], out["if_"]
    if fused is not None and None not in fused:
        arrs["fused"] = np.array(fused, bool)
    for key in ("nf_e", "nf_h"):
        for i, a in enumerate(out[key]):
            arrs[f"{key}{i}"] = a
    np.savez(path, **arrs)


def load_state(npz) -> dict:
    """A checkpoint written by :func:`save_out` or :func:`spawn_run`, as
    either package resumes it."""
    st = {"fields": tuple(npz[f"field{i}"] for i in range(6))}
    for grp in ("psi_e", "psi_h"):
        st[grp] = {k.split(":")[1]: npz[k] for k in npz.files
                   if k.startswith(grp + ":")}
    for k in _STATE_KEYS:
        if f"state:{k}" in npz.files:
            st[k] = npz[f"state:{k}"]
    return st


def load_out(path) -> dict:
    npz = np.load(path)
    n_faces = sum(k.startswith("nf_e") and k[4:].isdigit() for k in npz.files)
    st = load_state(npz)
    return dict(
        fields=st["fields"], uf=npz["uf"], if_=npz["if_"],
        nf_e=[npz[f"nf_e{i}"] for i in range(n_faces)],
        nf_h=[npz[f"nf_h{i}"] for i in range(n_faces)],
        steps=int(st["n"]), e_ratio=float(st["e_ratio"]), state=st,
        fused=npz["fused"] if "fused" in npz.files else None,
    )


def assert_close_surface(out, ref, rtol, atol_rel):
    """The output surfaces of two runs agree: same steps; uf, if_, nf_e,
    nf_h, e_ratio, fields and ψ at ``rtol`` and ``atol_rel``·max|ref|."""

    def close(a, b, what):
        a, b = np.asarray(a), np.asarray(b)
        atol = atol_rel * max(float(np.abs(b).max()), 1e-20)
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=what)

    assert int(out["steps"]) == int(ref["steps"])
    close(out["e_ratio"], float(ref["e_ratio"]), "e_ratio")
    close(out["uf"], ref["uf"], "uf")
    close(out["if_"], ref["if_"], "if_")
    for key in ("nf_e", "nf_h"):
        for i, (a, b) in enumerate(zip(out[key], ref[key], strict=True)):
            close(a, b, f"{key}[{i}]")
    for i, (a, b) in enumerate(zip(out["fields"], ref["fields"], strict=True)):
        close(a, b, f"field {i}")
    for grp in ("psi_e", "psi_h"):
        theirs = ref["state"].get(grp) or {}
        assert set(out["state"].get(grp) or {}) == set(theirs), grp
        for k, v in theirs.items():
            close(out["state"][grp][k], v, f"{grp} {k}")


def last_path(out_path):
    """Where the last rank writes its output surface (``every_rank``)."""
    return out_path[:-len(".npz")] + "-last.npz"


def run_job(world, kind, boundary, ctl, resume, opts):
    """One job on this rank: the explicit path over the whole group
    (``use_kernel`` from ``opts``: None the slab kernels, False the
    walk), or, with ``opts["mesh"]``, ``sim.run()`` after
    ``shard_simulation`` over that mesh (axes x, y), the simulation padded
    to ``opts["pad"]`` (default ``(world, 1, 1)``). Returns the output and
    the rank's ``Walk.fused`` (None off the walk or under a mesh)."""
    import torch.distributed as dist

    from fdtd_solver_antennas_tpu_torch.parallel import (
        build_explicit_run, make_device_mesh, shard_simulation)

    sim = port_sim(kind, boundary, opts.get("pad", world), **ctl)
    if "mesh" in opts:
        shape = opts["mesh"]
        shard_simulation(sim, make_device_mesh(shape, ("x", "y")[:len(shape)]))
        return sim.run(resume_state=resume), None
    run = build_explicit_run(sim, group=dist.group.WORLD,
                             use_kernel=opts.get("use_kernel"))
    return run(resume_state=resume), getattr(run.stepper, "fused", None)


def init_gloo(rank, world, store):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world, timeout=timedelta(seconds=120))


def rank_worker(rank, world, store, jobs):
    """One rank of a gloo process group that runs each job ``(out_path,
    kind, boundary, ctl, resume_path, opts)`` in turn (:func:`run_job`);
    rank 0 writes each output surface, with every rank's ``Walk.fused``,
    to its ``out_path``, and with ``opts["every_rank"]`` the last rank to
    :func:`last_path` too."""
    import torch.distributed as dist

    init_gloo(rank, world, store)
    try:
        for out_path, kind, boundary, ctl, resume_path, opts in jobs:
            resume = load_state(np.load(resume_path)) if resume_path else None
            out, fused = run_job(world, kind, boundary, ctl, resume, opts)
            flags = [None] * world
            dist.all_gather_object(flags, fused)
            if rank == 0:
                save_out(out_path, out, flags)
            elif rank == world - 1 and opts.get("every_rank"):
                save_out(last_path(out_path), out)
    finally:
        dist.destroy_process_group()


def spawn_runs(tmp_path, world, jobs):
    """Run the port's explicit path over ``world`` gloo ranks, one process
    group for every job ``name: (kind, boundary, ctl, resume_state)`` or
    ``(kind, boundary, ctl, resume_state, opts)`` (:func:`run_job`);
    rank 0's output surface per name, its ``fused`` every rank's route on
    the walk (and the last rank's surface as ``name + " last"`` where
    ``opts["every_rank"]``)."""
    import torch.multiprocessing as mp

    specs = []
    for name, (kind, boundary, ctl, resume_state, *opts) in jobs.items():
        resume_path = None
        if resume_state is not None:
            resume_path = str(tmp_path / f"resume-{name}.npz")
            np.savez(resume_path, **_state_arrays(resume_state))
        specs.append((str(tmp_path / f"out-{name}.npz"), kind, boundary, ctl,
                      resume_path, opts[0] if opts else {}))
    mp.spawn(rank_worker, nprocs=world,
             args=(world, str(tmp_path / "store"), specs))
    outs = {name: load_out(spec[0]) for name, spec in zip(jobs, specs)}
    for name, spec in zip(jobs, specs):
        if spec[5].get("every_rank"):
            outs[name + " last"] = load_out(last_path(spec[0]))
    return outs
