"""``parallel/sharding.py`` against the JAX package's GSPMD path, on the CPU.

``shard_simulation(sim, mesh)`` makes ``sim.run()`` run SPMD over the
ranks of a gloo process group laid out as a mesh: over x on the explicit
path's default route (K3's slab stepper, its plain twin here), over
x × y on the per-step walk with one halo plane per split axis. One
``torch.multiprocessing.spawn`` per rank count (2 and 4 gloo ranks, one
intra-op thread a rank) runs every job: MUR and PML_4 on the scene of
``tests/test_sharding.py::_build`` over a 2-rank x mesh and a (2, 2)
x × y mesh (padded to ``(2, 2, 1)``, as JAX's ``test_two_axis_mesh``
pads), and a y straddle over a (1, 4) mesh (the top y wall on the last
block's first plane). Each run, on the first and the last rank, is held
to the JAX package's ``shard_simulation`` on the same mesh of virtual CPU
devices and to its single-device run at the JAX package's own tolerances
(rtol 1e-3, atol 1e-4·max|ref|, ``tests/test_sharding.py:44-66``; the
two-axis ``uf`` at rtol 1e-4, atol 1e-12, ``:138-147``). The mesh shapes
and ``shard_fields``' blocks are checked without a process group.
"""

import numpy as np
import pytest
import torch

from _explicit_jax import jax_sharded
from _explicit_ranks import assert_close_surface, port_sim, spawn_runs
from fdtd_solver_antennas_tpu_torch.parallel import (
    make_device_mesh,
    shard_fields,
    shard_simulation,
    sharded_step_fn,
)
from fdtd_solver_antennas_tpu_torch.parallel import sharding

RTOL, ATOL_REL = 1e-3, 1e-4
CTL = dict(n_steps=60, check_every=30)  # two chunks of 3 probe intervals
# name: (kind, boundary, mesh shape, pad_multiple)
JOBS_2 = {f"x {b}": ("small", b, (2,), (2, 1, 1)) for b in ("MUR", "PML_4")}
JOBS_4 = {f"xy {b}": ("small", b, (2, 2), (2, 2, 1)) for b in ("MUR", "PML_4")}
JOBS_4["y straddle"] = ("ystraddle", "MUR", (1, 4), (1, 4, 1))
ALL_JOBS = {**JOBS_2, **JOBS_4}


def _ctl():
    return tuple(sorted(CTL.items()))


@pytest.fixture(scope="module")
def outs(tmp_path_factory):
    """The first and the last rank's output surface of every job."""
    got = {}
    for world, jobs in ((2, JOBS_2), (4, JOBS_4)):
        got.update(spawn_runs(
            tmp_path_factory.mktemp(f"ranks{world}"), world,
            {name: (kind, b, CTL, None, dict(mesh=shape, pad=pad,
                                                 every_rank=True))
             for name, (kind, b, shape, pad) in jobs.items()}))
    return got


@pytest.mark.parametrize("name", list(ALL_JOBS))
def test_shard_simulation_matches_jax(outs, name):
    kind, boundary, shape, pad = ALL_JOBS[name]
    refs = jax_sharded(kind, boundary, shape, pad, _ctl())
    for out in (outs[name], outs[name + " last"]):
        assert out["fields"][0].shape == tuple(np.asarray(refs[0]["fields"][0]).shape)
        for ref in refs:
            assert_close_surface(out, ref, RTOL, ATOL_REL)
        if len(shape) == 2 and shape[1] > 1:  # JAX's test_two_axis_mesh
            np.testing.assert_allclose(out["uf"], refs[0]["uf"], rtol=1e-4,
                                       atol=1e-12)


@pytest.mark.parametrize("name", list(ALL_JOBS))
def test_every_rank_gets_the_same_surface(outs, name):
    first, last = outs[name], outs[name + " last"]
    assert first["steps"] == last["steps"]
    for key in ("uf", "if_"):
        np.testing.assert_array_equal(first[key], last[key])
    for a, b in zip((*first["fields"], *first["nf_e"]),
                    (*last["fields"], *last["nf_e"]), strict=True):
        np.testing.assert_array_equal(a, b)


def test_make_device_mesh_shapes(monkeypatch):
    """Without a process group: one rank. Over 8 ranks (the group's size
    patched): 1-D and 2-D shapes, the default shape along x, and the
    shapes that do not cover the ranks."""
    mesh = make_device_mesh()
    assert (mesh.shape, mesh.axis_names, mesh.group) == ((1,), ("x",), None)
    assert make_device_mesh((1, 1), ("x", "y")).coords() == (0, 0)
    with pytest.raises(ValueError, match="does not cover 1 ranks"):
        make_device_mesh((2,))
    monkeypatch.setattr(sharding, "group_size", lambda g: 8)
    g = object()
    assert make_device_mesh(group=g).shape == (8,)
    assert make_device_mesh(axis_names=("x", "y"), group=g).shape == (8, 1)
    mesh = make_device_mesh((4, 2), ("x", "y"), group=g)
    assert mesh.ranks.tolist() == np.arange(8).reshape(4, 2).tolist()
    for shape, names in (((3,), ("x",)), ((4, 3), ("x", "y")),
                         ((8,), ("x", "y")), ((2, 2, 2), ("x", "y", "z"))):
        with pytest.raises(ValueError):
            make_device_mesh(shape, names, group=g)


def test_field_partition_spec():
    def mesh(shape, names):
        return sharding.RankMesh(np.arange(int(np.prod(shape))).reshape(shape),
                                 names)

    assert sharding.field_partition_spec(mesh((4,), ("x",))) == ("x", None, None)
    assert sharding.field_partition_spec(mesh((4, 2), ("x", "y"))) == ("x", "y", None)
    assert sharding.field_partition_spec(mesh((4, 1), ("x", "y"))) == ("x", None, None)


@pytest.mark.parametrize("shape", [(4,), (2, 2), (4, 1)])
def test_shard_fields_blocks(monkeypatch, shape):
    """Each rank's blocks of (Px, Py, Pz) arrays and tensors tile the
    arrays; anything not 3-D passes through; a shape the mesh does not
    divide raises."""
    names = ("x", "y")[:len(shape)]
    mesh = sharding.RankMesh(np.arange(4).reshape(shape), names, group="g")
    a = np.arange(8 * 6 * 3, dtype=np.float32).reshape(8, 6, 3)
    t = torch.from_numpy(a.copy())
    blocks = {}
    for r in range(4):
        monkeypatch.setattr(sharding.dist, "get_rank", lambda g, r=r: r)
        got = shard_fields({"a": a, "t": [t, torch.ones(3)], "n": 5}, mesh)
        assert got["n"] == 5 and got["t"][1].shape == (3,)
        assert torch.equal(got["t"][0], torch.from_numpy(got["a"]))
        blocks[mesh.coords()] = got["a"]
    sy = shape[1] if len(shape) == 2 else 1
    rows = [np.concatenate([blocks[(x, y)[:len(shape)]] for y in range(sy)], 1)
            for x in range(shape[0])]
    np.testing.assert_array_equal(np.concatenate(rows), a)
    with pytest.raises(ValueError, match="does not split"):
        shard_fields(np.zeros((6, 5, 3)), mesh)


def test_shard_simulation_one_rank():
    """One rank without a process group: ``sim.run()`` through the
    explicit path equals the unsharded run; a shape the mesh does not
    divide, and an abort callback, are refused."""
    sim = port_sim("small", "MUR", 1)
    ref = sim.run()
    assert sharded_step_fn(sim, make_device_mesh()) is sim
    progress = []
    out = sim.run(progress_cb=lambda *a: progress.append(a))
    assert out["steps"] == ref["steps"] and progress == [(120, 120, out["e_ratio"])]
    for a, b in zip(out["fields"], ref["fields"], strict=True):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="abort_cb"):
        sim.run(abort_cb=lambda: False)
    mesh = sharding.RankMesh(np.arange(4).reshape(2, 2), ("x", "y"))
    with pytest.raises(ValueError, match="pad_multiple=\\(2, 2, 1\\)"):
        shard_simulation(port_sim("small", "MUR", 1), mesh)  # Py = 21
