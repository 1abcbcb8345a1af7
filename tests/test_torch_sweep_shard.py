"""Geometry sweeps sharded over gloo ranks against the JAX package, on the CPU.

``parallel.shard_sweep`` keeps on each rank the variants of its sweep
group; ``run_*_sweep`` runs that share (``run_batched``, or with an ``"x"``
axis of 2 each variant through the explicit path on the group's
sub-communicator) and one ``all_gather`` gives every rank every
variant's results. One ``torch.multiprocessing.spawn`` per rank count
(2 and 4 gloo ranks, a ``file://`` store in the test's temporary
directory, one intra-op thread a rank) runs every job of its rank count:

- 4 patch variants over 2 sweep ranks, and 3 padded onto 2 (the padded
  row repeats the last variant and is dropped);
- 4 patch variants over (sweep 2, x 2) on 4 ranks;
- 3 horn apertures padded onto 2 ranks (the face sums sliced to the real
  variants before ``nf2ff_transform_batch``).

Each is held to the JAX package's ``shard_sweep`` on the same mesh of
virtual CPU devices (its vmapped XLA run) and to the port's unsharded
sweep, at ``tests/test_torch_sweep.py``'s tolerances: rtol 2e-4, atol
1e-5·max|ref|; the final fields against the JAX package at its own sweep
bound, rtol 2e-3, atol 2e-4·max (ROADMAP C4). The patch variants are the
small scene of ``tests/test_sharding.py`` with its patch and loss varied
(``tests/_sweep_ranks.py``), the horn sweep ``tests/test_sweep_shard.py``'s
apertures at ``mesh_ppw`` 6 in chunks of 60 steps.
"""

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _sweep_ranks import (
    APERTURES,
    HORN,
    HORN_CHECK,
    HORN_RUN,
    PATCH_RUN,
    PATCHES,
    SWEEP_KW,
    patch_grid,
    patch_scene,
    port_horn_sweep,
    port_patch_sweep,
    run_port_sweep,
    spawn_sweeps,
)
from fdtd_solver_antennas_tpu import PatchAntennaParams as JPatch
from fdtd_solver_antennas_tpu.models.params import HornAntennaParams as JHorn
from fdtd_solver_antennas_tpu.models.scene import Scene as JScene
from fdtd_solver_antennas_tpu.ops.fdtd import FDTDConfig as JConfig
from fdtd_solver_antennas_tpu.ops.fdtd import build_simulation as jbuild
from fdtd_solver_antennas_tpu.ops.mesh import MeshBuilder as JMeshBuilder
from fdtd_solver_antennas_tpu.parallel import make_sweep_mesh as jmake_sweep_mesh
from fdtd_solver_antennas_tpu.parallel import shard_sweep as jshard_sweep
from fdtd_solver_antennas_tpu.solvers import sweep as jsweep
from fdtd_solver_antennas_tpu_torch.parallel import (
    make_sweep_mesh,
    pad_batch,
    shard_sweep,
    trim_sweep_out,
)
from fdtd_solver_antennas_tpu_torch.parallel import sharding, sweep_shard

RTOL, ATOL_REL = 2e-4, 1e-5
FIELD_RTOL, FIELD_ATOL_REL = 2e-3, 2e-4
# name: (what, variants, sweep ranks, spatial ranks)
JOBS_2 = {"4 over 2": ("patch", 4, 2, 1), "3 padded onto 2": ("patch", 3, 2, 1),
          "horn padded onto 2": ("horn", 3, 2, 1)}
JOBS_4 = {"sweep 2 x 2": ("patch", 4, 2, 2)}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Test workers share the cores (pytest-xdist)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _close(got, ref, what, rtol=RTOL, atol_rel=ATOL_REL):
    got, ref = np.asarray(got), np.asarray(ref)
    atol = atol_rel * max(float(np.abs(ref).max()), 1e-30)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol, err_msg=what)


# ---------------------------------------------------------------------------
# the mesh and the batch padding
# ---------------------------------------------------------------------------

def test_pad_batch():
    assert pad_batch(4, 4) == (4, 0)
    assert pad_batch(3, 4) == (4, 1)
    assert pad_batch(9, 4) == (12, 3)


def test_make_sweep_mesh_shapes(monkeypatch):
    """Without a process group: one rank. Over 8 ranks (the group's size
    patched) the JAX package's shapes and its ``ValueError``."""
    mesh = make_sweep_mesh()
    assert mesh.axis_names == ("sweep", "x") and mesh.shape == (1, 1)
    assert mesh.group is None and mesh.coords() == (0, 0)
    with pytest.raises(ValueError, match="1×2 != 1 ranks"):
        make_sweep_mesh(1, 2)
    monkeypatch.setattr(sweep_shard, "group_size", lambda g: 8)
    mesh = make_sweep_mesh(8, group=object())
    assert mesh.shape == (8, 1)
    assert make_sweep_mesh(group=object()).shape == (8, 1)
    with pytest.raises(ValueError, match="3×2 != 8 ranks"):
        make_sweep_mesh(3, 2, group=object())  # 6 != 8 ranks
    # (4, 2) needs the spatial sub-communicators: built over real ranks in
    # the 4-rank spawn below


def test_shard_sweep_keeps_the_share(monkeypatch):
    """3 variants on a 2-way sweep axis: rank 0 keeps 0 and 1, rank 1 keeps
    2 and the padded copy of 2; a sweep is sharded once."""
    mesh = sharding.RankMesh(np.arange(2).reshape(2, 1), ("sweep", "x"),
                             group="g")
    prep = port_patch_sweep(3)
    full = {k: v.clone() for k, v in prep.batched_coeffs.items()}
    monkeypatch.setattr(sharding.dist, "get_rank", lambda g: 1)
    shard_sweep(prep, mesh)
    assert prep._sweep_pad == 1 and prep._sweep_mesh is mesh
    for k, v in prep.batched_coeffs.items():
        assert torch.equal(v, full[k][[2, 2]])
    with pytest.raises(ValueError, match="sharded already"):
        shard_sweep(prep, mesh)
    out = {"steps": np.arange(4), "nf_e": [np.zeros((4, 2))], "x": np.ones(2)}
    got = trim_sweep_out(prep, out)
    assert got["steps"].tolist() == [0, 1, 2] and got["nf_e"][0].shape == (2 + 1, 2)
    assert got["x"] is out["x"]
    unsharded = port_patch_sweep(3)
    assert trim_sweep_out(unsharded, out) is out
    with pytest.raises(ValueError, match="prepare a sweep"):
        shard_sweep(SimpleNamespace(batched_coeffs=None), mesh)


# ---------------------------------------------------------------------------
# the sharded sweeps, the port's unsharded sweep and the JAX package's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """Every rank's results of every job, one spawn per rank count."""
    outs = spawn_sweeps(tmp_path_factory.mktemp("sweep2"), 2, JOBS_2)
    outs.update(spawn_sweeps(tmp_path_factory.mktemp("sweep4"), 4, JOBS_4))
    return outs


def _jax_patch_sweep(n_var):
    grid = patch_grid(JMeshBuilder)
    sims = [jbuild(patch_scene(JScene, *p), grid,
                   cfg=JConfig(**PATCH_RUN, use_pallas=False), **SWEEP_KW)
            for p in PATCHES[:n_var]]
    params = JPatch.from_user_units(frequency_ghz=2.45, er=4.3, h_mm=1.6)
    return jsweep.SweepPrepared(
        True, "", sim=sims[0], variants=[params] * n_var,
        batched_coeffs={k: jnp.stack([s.coeffs[k] for s in sims])
                        for k in sims[0].coeffs},
        _vrun=jsweep._make_vmapped_run(sims[0]))


def _jax_horn_sweep():
    prep = jsweep.prepare_horn_aperture_sweep(
        JHorn.from_user_units(**HORN), APERTURES, use_pallas=False, **HORN_RUN)
    assert prep.ok, prep.message
    prep.sim.cfg = dataclasses.replace(prep.sim.cfg, check_every=HORN_CHECK)
    prep._vrun = jsweep._make_vmapped_run(prep.sim)
    return prep


def _jax_sharded(what, n_var, n_sweep, n_spatial):
    """The JAX package's sharded sweep on the first n_sweep·n_spatial
    virtual devices: its raw output (padded rows kept) and its result."""
    prep = _jax_horn_sweep() if what == "horn" else _jax_patch_sweep(n_var)
    jshard_sweep(prep, jmake_sweep_mesh(
        n_sweep, n_spatial, devices=jax.devices()[:n_sweep * n_spatial]))
    raw = []

    def spy(prepared):
        raw.append(inner(prepared))
        return raw[-1]

    inner, jsweep._run_batched = jsweep._run_batched, spy
    try:
        res = (jsweep.run_horn_aperture_sweep(prep) if what == "horn"
               else jsweep.run_patch_geometry_sweep(prep))
    finally:
        jsweep._run_batched = inner
    assert res.ok, res.message
    return raw[0][0], res


def _port_unsharded(what, n_var):
    prep = port_horn_sweep() if what == "horn" else port_patch_sweep(n_var)
    return run_port_sweep(prep, what == "horn")


ALL_JOBS = {**JOBS_2, **JOBS_4}


@pytest.mark.parametrize("name", list(ALL_JOBS))
def test_sharded_sweep_equals_the_unsharded_sweep(sharded, name):
    """Every rank holds every real variant's results: the unsharded run's
    (the padded rows dropped), the share's fields its variants' fields;
    the wall and the rate are the whole sweep's, the same on every rank."""
    what, n_var, n_sweep, n_spatial = ALL_JOBS[name]
    res, ref = _port_unsharded(what, n_var)
    padded, pad = pad_batch(n_var, n_sweep)
    for r, out in enumerate(sharded[name]):
        assert out["steps"].shape == (padded,), (r, out["steps"])
        np.testing.assert_array_equal(out["steps"][:n_var], ref["steps"])
        np.testing.assert_array_equal(out["res_steps"], res.steps)
        if pad:  # the padded rows replay the last variant
            np.testing.assert_array_equal(out["uf"][n_var:],
                                          np.repeat(out["uf"][n_var - 1:n_var], pad, 0))
        _close(out["e_ratio"][:n_var], ref["e_ratio"], f"rank {r} e_ratio")
        _close(out["e_max"][:n_var], ref["e_max"], f"rank {r} e_max")
        _close(out["uf"][:n_var], ref["uf"], f"rank {r} uf")
        _close(out["if_"][:n_var], ref["if_"], f"rank {r} if_")
        for key in ("nf_e", "nf_h"):
            for i, (a, b) in enumerate(zip(out[key], ref[key], strict=True)):
                _close(a[:n_var], b, f"rank {r} {key} {i}")
        share = out["rows"]
        assert len(share) == padded // n_sweep
        for i, f in enumerate(out["fields"]):
            _close(f, ref["fields"][i][share].numpy(), f"rank {r} field {i}")
        _close(out["f_res_hz"], res.f_res_hz, f"rank {r} f_res")
        _close(out["s11_min_db"], res.s11_min_db, f"rank {r} s11_min")
        if what == "horn":
            _close(out["Dmax_dbi"], res.Dmax_dbi, f"rank {r} Dmax")
        assert out["wall"] == sharded[name][0]["wall"] > 0
        assert out["rate"] == sharded[name][0]["rate"]
    # the sweep groups' shares cover every variant, padding on the last
    rows = sorted({int(v) for out in sharded[name] for v in out["rows"]})
    assert rows == list(range(n_var))


@pytest.mark.parametrize("name", list(ALL_JOBS))
def test_sharded_sweep_matches_jax_shard_sweep(sharded, name):
    """The JAX package's ``shard_sweep`` on the same mesh of virtual
    devices: per real variant ``steps``, ``e_ratio``, ``uf``, ``if_``, the
    face sums and the final fields; the horn's Dmax."""
    what, n_var, n_sweep, n_spatial = ALL_JOBS[name]
    jout, jres = _jax_sharded(what, n_var, n_sweep, n_spatial)
    out = sharded[name][-1]
    np.testing.assert_array_equal(out["steps"][:n_var],
                                  np.asarray(jout["steps"])[:n_var])
    _close(out["e_ratio"][:n_var], np.asarray(jout["e_ratio"])[:n_var], "e_ratio")
    for key in ("uf", "if_"):
        j = np.asarray(jout[key])[:n_var]
        _close(out[key][:n_var], j[:, 0] + 1j * j[:, 1], key)
    for key in ("nf_e", "nf_h"):
        for i, (a, b) in enumerate(zip(out[key], jout[key], strict=True)):
            _close(a[:n_var], np.asarray(b)[:n_var], f"{key} {i}")
    for i, (f, jf) in enumerate(zip(out["fields"], jout["fields"])):
        jf = np.asarray(jf)[out["rows"]]
        _close(f[(slice(None),) + tuple(slice(0, n) for n in jf.shape[1:])], jf,
               f"field {i}", FIELD_RTOL, FIELD_ATOL_REL)
    np.testing.assert_allclose(out["f_res_hz"], jres.f_res_hz, rtol=RTOL)
    if what == "horn":
        assert out["Dmax_dbi"].shape == jres.Dmax_dbi.shape == (n_var,)
        _close(out["Dmax_dbi"], jres.Dmax_dbi, "Dmax dBi")
