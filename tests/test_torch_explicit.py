"""The port's explicit run on one rank against the JAX package, on the CPU.

``parallel.build_explicit_run(sim)`` with no process group is one rank: it
steps the halo-extended slab with the shard stepper's plain twin and must
match the JAX package's ``build_explicit_run`` on a 1-device mesh with its
shard kernel in interpret mode (rtol 2e-4, atol 1e-5·max|ref|), and equal
the port's own chunk-mode run bit for bit. At Pz > 128 (the ``tall_z``
scene, z = 131) the run takes K2's slab stepper and must match the JAX
package's single-device run and its explicit XLA walk
(``use_kernel=False``) at the same tolerance under MUR_1, PEC and PML_4.
Checkpoints carry across between the two packages' explicit paths, and
the padding and NF margin of ``build_simulation`` are the JAX package's.
``use_kernel=False`` is the per-step walk (K1's per-step kernels on a
slab with one halo row a side; their plain twins here): it must match the
JAX package's walk and its single-device run (rtol 1e-3, atol 1e-4·max on
``small``, the JAX explicit path's own tolerance; 2e-4 / 1e-5·max on
``tall_z``), equal the port's chunk-mode run bit for bit at one rank, and
resume a JAX walk checkpoint. A one-rank walk takes no straddle, so it
steps E and the MUR walls of all three axes in one call,
``fdtd_cuda.e_update_mur`` (``Walk.fused``; its kernel's schedule is held
to its twin in ``tests/test_torch_persist.py``). Runs over 2 and 4 ranks
are in ``tests/test_torch_explicit_2ranks.py`` and ``..._4ranks.py``.
"""

import numpy as np
import pytest
import torch

from _explicit_jax import jax_explicit, jax_refs, jax_sim, numpy_state
from _explicit_ranks import FREQS, assert_close_surface, controls, port_sim
from fdtd_solver_antennas_tpu_torch.models.scene import Scene
from fdtd_solver_antennas_tpu_torch.ops import fdtd_cuda, fdtd_shard
from fdtd_solver_antennas_tpu_torch.ops.fdtd import (
    FDTDConfig,
    build_simulation,
    state_to_numpy,
)
from fdtd_solver_antennas_tpu_torch.ops.mesh import MeshBuilder
from fdtd_solver_antennas_tpu_torch.parallel import build_explicit_run

RTOL, ATOL_REL = 2e-4, 1e-5  # the JAX package's kernel-vs-XLA tolerance
WALK_RTOL, WALK_ATOL_REL = 1e-3, 1e-4  # its explicit path's (test_sharding.py)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Test workers share the cores (pytest-xdist)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_explicit_ref(boundary):
    return jax_refs("small", boundary, 1)[1]


@pytest.mark.parametrize("boundary", ["MUR", "PEC", "PML_4"])
def test_one_rank_matches_jax_explicit_kernel(boundary):
    out = build_explicit_run(port_sim("small", boundary, 1))()
    assert not out["aborted"]
    assert_close_surface(out, _jax_explicit_ref(boundary), RTOL, ATOL_REL)


@pytest.mark.parametrize("boundary", ["MUR", "PEC", "PML_4"])
def test_one_rank_equals_chunk_mode(boundary):
    """One rank's halos are out-of-domain rows that stay zero, so every
    owned cell does the chunk kernels' arithmetic: bit-equal."""
    sim = port_sim("small", boundary, 1)
    run = build_explicit_run(sim)
    assert (run.kernel_window, run.stepper.W) == (10, 10)
    out, ref = run(), sim.run()
    assert out["steps"] == ref["steps"] == 120
    assert out["e_ratio"] == ref["e_ratio"]
    for a, b in zip((*out["fields"], *out["state"]["psi_e"].values()),
                    (*ref["fields"], *ref["state"]["psi_e"].values()), strict=True):
        assert torch.equal(a, b)
    for key in ("uf", "if_"):
        np.testing.assert_array_equal(out[key], ref[key])
    for a, b in zip(out["nf_h"], ref["nf_h"], strict=True):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("boundary", ["MUR_1", "PEC", "PML_4"])
def test_one_rank_at_tall_z_matches_jax(boundary):
    """Pz = 131 > 128: K2's slab stepper (T steps a launch, W = T + 1)
    against the JAX package's single-device run and its explicit XLA
    walk, which its explicit run at Pz > 128 is held to."""
    run = build_explicit_run(port_sim("tall_z", boundary, 1))
    sh = run.stepper
    assert sh.ops.shape[2] == 131 > fdtd_shard.MAX_PZ
    assert sh.W == sh.K + 1 == run.kernel_window + 1 and sh.rem == 10 % sh.K
    out = run()
    for ref in jax_refs("tall_z", boundary, 1, use_kernel=False):
        assert_close_surface(out, ref, RTOL, ATOL_REL)


@pytest.mark.parametrize("k_steps", [3, 7])
def test_k_only_sets_the_exchange_cadence(k_steps):
    """A remainder window every interval (10 = 3·3 + 1 = 7 + 3) leaves
    the run unchanged."""
    sim = port_sim("small", "MUR", 1)
    run = build_explicit_run(sim, k_steps=k_steps)
    assert run.kernel_window == k_steps and run.stepper.rem == 10 % k_steps
    out, ref = run(), build_explicit_run(sim)()
    for a, b in zip(out["fields"], ref["fields"], strict=True):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(out["uf"], ref["uf"])


def test_port_resumes_a_jax_explicit_checkpoint():
    """A JAX explicit checkpoint at step 60 resumes on the port's explicit
    path to the JAX package's uninterrupted run."""
    half = jax_explicit("small", "PML_4", 1, n_steps=60)
    assert int(half["steps"]) == 60
    out = build_explicit_run(port_sim("small", "PML_4", 1))(
        resume_state=numpy_state(half["state"]))
    assert_close_surface(out, _jax_explicit_ref("PML_4"), RTOL, ATOL_REL)


def test_jax_resumes_a_port_explicit_checkpoint():
    half = build_explicit_run(port_sim("small", "MUR", 1, n_steps=60))()
    state = state_to_numpy(half["state"])
    assert state["n"] == 60 and state["fields"][0].shape == (22, 21, 21)
    out = jax_explicit("small", "MUR", 1, resume_state=state)
    assert_close_surface(out, _jax_explicit_ref("MUR"), RTOL, ATOL_REL)


def test_padding_and_nf_margin_match_jax():
    """``pad_multiple`` and ``nf_margin_cells`` as the JAX package builds
    them: padded coefficients with zeros, the same Huygens box; and the
    padded run equals the unpadded one on the grid's cells."""
    jsim = jax_sim("small", "PML_4", 8)
    psim = port_sim("small", "PML_4", 8)
    assert psim.padded_shape == jsim.padded_shape == (24, 21, 21)
    for k, v in jsim._coeffs_np.items():
        np.testing.assert_array_equal(psim._coeffs_np[k], v)
    assert [(f.axis, f.m, f.u0, f.u1, f.v0, f.v1) for f in psim.faces] == \
        [(f.axis, f.m, f.u0, f.u1, f.v0, f.v1) for f in jsim.faces]
    inv_p, inv_d, mur_coef, pml = psim._aux
    jp, jd, _jm, jpml = jsim._aux
    for a in range(3):
        np.testing.assert_array_equal(inv_p[a], jp[a])
        np.testing.assert_array_equal(inv_d[a], jd[a])
        for kind in ("node", "half"):
            for j in range(2):
                np.testing.assert_array_equal(pml[a][kind][j], jpml[a][kind][j])
    padded, plain = psim.run(), port_sim("small", "PML_4", 1).run()
    for a, b in zip(padded["fields"], plain["fields"], strict=True):
        assert torch.equal(a[:22], b) and not a[22:].any()
    np.testing.assert_array_equal(padded["uf"], plain["uf"])


@pytest.mark.parametrize("route", ["xla_walk", "tall_z"])
def test_unported_routes_raise(route):
    """Both routes that once raised now run. The per-step walk
    (``use_kernel=False``) runs on K1's per-step kernels: at one rank it
    matches the JAX package's walk and equals chunk mode bit for bit, and
    the slab kernels' ``k_steps`` is refused. Pz = 131 takes K2's slab
    stepper and equals the single-card run, while K3's stepper still
    refuses it (the router, not K3, picks the route)."""
    if route == "xla_walk":
        sim = port_sim("small", "MUR", 1)
        run = build_explicit_run(sim, use_kernel=False)
        assert run.kernel_window is None and run.stepper.ops.shape == (24, 21, 21)
        out, ref = run(), sim.run()
        assert_close_surface(out, jax_refs("small", "MUR", 1, use_kernel=False)[1],
                             WALK_RTOL, WALK_ATOL_REL)
        for a, b in zip(out["fields"], ref["fields"], strict=True):
            assert torch.equal(a, b)
        with pytest.raises(ValueError, match="k_steps"):
            build_explicit_run(sim, use_kernel=False, k_steps=3)
        return
    mb = MeshBuilder()
    mb.add_line("x", np.linspace(0, 9, 10))
    mb.add_line("y", np.linspace(0, 9, 10))
    mb.add_line("z", np.linspace(0, 130, 131))
    sim = build_simulation(Scene(), mb.build(1.0), f0=2.45e9, fc=1.225e9,
                           cfg=FDTDConfig(**controls("MUR")), device="cpu",
                           **FREQS)
    run = build_explicit_run(sim)
    assert run.stepper.W == run.kernel_window + 1
    out, ref = run(), sim.run()
    assert out["steps"] == ref["steps"]
    for a, b in zip(out["fields"], ref["fields"], strict=True):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="Pz=131"):
        fdtd_shard.build_shard_stepper(sim, 1, 0)


# ---------------------------------------------------------------------------
# the per-step walk (use_kernel=False)
# ---------------------------------------------------------------------------

WALK_CASES = [("small", b) for b in ("MUR", "PEC", "PML_4")] + \
    [("tall_z", b) for b in ("MUR_1", "PEC", "PML_4")]


@pytest.mark.parametrize("kind,boundary", WALK_CASES)
def test_walk_one_rank_matches_jax_walk(kind, boundary):
    """The walk at one rank against the JAX package's single-device run and
    its ``use_kernel=False`` walk, at any Pz (131 here on ``tall_z``)."""
    tol = (RTOL, ATOL_REL) if kind == "tall_z" else (WALK_RTOL, WALK_ATOL_REL)
    run = build_explicit_run(port_sim(kind, boundary, 1), use_kernel=False)
    assert run.stepper.fused and not run.stepper.straddles
    out = run()
    for ref in jax_refs(kind, boundary, 1, use_kernel=False):
        assert_close_surface(out, ref, *tol)


@pytest.mark.parametrize("boundary", ["MUR", "PML_4"])
def test_walk_one_rank_equals_chunk_mode(boundary):
    """One rank's halo rows are out-of-domain rows that stay zero, so the
    walk does the chunk kernels' arithmetic on every owned cell: bit-equal,
    the probe sums too."""
    sim = port_sim("small", boundary, 1)
    out, ref = build_explicit_run(sim, use_kernel=False)(), sim.run()
    assert out["steps"] == ref["steps"] and out["e_ratio"] == ref["e_ratio"]
    for a, b in zip((*out["fields"], *out["state"]["psi_h"].values()),
                    (*ref["fields"], *ref["state"]["psi_h"].values()), strict=True):
        assert torch.equal(a, b)
    for key in ("uf", "if_"):
        np.testing.assert_array_equal(out[key], ref[key])


def test_walk_resumes_a_jax_walk_checkpoint():
    """A JAX walk checkpoint at step 60 resumes on the port's walk to the
    JAX package's uninterrupted walk."""
    half = jax_explicit("small", "PML_4", 1, use_kernel=False, n_steps=60)
    assert int(half["steps"]) == 60
    out = build_explicit_run(port_sim("small", "PML_4", 1), use_kernel=False)(
        resume_state=numpy_state(half["state"]))
    assert_close_surface(out, jax_refs("small", "PML_4", 1, use_kernel=False)[1],
                         WALK_RTOL, WALK_ATOL_REL)


def test_walk_one_rank_takes_the_fused_route(monkeypatch):
    """A one-rank MUR walk has no straddle: ``Walk.fused``, one
    ``e_update_mur`` call a step and no ``e_update`` or ``mur_faces``
    call; its outputs equal the JAX walk's as before."""
    calls = []
    twin = fdtd_cuda.e_update_mur

    def spy(ops, st, s):
        calls.append(s)
        twin(ops, st, s)

    def refused(*args):
        raise AssertionError("the fused route launches no e_update or mur_faces")

    monkeypatch.setattr(fdtd_cuda, "e_update_mur", spy)
    monkeypatch.setattr(fdtd_cuda, "e_update", refused)
    monkeypatch.setattr(fdtd_cuda, "mur_faces", refused)
    run = build_explicit_run(port_sim("small", "MUR", 1), use_kernel=False)
    assert run.stepper.fused
    out = run()
    assert len(calls) == int(out["steps"]) == 120
    assert_close_surface(out, jax_refs("small", "MUR", 1, use_kernel=False)[1],
                         WALK_RTOL, WALK_ATOL_REL)

