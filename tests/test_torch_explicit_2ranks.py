"""The port's explicit run over 2 gloo ranks against the JAX package.

One ``torch.multiprocessing.spawn`` of a gloo process group of 2 ranks
(a ``file://`` store in the test's temporary directory, one intra-op
thread per rank) runs every job of this file in turn: MUR, PEC and PML_4
on the scene of ``tests/test_sharding.py::_build`` padded to
``(2, 1, 1)``, and a run resumed from a JAX explicit checkpoint. Each run is held to the JAX package's single-device
run and to its explicit run on a 2-device mesh with the shard kernel in
interpret mode, at the JAX package's own explicit-path tolerance
(rtol 1e-3, atol 1e-4·max|ref|, ``tests/test_sharding.py:92-98``).
MUR_1, PEC and PML_4 at z = 131 (``tall_z``: K2's slab stepper, T = 6
under PEC, else 4, with a remainder window) are held to the JAX
package's single-device run and its explicit XLA walk on a 2-device mesh
at rtol 2e-4, atol 1e-5·max|ref|; PML_4 at z = 131 also to its ``shard=``
stream kernel in interpret mode on that mesh (the ψ halos restocked each
launch). The per-step walk (``use_kernel=False``: K1's per-step kernels'
twins on a slab with one halo row a side, the halos exchanged every
half-step) runs MUR, PEC and PML_4 on the same scene, MUR_1 at z = 131
and a resume from a JAX walk checkpoint, held to the JAX package's
single-device run and its walk on a 2-device mesh at the same tolerances.
"""

import pytest

from _explicit_jax import jax_explicit, jax_refs, numpy_state
from _explicit_ranks import assert_close_surface, spawn_runs

RTOL, ATOL_REL = 1e-3, 1e-4
TALL_RTOL, TALL_ATOL_REL = 2e-4, 1e-5
TALL = ("MUR_1", "PEC", "PML_4")
WORLD = 2
CTL = dict(n_steps=60, check_every=30)  # two chunks of 3 probe intervals


def _refs(kind, boundary, ctl=CTL):
    return jax_refs(kind, boundary, WORLD, tuple(sorted(ctl.items())))


@pytest.fixture(scope="module")
def outs(tmp_path_factory):
    """The port's output surface of every job, from one spawn."""
    jobs = {b: ("small", b, CTL, None) for b in ("MUR", "PEC", "PML_4")}
    half = jax_explicit("small", "MUR", WORLD, **dict(CTL, n_steps=30))
    jobs["resume"] = ("small", "MUR", CTL, numpy_state(half["state"]))
    jobs.update({f"tall {b}": ("tall_z", b, CTL, None) for b in TALL})
    walk = {"use_kernel": False}
    jobs.update({f"walk {b}": ("small", b, CTL, None, walk)
                 for b in ("MUR", "PEC", "PML_4")})
    jobs["walk tall MUR_1"] = ("tall_z", "MUR_1", CTL, None, walk)
    half = jax_explicit("small", "PML_4", WORLD, use_kernel=False,
                        **dict(CTL, n_steps=30))
    jobs["walk resume"] = ("small", "PML_4", CTL, numpy_state(half["state"]),
                           walk)
    return spawn_runs(tmp_path_factory.mktemp("ranks"), WORLD, jobs)


@pytest.mark.parametrize("boundary", ["MUR", "PEC", "PML_4"])
def test_ranks_match_jax_single_device_and_explicit(outs, boundary):
    out = outs[boundary]
    assert out["fields"][0].shape == (22, 21, 21)
    for ref in _refs("small", boundary):
        assert_close_surface(out, ref, RTOL, ATOL_REL)


def test_ranks_resume_a_jax_explicit_checkpoint(outs):
    assert_close_surface(outs["resume"], _refs("small", "MUR")[1], RTOL,
                         ATOL_REL)


@pytest.mark.parametrize("boundary", TALL)
def test_tall_z_ranks_match_jax_single_device_and_walk(outs, boundary):
    out = outs[f"tall {boundary}"]
    assert out["fields"][0].shape == (16, 16, 131)
    for ref in jax_refs("tall_z", boundary, WORLD, tuple(sorted(CTL.items())),
                        use_kernel=False):
        assert_close_surface(out, ref, TALL_RTOL, TALL_ATOL_REL)


def test_tall_z_pml_ranks_match_the_jax_shard_stream_kernel(outs):
    """The port's slab march under CPML over 2 ranks (ψ restocked with
    the halos) against the JAX package's ``shard=`` stream kernel, the
    kernel it ports, on a 2-device mesh."""
    ref = jax_explicit("tall_z", "PML_4", WORLD, **CTL)
    assert_close_surface(outs["tall PML_4"], ref, TALL_RTOL, TALL_ATOL_REL)


def _walk_refs(kind, boundary):
    return jax_refs(kind, boundary, WORLD, tuple(sorted(CTL.items())),
                    use_kernel=False)


@pytest.mark.parametrize("boundary", ["MUR", "PEC", "PML_4"])
def test_walk_ranks_match_jax_walk_and_single_device(outs, boundary):
    out = outs[f"walk {boundary}"]
    assert out["fields"][0].shape == (22, 21, 21)
    for ref in _walk_refs("small", boundary):
        assert_close_surface(out, ref, RTOL, ATOL_REL)


def test_walk_tall_z_ranks_match_jax_walk(outs):
    for ref in _walk_refs("tall_z", "MUR_1"):
        assert_close_surface(outs["walk tall MUR_1"], ref, TALL_RTOL,
                             TALL_ATOL_REL)


def test_walk_ranks_resume_a_jax_walk_checkpoint(outs):
    assert_close_surface(outs["walk resume"], _walk_refs("small", "PML_4")[1],
                         RTOL, ATOL_REL)
