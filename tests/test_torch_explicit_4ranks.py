"""The port's explicit run over 4 gloo ranks against the JAX package.

One ``torch.multiprocessing.spawn`` of a gloo process group of 4 ranks
(a ``file://`` store in the test's temporary directory, one intra-op
thread per rank) runs every job of this file in turn: MUR, PEC and PML_4
on the scene of ``tests/test_sharding.py::_build`` padded to
``(4, 1, 1)``, a straddle geometry (Qx = 13, Px = 16, n = 4:
the top MUR wall on a block's first row) and a checkpoint for the
JAX package to resume. Each run is held to the JAX package's single-device
run and to its explicit run on a 4-device mesh with the shard kernel in
interpret mode, at the JAX package's own explicit-path tolerance
(rtol 1e-3, atol 1e-4·max|ref|, ``tests/test_sharding.py:92-98``).
MUR_1, PEC and PML_4 at z = 131 (``tall_z``, n = 4: K2's slab stepper,
T = 3) and the straddle at z = 131 (``tall_straddle``: the top wall on
the last rank's first row, W = n = 4, so rank 1's lower halo starts on
the bottom wall) are held to the JAX package's single-device run and its
explicit XLA walk on a 4-device mesh at rtol 2e-4, atol 1e-5·max|ref|.
The per-step walk (``use_kernel=False``: K1's per-step kernels' twins,
the halos exchanged every half-step) runs MUR, PEC and PML_4 on the same
scene, MUR_1 at z = 131, the straddle (the top wall's inward neighbour
fetched from the rank before, JAX's ``straddle_top``) and the straddle
at z = 131, held to the JAX package's single-device run and its walk on
a 4-device mesh at the same tolerances. Each rank reports its walk's
route: the two ranks of a straddle (2 sends plane Qx − 2, 3 receives it)
keep ``e_update`` and a ``mur_faces`` per axis, every other rank fuses
them into ``e_update_mur``.
"""

import pytest

from _explicit_jax import jax_explicit, jax_refs
from _explicit_ranks import assert_close_surface, spawn_runs

RTOL, ATOL_REL = 1e-3, 1e-4
WORLD = 4
CTL = dict(n_steps=60, check_every=30)  # two chunks of 3 probe intervals
STRADDLE = dict(CTL, decim=4)  # K = 3, W = 4, remainder 1
TALL_RTOL, TALL_ATOL_REL = 2e-4, 1e-5
TALL = ("MUR_1", "PEC", "PML_4")


def _refs(kind, boundary, ctl=CTL):
    return jax_refs(kind, boundary, WORLD, tuple(sorted(ctl.items())))


@pytest.fixture(scope="module")
def outs(tmp_path_factory):
    """The port's output surface of every job, from one spawn."""
    jobs = {b: ("small", b, CTL, None) for b in ("MUR", "PEC", "PML_4")}
    jobs["straddle"] = ("straddle", "MUR", STRADDLE, None)
    jobs["half"] = ("small", "PML_4", dict(CTL, n_steps=30), None)
    jobs.update({f"tall {b}": ("tall_z", b, CTL, None) for b in TALL})
    jobs["tall straddle"] = ("tall_straddle", "MUR_1", STRADDLE, None)
    walk = {"use_kernel": False}
    jobs.update({f"walk {b}": ("small", b, CTL, None, walk)
                 for b in ("MUR", "PEC", "PML_4")})
    jobs["walk tall MUR_1"] = ("tall_z", "MUR_1", CTL, None, walk)
    jobs["walk straddle"] = ("straddle", "MUR", STRADDLE, None, walk)
    jobs["walk tall straddle"] = ("tall_straddle", "MUR_1", STRADDLE, None,
                                  walk)
    return spawn_runs(tmp_path_factory.mktemp("ranks"), WORLD, jobs)


@pytest.mark.parametrize("boundary", ["MUR", "PEC", "PML_4"])
def test_ranks_match_jax_single_device_and_explicit(outs, boundary):
    out = outs[boundary]
    assert out["fields"][0].shape == (24, 21, 21)
    for ref in _refs("small", boundary):
        assert_close_surface(out, ref, RTOL, ATOL_REL)


def test_straddle(outs):
    out = outs["straddle"]
    assert out["fields"][0].shape == (16, 16, 20)
    for ref in _refs("straddle", "MUR", STRADDLE):
        assert_close_surface(out, ref, RTOL, ATOL_REL)


def test_jax_explicit_resumes_a_ranks_checkpoint(outs):
    half = outs["half"]
    assert int(half["steps"]) == 30
    out = jax_explicit("small", "PML_4", WORLD, resume_state=half["state"], **CTL)
    assert_close_surface(out, _refs("small", "PML_4")[1], RTOL, ATOL_REL)


def _walk_refs(kind, boundary, ctl):
    return jax_refs(kind, boundary, WORLD, tuple(sorted(ctl.items())),
                    use_kernel=False)


@pytest.mark.parametrize("boundary", TALL)
def test_tall_z_ranks_match_jax_single_device_and_walk(outs, boundary):
    out = outs[f"tall {boundary}"]
    assert out["fields"][0].shape == (16, 16, 131)
    for ref in _walk_refs("tall_z", boundary, CTL):
        assert_close_surface(out, ref, TALL_RTOL, TALL_ATOL_REL)


def test_tall_straddle(outs):
    out = outs["tall straddle"]
    assert out["fields"][0].shape == (16, 16, 131)
    for ref in _walk_refs("tall_straddle", "MUR_1", STRADDLE):
        assert_close_surface(out, ref, TALL_RTOL, TALL_ATOL_REL)


@pytest.mark.parametrize("boundary", ["MUR", "PEC", "PML_4"])
def test_walk_ranks_match_jax_walk_and_single_device(outs, boundary):
    out = outs[f"walk {boundary}"]
    assert out["fields"][0].shape == (24, 21, 21)
    for ref in _walk_refs("small", boundary, CTL):
        assert_close_surface(out, ref, RTOL, ATOL_REL)


@pytest.mark.parametrize("kind,ctl,tol", [
    ("tall_z", CTL, (TALL_RTOL, TALL_ATOL_REL)),
    ("straddle", STRADDLE, (RTOL, ATOL_REL)),
    ("tall_straddle", STRADDLE, (TALL_RTOL, TALL_ATOL_REL))])
def test_walk_tall_and_straddle(outs, kind, ctl, tol):
    boundary = "MUR" if kind == "straddle" else "MUR_1"
    name = {"tall_z": "walk tall MUR_1", "straddle": "walk straddle",
            "tall_straddle": "walk tall straddle"}[kind]
    for ref in _walk_refs(kind, boundary, ctl):
        assert_close_surface(outs[name], ref, *tol)


@pytest.mark.parametrize("name,fused", [
    ("walk MUR", [True] * 4), ("walk PEC", [True] * 4),
    ("walk PML_4", [True] * 4), ("walk tall MUR_1", [True] * 4),
    ("walk straddle", [True, True, False, False]),
    ("walk tall straddle", [True, True, False, False])])
def test_walk_ranks_route_by_straddle(outs, name, fused):
    """``Walk.fused`` of ranks 0-3: false exactly on the sender and the
    receiver of the top x wall's straddle."""
    assert outs[name]["fused"].tolist() == fused
