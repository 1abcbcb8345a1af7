"""The JAX package's side of the explicit-path tests: its simulations of
the scenes in ``_explicit_ranks.py`` and its explicit run on a mesh of
the first n virtual CPU devices, with the shard kernel in interpret mode."""

import functools

import jax
import numpy as np

from fdtd_solver_antennas_tpu.models.scene import Scene
from fdtd_solver_antennas_tpu.ops.fdtd import FDTDConfig, build_simulation
from fdtd_solver_antennas_tpu.ops.mesh import MeshBuilder
from fdtd_solver_antennas_tpu.parallel import (
    build_explicit_run,
    make_device_mesh,
    shard_simulation,
)

from _explicit_ranks import build_kwargs, controls, scene


def jax_sim(kind, boundary, n_dev, **ctl):
    sc, grid = scene(MeshBuilder, Scene, kind)
    cfg = FDTDConfig(use_pallas=False, **controls(boundary, **ctl))
    return build_simulation(sc, grid, cfg=cfg, **build_kwargs(n_dev))


def jax_explicit(kind, boundary, n_dev, resume_state=None, use_kernel=True,
                 **ctl):
    """The JAX package's explicit run; ``use_kernel=False`` is its XLA
    per-step walk."""
    mesh = make_device_mesh((n_dev,), ("x",), devices=jax.devices()[:n_dev])
    run = build_explicit_run(jax_sim(kind, boundary, n_dev, **ctl), mesh,
                             use_kernel=use_kernel)
    return run(resume_state=resume_state)


@functools.lru_cache(maxsize=None)
def jax_refs(kind, boundary, n_dev, ctl=(), use_kernel=True):
    """(single-device run, explicit run) of the JAX package; ``ctl`` as
    sorted (key, value) pairs."""
    ctl = dict(ctl)
    return (jax_sim(kind, boundary, n_dev, **ctl).run(),
            jax_explicit(kind, boundary, n_dev, use_kernel=use_kernel, **ctl))


def numpy_state(state) -> dict:
    """A JAX state as numpy arrays."""
    return {k: (tuple(np.asarray(f) for f in v) if k == "fields" else
                {kk: np.asarray(vv) for kk, vv in v.items()}
                if isinstance(v, dict) else np.asarray(v))
            for k, v in state.items()}


@functools.lru_cache(maxsize=None)
def jax_sharded(kind, boundary, shape, pad, ctl=()):
    """(single-device run, ``sim.run()`` after ``shard_simulation`` on a
    mesh of ``shape`` over the first virtual devices, axes x and y) of the
    JAX package, the simulation padded to ``pad``; ``ctl`` as sorted
    (key, value) pairs."""
    ctl = dict(ctl)
    n = int(np.prod(shape))
    mesh = make_device_mesh(shape, ("x", "y")[:len(shape)],
                            devices=jax.devices()[:n])
    sim = jax_sim(kind, boundary, pad, **ctl)
    return (jax_sim(kind, boundary, pad, **ctl).run(),
            shard_simulation(sim, mesh).run())
