"""Spatial decomposition of a run over the ranks of a process group.

Counterpart of ``fdtd_solver_antennas_tpu/parallel/sharding.py``. The JAX
package annotates the fields and coefficients with a ``NamedSharding``
over a device mesh and lets XLA's SPMD partitioner insert the halo
exchanges, so ``sim.run()`` itself runs sharded over x, or over x and y.
The port has no partitioner: a mesh here is the ranks of a
``torch.distributed`` process group laid out as a grid (a
:class:`RankMesh`), and :func:`shard_simulation` marks the simulation so
that its ``run()`` goes through the explicit path with its exchanges
written out (``parallel/explicit.py``):

- an x mesh (or an x × y mesh with one y block): ``build_explicit_run`` on
  its default route, K3's slab stepper at Pz ≤ 128 and K2's above;
- an x × y mesh: the per-step walk over the grid of ranks
  (``build_walk_run``) on K1's per-step kernels, one halo plane per split
  axis.

Every rank gets the full output surface, as the JAX package's
``sim.run()`` returns it. A run over several cards (NCCL) has not been
tried yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch.distributed as dist


@dataclasses.dataclass(frozen=True, eq=False)
class RankMesh:
    """The ranks of ``group`` as a grid: ``ranks[i, j]`` is the group rank
    at mesh position (i, j), row-major (``np.arange(size).reshape(shape)``).
    ``group`` None is one rank without a process group. ``spatial`` is the
    sub-communicator of this rank's row of a sweep mesh
    (``parallel/sweep_shard.py``), None elsewhere."""

    ranks: np.ndarray
    axis_names: Tuple[str, ...]
    group: object = None
    spatial: object = None

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.ranks.shape)

    @property
    def size(self) -> int:
        return int(self.ranks.size)

    def coords(self) -> Tuple[int, ...]:
        """This rank's position in the mesh."""
        me = 0 if self.group is None else dist.get_rank(self.group)
        return tuple(int(c) for c in np.argwhere(self.ranks == me)[0])


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def default_group(group=None):
    """``group``, else the default process group when one is initialized,
    else None (one rank)."""
    if group is not None:
        return group
    if dist.is_available() and dist.is_initialized():
        return dist.group.WORLD
    return None


def make_device_mesh(shape: Optional[Tuple[int, ...]] = None,
                     axis_names: Sequence[str] = ("x",),
                     group=None) -> RankMesh:
    """The ranks of ``group`` (default: the initialized default group, or
    one rank) as a mesh of ``shape`` with axes ``axis_names``, ``("x",)``
    or ``("x", "y")``. ``shape`` defaults to every rank along the first
    axis; a shape that does not cover the ranks raises ``ValueError``."""
    axis_names = tuple(axis_names)
    if not 1 <= len(axis_names) <= 2:
        raise ValueError(f"axis_names {axis_names}: one or two spatial axes")
    group = default_group(group)
    n = group_size(group)
    if shape is None:
        shape = (n,) + (1,) * (len(axis_names) - 1)
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} for axes {axis_names}")
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {shape} does not cover {n} ranks")
    return RankMesh(np.arange(n).reshape(shape), axis_names, group)


def field_partition_spec(mesh: RankMesh) -> Tuple[Optional[str], ...]:
    """Which axes of a (Px, Py, Pz) field are split, as the JAX package's
    ``PartitionSpec``: x over the first mesh axis, y over the second when
    it has more than one rank, z never."""
    names = mesh.axis_names
    if len(names) >= 2 and mesh.shape[1] > 1:
        return (names[0], names[1], None)
    return (names[0], None, None)


def _split(mesh: RankMesh) -> Tuple[int, int]:
    """(x blocks, y blocks) of ``mesh``'s field partition."""
    spec = field_partition_spec(mesh)
    return mesh.shape[0], (mesh.shape[1] if spec[1] is not None else 1)


def shard_fields(arrays, mesh: RankMesh):
    """This rank's block of every (Px, Py, Pz) tensor or array in
    ``arrays`` (a tensor, an array, or dicts, lists and tuples of them),
    split as :func:`field_partition_spec` says; anything that is not 3-D
    is left as it is. An extent that the mesh does not divide raises
    ``ValueError``."""
    sx, sy = _split(mesh)
    cx = mesh.coords()[0]
    cy = mesh.coords()[1] if sy > 1 else 0

    def block(a):
        if isinstance(a, dict):
            return {k: block(v) for k, v in a.items()}
        if isinstance(a, (list, tuple)):
            return type(a)(block(v) for v in a)
        if getattr(a, "ndim", 0) != 3:
            return a
        X, Y = a.shape[:2]
        if X % sx or Y % sy:
            raise ValueError(f"{tuple(a.shape)} does not split into {sx}x{sy} "
                             "blocks; pad the simulation to the mesh")
        nx, ny = X // sx, Y // sy
        return a[cx * nx:(cx + 1) * nx, cy * ny:(cy + 1) * ny]

    return block(arrays)


def shard_simulation(sim, mesh: RankMesh):
    """Mark ``sim`` so that ``sim.run()`` runs SPMD over ``mesh`` (in
    place; returns ``sim``): every rank of the mesh's group calls
    ``run()`` and gets the full output surface. The padded extents must
    divide into the mesh's blocks of at least 2 rows (build the
    simulation with ``pad_multiple=(sx, sy, 1)``)."""
    sx, sy = _split(mesh)
    Px, Py, _Pz = sim.padded_shape
    if Px % sx or Px // sx < 2 or Py % sy or Py // sy < 2:
        raise ValueError(
            f"padded shape {sim.padded_shape} does not split into {sx}x{sy} "
            f"blocks of >= 2 rows; build it with pad_multiple=({sx}, {sy}, 1)")
    sim.field_sharding = mesh
    return sim


def sharded_run(sim, resume_state=None, progress_cb=None) -> dict:
    """``sim.run()`` of a simulation marked by :func:`shard_simulation`:
    the explicit path over the mesh, built for this call (so it takes the
    simulation's current source stamps). ``progress_cb(steps, n_steps_max,
    e_ratio)`` is called once at the end; an exception it raises is
    ignored."""
    from .explicit import build_explicit_run, build_walk_run

    mesh = sim.field_sharding
    sx, sy = _split(mesh)
    if sy == 1:
        run = build_explicit_run(sim, mesh.group)
    else:
        run = build_walk_run(sim, mesh.group, (sx, sy))
    out = run(resume_state)
    if progress_cb is not None:
        try:
            progress_cb(out["steps"], out["steps"], out["e_ratio"])
        except Exception:
            pass  # a broken UI callback must not kill the run
    return out


def sharded_step_fn(sim, mesh: RankMesh):
    """Shard ``sim`` over ``mesh`` and return it, as the JAX package's
    ``sharded_step_fn`` does for its multi-chip dry run."""
    shard_simulation(sim, mesh)
    return sim
