"""Geometry sweeps spread over the ranks of a process group.

Counterpart of ``fdtd_solver_antennas_tpu/parallel/sweep_shard.py``. The
JAX package shards the batch axis of a sweep's stacked coefficients over a
``"sweep"`` mesh axis, so each device group runs its share of the
variants inside the one vmapped program, optionally with each variant's x
split over a second ``"x"`` axis. Here the mesh is the ranks of a
``torch.distributed`` process group laid out as ``("sweep", "x")`` (a
``sharding.RankMesh``), and :func:`shard_sweep` keeps on each rank the
variants of its sweep group:

- ``n_spatial`` 1: the group's share runs through ``ops/fdtd.py::
  run_batched`` on this rank's card (K1 batched, or K2 batched in stream
  mode);
- ``n_spatial`` > 1: each variant of the share runs through the explicit
  path (``build_explicit_run``, the slab kernels) on the group's
  sub-communicator, as the JAX package splits the stacks' x over the
  group. Where the grid's x does not divide into the group (sweep grids
  are not padded), every rank of the group runs the share through
  ``run_batched`` instead, as the JAX package then leaves x unsplit.

Then ONE ``all_gather`` over the ranks collects every variant's ``uf``,
``if_``, ``nf_e``, ``nf_h``, ``steps``, ``e_ratio`` and ``e_max`` (a few
KB a variant; the variants share nothing while they run), and every rank
holds the whole sweep's results. A batch that does not divide the sweep
axis is padded by repeating the last variant; the padded rows are
dropped before post-processing. A run over several cards (NCCL) has not
been tried yet.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .sharding import RankMesh, default_group, group_size


def make_sweep_mesh(n_sweep: Optional[int] = None, n_spatial: int = 1,
                    group=None) -> RankMesh:
    """The ranks of ``group`` (default: the initialized default group, or
    one rank) as a mesh with axes ``("sweep", "x")``: row s is a sweep
    group of ``n_spatial`` ranks. ``n_sweep × n_spatial`` must be the rank
    count (``ValueError`` otherwise); by default every rank is on the
    sweep axis. With ``n_spatial`` > 1 every rank of the default group
    must call this (``dist.new_group`` builds each row's
    sub-communicator)."""
    group = default_group(group)
    n = group_size(group)
    if n_sweep is None:
        n_sweep = n // n_spatial
    if n_sweep * n_spatial != n:
        raise ValueError(f"mesh {n_sweep}×{n_spatial} != {n} ranks")
    ranks = np.arange(n).reshape(n_sweep, n_spatial)
    spatial = None
    if n_spatial > 1:
        me = dist.get_rank(group)
        for row in ranks:
            sub = dist.new_group([dist.get_global_rank(group, int(r))
                                  for r in row])
            if me in row:
                spatial = sub
    return RankMesh(ranks, ("sweep", "x"), group, spatial)


def pad_batch(n: int, n_sweep: int) -> Tuple[int, int]:
    """(padded_B, pad) so the batch divides the sweep axis. Padded slots
    replay the last variant and are trimmed from results."""
    padded = int(math.ceil(n / n_sweep)) * n_sweep
    return padded, padded - n


def share_rows(n: int, mesh: RankMesh) -> List[int]:
    """The variants (indices into the ``n`` real ones) of this rank's
    sweep group, the padded slots as the last variant."""
    padded, _pad = pad_batch(n, mesh.shape[0])
    share = padded // mesh.shape[0]
    s = mesh.coords()[0]
    return [min(i, n - 1) for i in range(s * share, (s + 1) * share)]


def shard_sweep(prepared, mesh: RankMesh):
    """Shard a ``SweepPrepared`` over ``mesh`` in place (returns it): its
    batched coefficients keep only the variants of this rank's sweep
    group (the batch padded by repeating the last variant), and
    ``_sweep_pad`` and ``_sweep_mesh`` are set, so ``run_*_sweep`` runs
    the share and gathers every variant's results on every rank."""
    if prepared.batched_coeffs is None:
        raise ValueError("prepare a sweep before sharding it")
    if prepared._sweep_mesh is not None:
        raise ValueError("this sweep is sharded already")
    _padded, pad = pad_batch(len(prepared.variants), mesh.shape[0])
    rows = share_rows(len(prepared.variants), mesh)
    prepared.batched_coeffs = {k: v[rows] for k, v in
                               prepared.batched_coeffs.items()}
    prepared._sweep_pad = pad
    prepared._sweep_mesh = mesh
    return prepared


def trim_sweep_out(prepared, out):
    """Drop the padded batch rows from a sharded sweep's raw output (its
    arrays with ``len(variants) + pad`` rows; lists of them too). The
    ``run_*`` post-processing reads only the real variants, so this is
    needed only when consuming ``out`` directly."""
    pad = prepared._sweep_pad
    if not pad:
        return out
    b = len(prepared.variants)

    def trim(a):
        if isinstance(a, list):
            return [trim(x) for x in a]
        if getattr(a, "ndim", 0) >= 1 and a.shape[0] == b + pad:
            return a[:b]
        return a

    return {k: trim(v) for k, v in out.items()}


def _variant_sim(sim, coeffs, b: int):
    """``sim`` with variant ``b``'s coefficients (the explicit path cuts
    its slabs from their host copies, made at its first read)."""
    return dataclasses.replace(sim, _coeffs_host=None,
                               coeffs={k: v[b] for k, v in coeffs.items()})


def _explicit_share(sim, coeffs, group) -> dict:
    """Each variant of the share through the explicit path over ``group``,
    stacked as ``run_batched`` returns its outputs."""
    from .explicit import build_explicit_run

    outs = [build_explicit_run(_variant_sim(sim, coeffs, b), group)()
            for b in range(next(iter(coeffs.values())).shape[0])]
    return dict(
        uf=np.stack([o["uf"] for o in outs]),
        if_=np.stack([o["if_"] for o in outs]),
        nf_e=[np.stack(f) for f in zip(*(o["nf_e"] for o in outs))],
        nf_h=[np.stack(f) for f in zip(*(o["nf_h"] for o in outs))],
        steps=np.array([o["steps"] for o in outs], np.int64),
        e_ratio=np.array([o["e_ratio"] for o in outs], np.float32),
        e_max=np.array([o["state"]["e_max"] for o in outs], np.float32),
        fields=tuple(torch.stack(f) for f in zip(*(o["fields"] for o in outs))),
    )


# the gathered outputs, in the order they are packed
_GATHERED = ("uf", "if_", "nf_e", "nf_h", "steps", "e_ratio", "e_max")


def _pack(out, share: int) -> np.ndarray:
    """One (share, L) float64 row per variant of ``out`` (complex as its
    real and imaginary parts)."""
    cols = []
    for key in _GATHERED:
        for a in (out[key] if isinstance(out[key], list) else [out[key]]):
            a = np.asarray(a).reshape(share, -1)
            cols += [a.real, a.imag] if np.iscomplexobj(a) else [a]
    return np.concatenate([c.astype(np.float64) for c in cols], axis=1)


def _unpack(rows: np.ndarray, like) -> dict:
    """:func:`_pack` undone on ``rows`` (B, L), shapes and dtypes from
    ``like`` (the rank's own output)."""
    out, off = {}, 0

    def take(a):
        nonlocal off
        a = np.asarray(a)
        size = int(np.prod(a.shape[1:]))
        parts = []
        for _ in range(2 if np.iscomplexobj(a) else 1):
            parts.append(rows[:, off:off + size].reshape((-1,) + a.shape[1:]))
            off += size
        v = parts[0] + 1j * parts[1] if len(parts) == 2 else parts[0]
        return v.astype(a.dtype)

    for key in _GATHERED:
        v = like[key]
        out[key] = [take(a) for a in v] if isinstance(v, list) else take(v)
    return out


def run_sweep_share(prepared, impl=None):
    """The sharded sweep's run: this rank's share (see the module's
    docstring), then one ``all_gather`` of every variant's results.
    Returns ``(out, wall_s, max_steps)`` as ``solvers/sweep.py::
    _run_batched`` does: ``out`` has every variant, padded rows included
    (:func:`trim_sweep_out` drops them), and ``fields`` (six (share, X,
    Y, Z) tensors) and ``rows`` (their variants) of this rank's share
    only. The wall is the whole sweep's, the slowest share's, the same on
    every rank."""
    from ..ops.fdtd import run_batched

    mesh, sim = prepared._sweep_mesh, prepared.sim
    coeffs = prepared.batched_coeffs
    n_sweep, n_spatial = mesh.shape
    share = next(iter(coeffs.values())).shape[0]
    Px = sim.padded_shape[0]
    t0 = time.perf_counter()
    if n_spatial > 1 and Px % n_spatial == 0 and Px // n_spatial >= 2:
        out = _explicit_share(sim, coeffs, mesh.spatial)
    else:
        out = run_batched(sim, coeffs, impl)
    wall = time.perf_counter() - t0
    mine = np.concatenate([_pack(out, share).ravel(), [wall]])
    dev = sim.device
    sent = torch.from_numpy(mine).to(dev)
    if mesh.group is not None:
        got = [torch.empty_like(sent) for _ in range(mesh.size)]
        dist.all_gather(got, sent, group=mesh.group)
    else:
        got = [sent]
    got = np.stack([g.cpu().numpy() for g in got])
    wall = float(got[:, -1].max())
    # row s of the mesh: its first rank's share
    rows = np.concatenate([got[int(mesh.ranks[s, 0]), :-1].reshape(share, -1)
                           for s in range(n_sweep)])
    full = _unpack(rows, out)
    full["fields"] = out["fields"]
    full["rows"] = share_rows(len(prepared.variants), mesh)
    return full, wall, int(np.max(full["steps"]))
