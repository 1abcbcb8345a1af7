"""Explicit multi-device FDTD on ``torch.distributed``: x-slabs and halos.

Counterpart of ``fdtd_solver_antennas_tpu/parallel/explicit.py``. The JAX
package's 1-D device mesh becomes a process group of ``n_dev`` ranks;
rank r owns the grid rows ``[r·n, (r+1)·n)``, ``n = Px // n_dev``, and
keeps them in a slab with W halo rows per side. Its three per-shard paths
are the port's routes (``use_kernel``):

- **K3's slab stepper** (None or True, Pz ≤ 128, ``fdtd_shard.MAX_PZ``):
  ``ops/fdtd_shard.py``, K steps a launch, W = K or K + 1;
- **K2's slab stepper** (None or True, Pz > 128): the counterpart of its
  ``shard=`` stream kernel (``ops/fdtd_stream.py::
  build_stream_shard_stepper``), T steps a launch, W = T + 1, the march
  under MUR, PEC and CPML;
- **the per-step walk** (False; the JAX package's XLA step, its default
  off the TPU): W = 1 and any Pz. Each leapfrog step is K1's per-step
  kernels on the slab (``fdtd_cuda.h_update``, ``e_update``,
  ``mur_faces``; their plain twins on the CPU), with JAX's exchanges
  between them: before H the (Ey, Ez) of the first owned row come from
  the +x neighbour into the upper halo, before E the (Hy, Hz) of the last
  owned row from the −x neighbour into the lower halo; after E, when the
  top MUR wall Qx − 1 is a rank's first row, the old and new (Ey, Ez) of
  row Qx − 2 come from the rank before into the lower halo (JAX's
  ``straddle_top``), then the walls x (at the slab's ``mur_x_rows``), y,
  z. A rank that takes part in no straddle (every rank under PEC and
  CPML, every one-rank walk) runs the E half-step and the three axes'
  walls as one launch, ``fdtd_cuda.e_update_mur`` (``Walk.fused``): two
  launches a step. ψ is not exchanged: it is elementwise given the
  halo-extended differences. :func:`build_walk_run` runs the same walk
  over an x × y grid of ranks (``parallel/sharding.py::shard_simulation``
  on a 2-axis mesh): one halo plane per split axis, (Ez, Ex) from +y
  before H and (Hz, Hx) from −y before E, the y walls at the block's
  ``mur_y_rows`` and a y straddle after the x walls. The curl reads no
  diagonal neighbour, so no corner is exchanged.

Per probe interval of D steps the slab kernels make ``D // K`` launches
of K steps and one of ``D % K`` when that is not 0, with ONE halo restock
after each (the W boundary rows of the six fields, and the twelve ψ under
CPML, stacked into one buffer per neighbour, both ways through
``dist.batch_isend_irecv``); the walk makes D steps. Edge ranks have no
outer neighbour; their outer halo stays zero, as zero coefficients keep
out-of-domain rows. Then the probes are sampled on the slab with K1's
``probe_gather`` and a slab-local table whose rows not owned by the rank
weigh 0, so each rank's DFT sums are partial sums.

Per chunk, the energy of the owned rows takes one ``all_reduce`` and one
host sync; at the end the partial DFT sums take one ``all_reduce``, a
resumed checkpoint's totals are added once, and the owned rows of every
rank are gathered into a canonical ``(Px, Py, Pz)`` state that resumes
either package. ``group=None`` is one rank and no collectives. A run over
several cards (NCCL) has not been tried yet.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch
import torch.distributed as dist

from ..ops import fdtd_cuda, fdtd_shard, fdtd_stream
from ..ops.fdtd import (
    ProbeDFT,
    _assemble_output,
    _to_numpy,
    chunk_geometry,
    padded_waveform,
    resolve_device,
    resume_decim_scale,
)
from ..ops.fdtd_cuda import PSI_KEYS
from .sharding import group_size

_ACC_KEYS = ("uf", "if_", "nf_e", "nf_h")


def _peer(group, rank):
    return None if rank is None else dist.get_global_rank(group, rank)


def _swap(group, moves) -> None:
    """One ``dist.batch_isend_irecv`` for every ``(peer, send, recv)`` of
    ``moves``: ``send`` a preallocated buffer to send (or None), ``recv``
    one to receive into (or None), each from and to the global rank
    ``peer``."""
    ops = []
    for peer, send, recv in moves:
        if send is not None:
            ops.append(dist.P2POp(dist.isend, send, peer, group))
        if recv is not None:
            ops.append(dist.P2POp(dist.irecv, recv, peer, group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()


class _HaloExchange:
    """Restocks a slab's halos from its neighbours, in place: the state's
    tensors keep their storage, so the kernels' packed pointers stay
    valid."""

    def __init__(self, sh: fdtd_shard.ShardStepper, group):
        self.sh, self.group = sh, group
        r, n_dev = sh.rank, sh.n_dev
        self.up = _peer(group, r + 1 if r + 1 < n_dev else None)
        self.down = _peer(group, r - 1 if r > 0 else None)
        n_arrays = 6 + (12 if sh.ops.pml is not None else 0)
        shape = (n_arrays, sh.W) + tuple(sh.ops.shape[1:])

        def buf():
            return torch.empty(shape, dtype=torch.float32, device=sh.ops.device)

        self.send_up, self.recv_up = buf(), buf()
        self.send_down, self.recv_down = buf(), buf()

    def restock(self, st: fdtd_cuda.YeeState) -> None:
        W, n = self.sh.W, self.sh.n
        arrs = (*st.e[st.parity], *st.h, *st.psi_e, *st.psi_h)
        moves = []
        if self.up is not None:  # my top owned rows → its lower halo
            torch.stack([a[n:n + W] for a in arrs], out=self.send_up)
            moves.append((self.up, self.send_up, self.recv_up))
        if self.down is not None:  # my first owned rows → its upper halo
            torch.stack([a[W:2 * W] for a in arrs], out=self.send_down)
            moves.append((self.down, self.send_down, self.recv_down))
        _swap(self.group, moves)
        for i, a in enumerate(arrs):
            if self.up is not None:
                a[W + n:].copy_(self.recv_up[i])
            if self.down is not None:
                a[:W].copy_(self.recv_down[i])


class _Slab:
    """The slab kernels' route: a probe interval is D // K launches of K
    steps and one of D % K, each followed by one halo restock."""

    def __init__(self, sh, slab_steps, group, decim):
        self.sh, self.ops, self.steps = sh, sh.ops, slab_steps
        self.n_ranks = sh.n_dev
        self.owned, self.rows = (sh.owned,), (sh.rows,)
        self.split = (sh.n_dev, 1)
        self.halo = _HaloExchange(sh, group) if sh.n_dev > 1 else None
        self.windows = [sh.K] * (decim // sh.K) + ([sh.rem] if sh.rem else [])

    def new_state(self):
        return self.sh.new_state()

    def restock(self, st) -> None:
        if self.halo is not None:
            self.halo.restock(st)

    def advance(self, st, wf, n: int) -> int:
        for k in self.windows:
            self.steps(self.ops, st, wf[n:n + k])
            n += k
            self.restock(st)
        return n


class _Plane:
    """Plane ``index`` of ``axis`` (0: x, 1: y) of a few of a state's
    tensors, and a preallocated buffer that stacks them."""

    def __init__(self, axis, index, shape, k, device):
        self.axis, self.index = axis, index
        plane = tuple(s for a, s in enumerate(shape) if a != axis)
        self.buf = torch.empty((k,) + plane, dtype=torch.float32, device=device)

    def pack(self, arrs):
        torch.stack([a.select(self.axis, self.index) for a in arrs],
                    out=self.buf)
        return self.buf

    def unpack(self, arrs):
        for a, b in zip(arrs, self.buf):
            a.select(self.axis, self.index).copy_(b)


class Walk:
    """One rank's block of the per-step walk over an ``(sx, sy)`` grid of
    ranks (group rank g at ``(g // sy, g % sy)``): ``nx = Px / sx`` owned
    rows with one halo row per side, and, when y is split, ``ny = Py / sy``
    owned y-planes with one halo plane per side. ``ops`` is the block's
    (``fdtd_shard.slab_operands``); a probe interval is D leapfrog steps
    of K1's per-step kernels with the halo planes exchanged between the
    half-steps (see the module's docstring)."""

    def __init__(self, sim, group, split, coords, device):
        sx, sy = split
        cx, cy = coords
        Px, Py, _Pz = sim.padded_shape
        nx = fdtd_shard.owned_rows(Px, sx)
        if Py % sy or Py // sy < 2:
            raise ValueError(
                f"padded y extent {Py} does not split into {sy} blocks of >= 2 "
                f"planes; build the simulation with pad_multiple=(., {sy}, 1)")
        ny = Py // sy
        Wy = 1 if sy > 1 else 0
        self.group, self.split, self.coords = group, (sx, sy), (cx, cy)
        self.n_ranks = sx * sy
        self.decim = int(sim.probe_decim)
        self.ops = fdtd_shard.slab_operands(
            sim, cx, nx, 1, device, y=(cy, ny, 1) if sy > 1 else None)
        self.owned = (slice(1, 1 + nx), slice(Wy, Wy + ny))
        self.rows = (slice(cx * nx, (cx + 1) * nx), slice(cy * ny, (cy + 1) * ny))
        shape, dev = self.ops.shape, self.ops.device

        def rank(x, y):
            return _peer(group, x * sy + y) if 0 <= x < sx and 0 <= y < sy else None

        # per split axis: the neighbours above and below, the planes each
        # exchange packs and fills, and the two components tangential to
        # the axis (the ones the curl differentiates along it, and the MUR
        # walls of that axis update)
        self.axes = []
        Qx, Qy = sim.grid.shape[:2]
        mur = self.ops.mur is not None
        for axis, (s, c, n, W, Q) in enumerate(((sx, cx, nx, 1, Qx),
                                                 (sy, cy, ny, Wy, Qy))):
            if s == 1:
                continue
            up = rank(cx + 1, cy) if axis == 0 else rank(cx, cy + 1)
            down = rank(cx - 1, cy) if axis == 0 else rank(cx, cy - 1)
            first, last = W, W + n - 1

            def plane(index, k, axis=axis):
                return _Plane(axis, index, shape, k, dev)

            self.axes.append(SimpleNamespace(
                axis=axis, up=up, down=down,
                tang=tuple(m for m in range(3) if m != axis),
                # before H: my first owned plane down, its first into my top
                e_send=plane(first, 2), e_recv=plane(last + 1, 2),
                # before E: my last owned plane up, its last into my bottom
                h_send=plane(last, 2), h_recv=plane(first - 1, 2),
                # the top wall Q − 1 on a block's first plane: the old and
                # new E of plane Q − 2 from the block before, after E
                straddle_recv=(plane(first - 1, 4)
                               if mur and c > 0 and c * n == Q - 1 else None),
                straddle_send=(plane(last, 4)
                               if mur and up is not None
                               and (c + 1) * n - 1 == Q - 2 else None),
            ))
        # the axes whose straddle this rank takes part in, by axis
        self.straddles = {ax.axis: ax for ax in self.axes
                          if ax.straddle_send or ax.straddle_recv}
        # no straddle: E and the walls of all three axes in one launch. A
        # rank in a straddle sends or receives plane Q − 2 as the walls of
        # the earlier axes alone leave it, so it keeps a launch per axis.
        self.fused = not self.straddles

    def new_state(self):
        return fdtd_cuda.new_state(self.ops.shape, self.ops.device,
                                   self.ops.pml is not None)

    def restock(self, st) -> None:
        """Nothing: every halo plane a pass reads is exchanged before it."""

    def _halves(self, st, kind) -> None:
        """The halo planes the next half-step reads: E from above before
        H (``kind`` "e"), H from below before E ("h")."""
        moves, fills = [], []
        for ax in self.axes:
            if kind == "e":
                arrs = [st.e[st.parity][m] for m in ax.tang]
                src, dst, to, frm = ax.e_send, ax.e_recv, ax.down, ax.up
            else:
                arrs = [st.h[m] for m in ax.tang]
                src, dst, to, frm = ax.h_send, ax.h_recv, ax.up, ax.down
            if to is not None:
                moves.append((to, src.pack(arrs), None))
            if frm is not None:
                moves.append((frm, None, dst.buf))
                fills.append((dst, arrs))
        _swap(self.group, moves)
        for dst, arrs in fills:
            dst.unpack(arrs)

    def _straddle(self, st, ax) -> None:
        """Old and new E tangential to the wall, of the plane below the
        block's first, from the block before (JAX's ``straddle_top``)."""
        arrs = [st.e[p][m] for p in (st.parity, 1 - st.parity) for m in ax.tang]
        moves = []
        if ax.straddle_send is not None:
            moves.append((ax.up, ax.straddle_send.pack(arrs), None))
        if ax.straddle_recv is not None:
            moves.append((ax.down, None, ax.straddle_recv.buf))
        _swap(self.group, moves)
        if ax.straddle_recv is not None:
            ax.straddle_recv.unpack(arrs)

    def step(self, st, s: float) -> None:
        """One leapfrog step of the block: K1's per-step kernels on CUDA
        tensors (their plain twins on the CPU), the exchanges between."""
        ops = self.ops
        self._halves(st, "e")
        fdtd_cuda.h_update(ops, st)
        self._halves(st, "h")
        if self.fused:
            fdtd_cuda.e_update_mur(ops, st, s)
        else:
            fdtd_cuda.e_update(ops, st, s)
            for axis in range(3):
                if axis in self.straddles:
                    self._straddle(st, self.straddles[axis])
                fdtd_cuda.mur_faces(ops, st, axis)
        st.parity ^= 1

    def advance(self, st, wf, n: int) -> int:
        for s in wf[n:n + self.decim]:
            self.step(st, s)
        return n + self.decim


def _build_run(sim, part, group, dev):
    """``run(resume_state=None)`` of the per-chunk loop over ``part`` (a
    :class:`_Slab` or a :class:`Walk`): the two routes differ only in how
    ``part.advance`` steps a probe interval."""
    decim, n_sub, _chunk, _n_chunks = chunk_geometry(sim)
    collective = part.n_ranks > 1
    sx, sy = part.split

    def all_reduce(t):
        if collective:
            dist.all_reduce(t, group=group)
        return t

    def gather(t):
        """This rank's owned block of every rank → (Px, Py, Pz)."""
        own = t[part.owned]
        if not collective:
            return own.clone()
        parts = [torch.empty_like(own) for _ in range(part.n_ranks)]
        dist.all_gather(parts, own.contiguous(), group=group)
        return torch.cat([torch.cat(parts[x * sy:(x + 1) * sy], dim=1)
                          for x in range(sx)])

    def lift(st, rs):
        """A canonical checkpoint's owned cells into the block; halos from
        the neighbours."""
        def put(dst, a):
            rows = np.array(_to_numpy(a)[part.rows], np.float32)
            dst[part.owned].copy_(torch.from_numpy(rows))

        for dst, a in zip(st.fields, rs["fields"]):
            put(dst, a)
        if part.ops.pml is not None and rs.get("psi_e"):
            for dst, k in zip(st.psi_e, PSI_KEYS):
                put(dst, rs["psi_e"][k])
            for dst, k in zip(st.psi_h, PSI_KEYS):
                put(dst, rs["psi_h"][k])
        part.restock(st)

    def run(resume_state=None):
        cfg = sim.cfg
        f32 = dict(dtype=torch.float32, device=dev)
        ops = part.ops
        st = part.new_state()
        probes = ProbeDFT(sim, n_sub, dev)
        n, e_max, ratio, resumed = 0, torch.zeros((), **f32), 1.0, None
        if resume_state is not None:
            rs = sim._adapt_resume_arrays(resume_state)
            lift(st, rs)
            # the checkpoint's DFT totals join the sums once, after the
            # final reduction (partial sums are linear)
            scale = np.float32(resume_decim_scale(rs, decim))
            resumed = {k: np.asarray(_to_numpy(rs[k]), np.float32) * scale
                       for k in _ACC_KEYS}
            n = int(_to_numpy(rs["n"]))
            e_max.fill_(float(np.float32(_to_numpy(rs["e_max"]))))
            ratio = float(np.float32(_to_numpy(rs["e_ratio"])))

        wf = padded_waveform(sim)
        end = np.float32(cfg.end_criteria)
        while n < cfg.n_steps_max:
            n0 = n
            for j in range(n_sub):
                n = part.advance(st, wf, n)
                fdtd_cuda.probe_gather(ops, st, probes.bufs[j])
            probes.flush(n0)

            # energy of the owned cells (halos are copies)
            energy = all_reduce(sum((e[part.owned] * e[part.owned]).sum()
                                    for e in st.e[st.parity]))
            e_max = torch.maximum(e_max, energy)
            r = torch.where(e_max > 0, energy / e_max, torch.ones((), **f32))
            ratio = float(r)  # the one host sync of the chunk
            if ratio < end and n > sim.n_source_steps:
                break

        acc = probes.acc
        flat = all_reduce(torch.cat([acc[k].reshape(-1) for k in _ACC_KEYS]))
        off = 0
        for k in _ACC_KEYS:
            size = acc[k].numel()
            acc[k] = flat[off:off + size].view(acc[k].shape)
            off += size
            if resumed is not None:
                acc[k] = acc[k] + torch.from_numpy(resumed[k]).to(dev)
        full = SimpleNamespace(
            fields=tuple(gather(f) for f in st.fields),
            psi_e=tuple(gather(p) for p in st.psi_e),
            psi_h=tuple(gather(p) for p in st.psi_h),
        )
        return _assemble_output(sim, full, acc, n, e_max, ratio, decim, False)

    return run


def _group_size(group):
    """(ranks, this rank's index) of ``group``; None is one rank."""
    return group_size(group), 0 if group is None else dist.get_rank(group)


def build_walk_run(sim, group=None, split=None, device=None):
    """Build ``run(resume_state=None)`` of the per-step walk for ``sim``
    split over the ranks of ``group`` (None: one rank, no collectives)
    laid out as an ``split = (sx, sy)`` grid, x × y (default: every rank
    along x), group rank g at ``(g // sy, g % sy)``.

    ``sim`` must have ``Px`` divisible by sx and ``Py`` by sy (build it
    with ``pad_multiple=(sx, sy, 1)``), at least 2 owned rows and planes a
    rank. Any Pz, any boundary. ``run`` returns the output surface of
    :func:`build_explicit_run` on every rank; ``run.stepper`` is the
    rank's :class:`Walk` and ``run.kernel_window`` None, as the JAX
    package's walk has no fused window."""
    n_ranks, rank = _group_size(group)
    sx, sy = split if split is not None else (n_ranks, 1)
    if sx * sy != n_ranks:
        raise ValueError(f"rank grid {sx}x{sy} != {n_ranks} ranks")
    dev = resolve_device(sim.device if device is None else device)
    walk = Walk(sim, group, (sx, sy), (rank // sy, rank % sy), dev)
    run = _build_run(sim, walk, group, dev)
    run.kernel_window = None
    run.stepper = walk
    return run


def build_explicit_run(sim, group=None, use_kernel=None, device=None,
                       k_steps=None):
    """Build ``run(resume_state=None)`` for ``sim`` split along x over the
    ranks of ``group`` (None: one rank, no collectives).

    ``sim`` must have ``Px`` divisible by the rank count (build it with
    ``pad_multiple=(n_dev, 1, 1)``). Only this rank's slab goes to
    ``device`` (default ``sim.device``); on a CUDA device every step is a
    kernel launch. ``run`` returns the output surface of
    ``PreparedSimulation.run`` (``uf``, ``if_``, ``nf_e``, ``nf_h``,
    ``steps``, ``e_ratio``, ``fields``, and a canonical ``(Px, Py, Pz)``
    ``state``) on every rank; ``run.kernel_window`` is K, the steps per
    launch and per halo exchange (None on the walk), and ``run.stepper``
    the slab stepper (the :class:`Walk` on the walk).

    ``use_kernel`` None or True takes the slab kernels: K3's at
    Pz ≤ ``fdtd_shard.MAX_PZ``, K2's above; False the per-step walk on
    K1's per-step kernels (:func:`build_walk_run` along x), at any Pz.
    ``k_steps`` overrides K of the slab kernels (K3: default
    ``min(n, D, 32)``; K2: the deepest T its kernels take, at most n − 1
    and D); the result does not depend on it. The walk has no K.
    """
    if use_kernel is False:
        if k_steps is not None:
            raise ValueError("k_steps sets the slab kernels' window; the "
                             "walk exchanges its halos every half-step")
        return build_walk_run(sim, group, device=device)
    Pz = sim.padded_shape[2]
    n_dev, rank = _group_size(group)
    dev = resolve_device(sim.device if device is None else device)
    if Pz > fdtd_shard.MAX_PZ:
        sh = fdtd_stream.build_stream_shard_stepper(sim, n_dev, rank, dev,
                                                    k_steps)
        slab_steps = fdtd_stream.stream_shard_steps
    else:
        sh = fdtd_shard.build_shard_stepper(sim, n_dev, rank, k_steps, dev)
        slab_steps = fdtd_shard.shard_steps
    run = _build_run(sim, _Slab(sh, slab_steps, group, int(sim.probe_decim)),
                     group, dev)
    run.kernel_window = sh.K
    run.stepper = sh
    return run
