"""Explicit multi-device FDTD on ``torch.distributed``: x-slabs and halos.

Counterpart of ``fdtd_solver_antennas_tpu/parallel/explicit.py`` on its
kernel routes (``use_kernel=True``). The JAX package's 1-D device mesh
becomes a process group of ``n_dev`` ranks; rank r owns the grid rows
``[r·n, (r+1)·n)``, ``n = Px // n_dev``, and keeps them in a slab with W
halo rows per side. The route is the JAX package's: at Pz ≤ 128
(``fdtd_shard.MAX_PZ``) K3's slab stepper (``ops/fdtd_shard.py``,
K steps a launch, W = K or K + 1), above it K2's
(``ops/fdtd_stream.py::build_stream_shard_stepper``, the counterpart of
its ``shard=`` stream kernel: T steps a launch, W = T + 1, the march
under MUR, PEC and CPML). Per probe interval of D
steps:

- ``D // K`` launches of the slab stepper of K steps, and one of
  ``D % K`` when that is not 0; after each launch ONE halo restock: the
  W boundary rows of the six fields (and the twelve ψ under CPML),
  stacked into one buffer per neighbour, go both ways with
  ``dist.batch_isend_irecv``. Edge ranks have no outer neighbour; their
  outer halo stays zero, as zero coefficients keep out-of-domain rows;
- the probes are sampled on the slab with K1's ``probe_gather`` and a
  slab-local table whose rows not owned by the rank weigh 0, so each
  rank's DFT sums are partial sums.

Per chunk, the energy of the owned rows takes one ``all_reduce`` and one
host sync; at the end the partial DFT sums take one ``all_reduce``, a
resumed checkpoint's totals are added once, and the owned rows of every
rank are gathered into a canonical ``(Px, Py, Pz)`` state that resumes
either package. ``group=None`` is one rank and no collectives.

Not ported (ROADMAP, queue A: the per-step walk): the JAX package's
per-step walk with ``use_kernel=False``. A run over several cards (NCCL)
has not been tried yet.
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

_ACC_KEYS = ("uf", "if_", "nf_e", "nf_h")


class _HaloExchange:
    """Restocks a slab's halos from its neighbours, in place: the state's
    tensors keep their storage, so the kernels' packed pointers stay
    valid."""

    def __init__(self, sh: fdtd_shard.ShardStepper, group):
        self.sh, self.group = sh, group
        r, n_dev = sh.rank, sh.n_dev
        self.up = dist.get_global_rank(group, r + 1) if r + 1 < n_dev else None
        self.down = dist.get_global_rank(group, r - 1) if r > 0 else None
        n_arrays = 6 + (12 if sh.ops.pml is not None else 0)
        shape = (n_arrays, sh.W) + tuple(sh.ops.shape[1:])

        def buf():
            return torch.empty(shape, dtype=torch.float32, device=sh.ops.device)

        self.send_up, self.recv_up = buf(), buf()
        self.send_down, self.recv_down = buf(), buf()

    def restock(self, st: fdtd_cuda.YeeState) -> None:
        W, n = self.sh.W, self.sh.n
        arrs = (*st.e[st.parity], *st.h, *st.psi_e, *st.psi_h)
        ops = []
        if self.up is not None:  # my top owned rows → its lower halo
            torch.stack([a[n:n + W] for a in arrs], out=self.send_up)
            ops += [dist.P2POp(dist.isend, self.send_up, self.up, self.group),
                    dist.P2POp(dist.irecv, self.recv_up, self.up, self.group)]
        if self.down is not None:  # my first owned rows → its upper halo
            torch.stack([a[W:2 * W] for a in arrs], out=self.send_down)
            ops += [dist.P2POp(dist.isend, self.send_down, self.down, self.group),
                    dist.P2POp(dist.irecv, self.recv_down, self.down, self.group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        for i, a in enumerate(arrs):
            if self.up is not None:
                a[W + n:].copy_(self.recv_up[i])
            if self.down is not None:
                a[:W].copy_(self.recv_down[i])


def build_explicit_run(sim, group=None, use_kernel=None, device=None,
                       k_steps=None):
    """Build ``run(resume_state=None)`` for ``sim`` split along x over the
    ranks of ``group`` (None: one rank, no collectives).

    ``sim`` must have ``Px`` divisible by the rank count (build it with
    ``pad_multiple=(n_dev, 1, 1)``). Only this rank's slab goes to
    ``device`` (default ``sim.device``); on a CUDA device every step is a
    launch of the slab stepper's kernel. ``run`` returns the output surface of
    ``PreparedSimulation.run`` (``uf``, ``if_``, ``nf_e``, ``nf_h``,
    ``steps``, ``e_ratio``, ``fields``, and a canonical ``(Px, Py, Pz)``
    ``state``) on every rank; ``run.kernel_window`` is K, the steps per
    launch and per halo exchange, and ``run.stepper`` the slab stepper.

    ``use_kernel`` None or True takes the slab kernels: K3's at
    Pz ≤ ``fdtd_shard.MAX_PZ``, K2's above; False (the JAX package's
    per-step walk) raises ``NotImplementedError``. ``k_steps`` overrides
    K (K3: default ``min(n, D, 32)``; K2: the deepest T its kernels take,
    at most n − 1 and D); the result does not depend on it.
    """
    if use_kernel is False:
        raise NotImplementedError(
            "use_kernel=False (the per-step walk of the JAX explicit path) "
            "is not ported; see ROADMAP, queue A: the per-step walk")
    Pz = sim.padded_shape[2]
    n_dev = 1 if group is None else dist.get_world_size(group)
    rank = 0 if group is None else dist.get_rank(group)
    dev = resolve_device(sim.device if device is None else device)
    if Pz > fdtd_shard.MAX_PZ:
        sh = fdtd_stream.build_stream_shard_stepper(sim, n_dev, rank, dev,
                                                    k_steps)
        slab_steps = fdtd_stream.stream_shard_steps
    else:
        sh = fdtd_shard.build_shard_stepper(sim, n_dev, rank, k_steps, dev)
        slab_steps = fdtd_shard.shard_steps
    halo = _HaloExchange(sh, group) if n_dev > 1 else None
    decim, n_sub, _chunk, _n_chunks = chunk_geometry(sim)
    windows = [sh.K] * (decim // sh.K) + ([sh.rem] if sh.rem else [])
    has_pml = sh.ops.pml is not None

    def all_reduce(t):
        if halo is not None:
            dist.all_reduce(t, group=group)
        return t

    def gather(t):
        """This rank's owned rows of every rank → (Px, Py, Pz)."""
        own = t[sh.owned]
        if halo is None:
            return own.clone()
        parts = [torch.empty_like(own) for _ in range(n_dev)]
        dist.all_gather(parts, own.contiguous(), group=group)
        return torch.cat(parts)

    def lift(st, rs):
        """A canonical checkpoint's owned rows into the slab; halos from
        the neighbours."""
        def put(dst, a):
            rows = np.array(_to_numpy(a)[sh.rows], np.float32)
            dst[sh.owned].copy_(torch.from_numpy(rows))

        for dst, a in zip(st.fields, rs["fields"]):
            put(dst, a)
        if has_pml and rs.get("psi_e"):
            for dst, k in zip(st.psi_e, PSI_KEYS):
                put(dst, rs["psi_e"][k])
            for dst, k in zip(st.psi_h, PSI_KEYS):
                put(dst, rs["psi_h"][k])
        if halo is not None:
            halo.restock(st)

    def run(resume_state=None):
        cfg = sim.cfg
        f32 = dict(dtype=torch.float32, device=dev)
        ops = sh.ops
        st = sh.new_state()
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
                for k in windows:
                    slab_steps(ops, st, wf[n:n + k])
                    n += k
                    if halo is not None:
                        halo.restock(st)
                fdtd_cuda.probe_gather(ops, st, probes.bufs[j])
            probes.flush(n0)

            # energy of the owned rows (halos are copies)
            energy = all_reduce(sum((e[sh.owned] * e[sh.owned]).sum()
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

    run.kernel_window = sh.K
    run.stepper = sh
    return run
