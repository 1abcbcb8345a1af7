"""The interval stepper: the D = ``probe_decim`` steps of one probe
interval per CUDA launch, with no probes.

Counterpart of ``build_pallas_stepper`` in
``fdtd_solver_antennas_tpu/ops/fdtd_pallas.py`` (the TPU kernel K4), the
per-interval MUR/PEC stepper that the chunk kernel (K1) replaced in the
JAX package's run loop. Its contract is its own: ``step_fn(fields6,
wf_chunk)`` advances the six fields by D leapfrog steps (H, then E with
ca/cb and the port-source FMA ``src·wf[d]``, then the MUR walls x → y → z
or nothing under PEC) and samples nothing.

- :func:`build_stepper`: the operands on a device and
  ``(step_fn, to_flat, from_flat)``. In the port's plain (x, y, z) layout
  ``to_flat``/``from_flat`` are identities; the TPU's 128-lane layout and
  its roll wrap do not carry over, nor do its ``Pz ≤ 128`` limit and its
  ``alias`` switch. CPML raises ``ValueError``, as in the JAX builder.
- :func:`interval_steps`: ``len(wf)`` steps of a :class:`YeeState` in one
  launch of ``csrc/fdtd_steps.cu`` (2 grid barriers a step, the MUR walls
  fused into the E pass; the storage form, resident or streamed, picked
  from the shape by :func:`launch_plan`, see ``ops/persist.py``); on a
  CPU tensor :func:`interval_steps_plain`, the same steps as K1's plain
  ``leapfrog_step``. A CUDA tensor always goes to the kernel; a failed
  plan, build or launch raises.

``launches`` counts kernel launches, as ``fdtd_cuda.launches`` does for
K1, and ``launches_by_form`` the same launches by storage form.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from . import fdtd_cuda, persist
from .fdtd import resolve_device
from .fdtd_cuda import (ProbeTable, YeeOperands, YeeState, _on_cuda, _ptr,
                        _stream)

KERNELS = ("interval_steps",)

# kernel launches per wrapper; only the wrapper's CUDA branch adds to it
launches: Dict[str, int] = dict.fromkeys(KERNELS, 0)
# the same launches by storage form (``persist.FORMS``)
launches_by_form: Dict[str, int] = dict.fromkeys(persist.FORMS, 0)


def reset_launch_counts() -> None:
    for k in KERNELS:
        launches[k] = 0
    for k in persist.FORMS:
        launches_by_form[k] = 0


def build_stepper(sim, inv_p, inv_d, mur_coef, device=None):
    """The interval stepper of ``sim`` on ``device`` (default
    ``sim.device``: the card unless the simulation was built on the CPU).

    ``inv_p``, ``inv_d`` and ``mur_coef`` are the host copies of
    ``sim._aux``: per-axis spacing profiles and the MUR coefficients
    ``((x0, x1), (y0, y1), (z0, z1))``. ca/cb and the source stamps come
    from ``sim.operands``. Returns ``(step_fn, to_flat, from_flat)``:
    ``step_fn(fields, wf_chunk)`` returns six new ``(Px, Py, Pz)`` float32
    tensors ``(Ex, Ey, Ez, Hx, Hy, Hz)``, the given six advanced by the D
    samples of ``wf_chunk`` (a sequence, or a float32 tensor on the
    device), and leaves its inputs as they were, as the JAX stepper does.
    """
    if sim.cfg.pml_cells() > 0:
        raise ValueError("the interval stepper supports MUR/PEC boundaries only")
    mur = sim.cfg.boundary.upper().startswith("MUR")
    if mur and mur_coef is None:
        raise ValueError("a MUR simulation needs its MUR coefficients")
    D = int(sim.probe_decim)
    dev = resolve_device(device) if device is not None else sim.device
    base = sim.operands
    shape = tuple(sim.padded_shape)

    def to_dev(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    ops = YeeOperands(
        shape=shape,
        grid_shape=tuple(sim.grid.shape),
        dtmu=base.dtmu,
        inv_p=tuple(to_dev(inv_p[a]) for a in range(3)),
        inv_d=tuple(to_dev(inv_d[a]) for a in range(3)),
        ca=tuple(t.to(dev) for t in base.ca),
        cb=tuple(t.to(dev) for t in base.cb),
        src=tuple(None if t is None else t.to(dev) for t in base.src),
        mur=tuple(tuple(float(c) for c in pair) for pair in mur_coef)
        if mur else None,
        pml=None,
        probes=ProbeTable.empty(dev),
    )

    def step_fn(fields, wf_chunk):
        fields = tuple(fields)
        if len(fields) != 6:
            raise ValueError(f"step_fn takes six fields, got {len(fields)}")
        for f in fields:
            if tuple(f.shape) != shape:
                raise ValueError(f"field shape {tuple(f.shape)} != {shape}")
        if len(wf_chunk) != D:
            raise ValueError(f"step_fn takes D = {D} samples, got {len(wf_chunk)}")
        # the kernel steps a copy; the second E buffer is new too
        st = YeeState(e=[tuple(f.clone() for f in fields[:3]),
                         tuple(torch.empty_like(f) for f in fields[:3])],
                      h=tuple(f.clone() for f in fields[3:]))
        interval_steps(ops, st, wf_chunk)
        return st.fields

    return step_fn, _identity, _identity


def _identity(a: torch.Tensor) -> torch.Tensor:
    """The port keeps fields in the (x, y, z) layout the kernel takes."""
    return a


# ---------------------------------------------------------------------------
# plain PyTorch twin (the CPU path, and the reference on the card)
# ---------------------------------------------------------------------------

def interval_steps_plain(ops: YeeOperands, st: YeeState, wf) -> None:
    """``len(wf)`` leapfrog steps: K1's plain ``leapfrog_step`` with the
    source sample ``wf[d]`` at step d."""
    samples = wf.tolist() if torch.is_tensor(wf) else [float(s) for s in wf]
    for s in samples:
        fdtd_cuda.leapfrog_step(fdtd_cuda.plain, ops, st, s)


# ---------------------------------------------------------------------------
# CUDA launch
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_PREFIX = "fdtd_steps"


class _StepsArgs(ctypes.Structure):
    """Field-for-field mirror of ``struct StepsArgs`` in csrc/fdtd_steps.cu."""

    _fields_ = [("o", persist.PersistOps)]


_lib = None


def _library():
    """Build (first use) and bind the kernel library."""
    global _lib
    if _lib is None:
        from . import _build

        lib = _build.load("fdtd_steps")
        persist.bind(lib, _PREFIX)
        lib.fdtd_steps_interval.argtypes = [_P, ctypes.c_int, ctypes.c_int, _P,
                                            ctypes.c_int, ctypes.c_int, _P]
        lib.fdtd_steps_interval.restype = ctypes.c_int
        lib.fdtd_steps_barriers.argtypes = [ctypes.c_int, ctypes.c_int,
                                            ctypes.c_int, _P]
        lib.fdtd_steps_barriers.restype = ctypes.c_int
        if lib.fdtd_steps_args_size() != ctypes.sizeof(_StepsArgs):
            raise RuntimeError(
                f"StepsArgs layout mismatch: C {lib.fdtd_steps_args_size()} "
                f"bytes, ctypes {ctypes.sizeof(_StepsArgs)}")
        _lib = lib
    return _lib


def grid_blocks() -> int:
    """Blocks the card keeps resident at once for the streamed form, the
    most any launch uses (one launch must hold every block)."""
    return persist.grid_blocks(_library(), _PREFIX, "interval_steps")


def _cuda_args(ops: YeeOperands, st: YeeState) -> _StepsArgs:
    """The packed kernel arguments of (ops, st), built once per pair and
    kept on the state; the kernel updates the state's tensors in place,
    so the pointers stay valid across launches."""
    cached = st._steps
    if cached is not None and cached[0] is ops:
        return cached[1]
    if ops.pml is not None:
        raise ValueError("the interval stepper supports MUR/PEC boundaries only")
    a = _StepsArgs()
    a.o = persist.pack(ops, st, (0, ops.grid_shape[0] - 1))
    st._steps = (ops, a)
    return a


def launch_plan(ops: YeeOperands, st: YeeState,
                form: Optional[str] = None) -> persist.Plan:
    """The storage form, blocks × threads and shared bytes the kernel
    launches with for (ops, st): ``form`` None lets the shape pick (the
    resident form where the operands fit on chip), else "resident" or
    "streamed"."""
    a = _cuda_args(ops, st)
    return persist.plan(_library(), _PREFIX, ops, ctypes.addressof(a), form,
                        "interval_steps")


def interval_steps(ops: YeeOperands, st: YeeState, wf: Sequence[float], *,
                   form: Optional[str] = None) -> None:
    """Advance a state by ``len(wf)`` leapfrog steps in one launch;
    ``wf[d]`` is the source sample of step d (a sequence, or a float32
    tensor on the state's device, which is read in place). The kernel
    updates the state's tensors in place; ``st.parity`` names the E
    buffer that holds the result. ``form`` forces a storage form
    (:func:`launch_plan`); the CPU runs the plain twin whatever it says."""
    if len(wf) < 1:
        raise ValueError("interval_steps takes at least one sample")
    if not _on_cuda(st.h[0]):
        return interval_steps_plain(ops, st, wf)
    lib = _library()
    a = _cuda_args(ops, st)
    plan = launch_plan(ops, st, form)
    samples = torch.as_tensor(wf, dtype=torch.float32, device=ops.device)
    d = samples.numel()
    code = lib.fdtd_steps_interval(ctypes.addressof(a), st.parity, d,
                                   _ptr(samples, (d,), dev=ops.device),
                                   plan.cells_per_thread, plan.blocks,
                                   _stream(ops.device))
    persist.check(lib, _PREFIX, code, "interval_steps")
    launches["interval_steps"] += 1
    launches_by_form[plan.form] += 1
    st.parity ^= d & 1


def grid_barriers(plan: persist.Plan, n: int) -> None:
    """One cooperative launch of a plan's blocks × threads that runs ``n``
    grid barriers and nothing else, on the current stream: the floor under
    a launch of n/2 steps by that plan (a measuring tool, not a step of any
    path; not counted)."""
    lib = _library()
    dev = torch.device("cuda", torch.cuda.current_device())
    code = lib.fdtd_steps_barriers(plan.blocks, plan.threads, n, _stream(dev))
    persist.check(lib, _PREFIX, code, "grid_barriers")
