"""K1's chunk stepper, ``chunk_steps``, and the engine's chunk loop, on the CPU.

``chunk_steps_kernel`` (``csrc/fdtd_chunk.cu``) runs a whole termination
chunk in one cooperative launch: n_sub probe intervals of D steps of the
persistent steppers' H and E passes (``csrc/yee_persist.cuh``), then the
probe gather of every row after each interval. The kernel runs only on the
card (``tests/test_torch_cuda.py`` holds it to its twin there). Here:

- its schedule, transcribed into NumPy (:func:`emulate_chunk`, on the E
  pass of ``tests/test_torch_persist.py``), is held bit for bit to the
  plain twin ``chunk_steps_plain``: the intervals, the gather after the E
  barrier (E after the flip, H as the last H pass left it), the parity
  flip, the source read at offset n0 with zeros past the waveform, and a
  start at parity 1, under MUR, PEC and PML_4 on grids cut so that walls,
  corners and probe rows on the faces occur;
- the port's chunk route is held to the JAX package's chunk kernel (K1)
  in interpret mode under MUR, PEC and PML_4 at rtol 2e-4, atol
  1e-5·max|ref| (the JAX package's own kernel-vs-XLA tolerance);
- the engine calls ``chunk_steps`` once per chunk in chunk mode and
  ``stream_steps`` and ``probe_gather`` in stream mode.
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from _explicit_ranks import port_sim
from fdtd_solver_antennas_tpu_torch.models.scene import Scene
from fdtd_solver_antennas_tpu_torch.ops import fdtd_cuda, fdtd_stream, persist
from fdtd_solver_antennas_tpu_torch.ops.fdtd import (
    FDTDConfig,
    build_simulation,
    padded_waveform,
    run_simulation,
)
from fdtd_solver_antennas_tpu_torch.ops.mesh import MeshBuilder
from fdtd_solver_antennas_tpu.models.scene import Scene as JScene
from fdtd_solver_antennas_tpu.ops.fdtd import FDTDConfig as JConfig
from fdtd_solver_antennas_tpu.ops.fdtd import build_simulation as jbuild
from fdtd_solver_antennas_tpu.ops.mesh import MeshBuilder as JMeshBuilder
from test_torch_engine import _FREQS, _scene
from test_torch_engine import _port_sim as _engine_sim
from test_torch_persist import GRIDS, _Kernel, _np, _operands, _random_state

f32 = np.float32


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Test workers share the cores (pytest-xdist)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the kernel's schedule in NumPy
# ---------------------------------------------------------------------------

def _gather(ops, E, H):
    """``gather_rows``: block by block, each row's terms m = 0 .. k−1
    summed in order, the cell and component decoded from each code."""
    fields = [a.ravel() for a in (*E, *H)]
    out = np.zeros(ops.probes.n_rows, f32)
    for r0, rows, k, code, w in ops.probes.blocks():
        code, w = code.numpy(), w.numpy()
        acc = np.zeros(rows, f32)
        for m in range(k):
            vals = np.array([fields[c & 7][c >> 3] for c in code[m]], f32)
            acc = acc + vals * w[m]
        out[r0:r0 + rows] = acc
    return out


def emulate_chunk(ops, st, wf, n0, n_sub, D, layout=None):
    """``chunk_steps_kernel`` from ``st`` in NumPy: returns ((E, H, ψ_e,
    ψ_h), samples (n_sub, rows)). ``layout`` as in ``emulate_steps``."""
    kern = _Kernel(ops, (0, ops.grid_shape[0] - 1))
    E = [_np(e) for e in st.e[st.parity]]
    H = [_np(h) for h in st.h]
    psi_e = [_np(p) for p in st.psi_e]
    psi_h = [_np(p) for p in st.psi_h]
    out = np.full((n_sub, ops.probes.n_rows), np.nan, f32)
    for j in range(n_sub):
        for s in range(D):
            kern.h_pass(E, H, psi_h)
            E = kern.e_pass(E, H, psi_e, wf[n0 + j * D + s], layout)
        out[j] = _gather(ops, E, H)  # after the E barrier and the flip
    return (E, H, psi_e, psi_h), out


def _assert_chunk_equals(st, bufs, got):
    (E, H, psi_e, psi_h), out = got
    ref = (*st.e[st.parity], *st.h, *st.psi_e, *st.psi_h)
    for i, (a, b) in enumerate(zip((*E, *H, *psi_e, *psi_h), ref, strict=True)):
        assert not np.isnan(a).any(), f"array {i}: a cell was never written"
        np.testing.assert_array_equal(a, b.numpy(), err_msg=f"array {i}")
    assert not np.isnan(out).any()
    np.testing.assert_array_equal(out, bufs.numpy())


def _with_probes(ops, seed, widths=(3, 1, 5, 2)):
    """``ops`` with a random probe table of four blocks of the given
    widths: rows on each corner of every component's array and on a cell
    of each face (the first block), random rows, and zero-weight padding
    on the last rows of each block."""
    rng = np.random.default_rng(seed)
    shape = ops.shape
    n = int(np.prod(shape))
    cells = [np.ravel_multi_index((i, j, kk), shape)
             for i in (0, shape[0] - 1) for j in (0, shape[1] - 1)
             for kk in (0, shape[2] - 1)]
    for axis in range(3):
        for side in (0, shape[axis] - 1):
            x = [s // 2 for s in shape]
            x[axis] = side
            cells.append(np.ravel_multi_index(tuple(x), shape))
    fixed = [c * n + cell for c in range(6) for cell in cells]
    blocks = []
    for b, k in enumerate(widths):
        rows = (len(fixed) if b == 0 else 0) + 9 + 4 * b
        idx = rng.integers(0, 6 * n, (rows, k))
        if b == 0:
            idx[:len(fixed), 0] = fixed
        w = rng.uniform(-1.0, 1.0, (rows, k)).astype(f32)
        w[-3:, -1] = 0.0
        blocks.append((idx, w))
    return dataclasses.replace(
        ops, probes=fdtd_cuda.ProbeTable.from_blocks(blocks, n))


def _waveform(n0, n_sub, D, seed, tail_zeros):
    """Seeded samples for the steps before ``n0 + n_sub·D − tail_zeros``,
    then zeros: the padding a chunk past ``n_steps_max`` reads."""
    wf = np.zeros(n0 + n_sub * D + 5, f32)
    live = n0 + n_sub * D - tail_zeros
    wf[:live] = np.random.default_rng(seed).uniform(-1.0, 1.0, live)
    return wf


# (n0, n_sub, D, start parity): a first chunk; a resumed odd one at
# parity 1 that runs past the waveform's last sample into the zeros
CHUNKS = [(0, 2, 2, 0), (5, 2, 3, 1)]


@pytest.mark.parametrize("n0,n_sub,D,parity", CHUNKS)
@pytest.mark.parametrize("layout", [None, (3, 64)])
@pytest.mark.parametrize("shape,grid_shape", GRIDS)
@pytest.mark.parametrize("boundary", ["MUR", "PEC", "PML_4"])
def test_chunk_schedule_equals_the_twin(boundary, shape, grid_shape, layout,
                                        n0, n_sub, D, parity):
    ops = _with_probes(_operands(shape, grid_shape, boundary, seed=sum(shape)),
                       seed=n0 + D)
    st = _random_state(shape, boundary == "PML_4", seed=7 + parity)
    st.parity = parity
    wf = _waveform(n0, n_sub, D, seed=D, tail_zeros=2 * parity)
    got = emulate_chunk(ops, st, wf, n0, n_sub, D, layout)
    bufs = torch.full((n_sub, ops.probes.n_rows), float("nan"))
    fdtd_cuda.chunk_steps_plain(ops, st, torch.from_numpy(wf), n0, n_sub, D,
                                bufs)
    assert st.parity == parity ^ (n_sub * D) & 1
    _assert_chunk_equals(st, bufs, got)


@pytest.mark.parametrize("kind,boundary", [
    ("straddle", "MUR"), ("straddle", "PEC"), ("small", "PML_4")])
def test_chunk_schedule_on_a_scene(kind, boundary):
    """The operands and probe table (ports, Huygens faces) of a real scene,
    resumed at parity 1, two intervals of three steps."""
    sim = port_sim(kind, boundary, 1, decim=3)
    ops = sim.operands
    st = _random_state(sim.padded_shape, boundary == "PML_4", seed=23)
    st.parity = 1
    wf = torch.tensor(padded_waveform(sim), dtype=torch.float32)
    n0, n_sub, D = 40, 2, 3
    got = emulate_chunk(ops, st, wf.numpy(), n0, n_sub, D, (7, 640))
    bufs = torch.zeros((n_sub, ops.probes.n_rows))
    fdtd_cuda.chunk_steps(ops, st, wf, n0, n_sub, D, bufs)
    assert st.parity == 1 ^ 6 & 1
    _assert_chunk_equals(st, bufs, got)


def test_gather_sums_terms_in_the_kernels_order():
    """``probe_gather_plain`` sums m = 0 .. k−1, one rounding each: the
    order that makes a sum of large terms differ from other orders."""
    ops = _operands((4, 3, 3), (4, 3, 3), "PEC", seed=1)
    st = fdtd_cuda.new_state((4, 3, 3), "cpu", pml=False)
    st.e[0][0].view(-1)[:3] = torch.tensor([1e8, 1.0, -1e8])
    one = [(np.zeros((0, 0)), np.zeros((0, 0)))] * 3
    ops = dataclasses.replace(ops, probes=fdtd_cuda.ProbeTable.from_blocks(
        [(np.array([[0, 1, 2]]), np.ones((1, 3)))] + one, 36))
    out = torch.zeros(1)
    fdtd_cuda.probe_gather_plain(ops, st, out)
    assert out.item() == 0.0  # (1e8 + 1) − 1e8 in float32
    got = _gather(ops, [_np(e) for e in st.e[0]], [_np(h) for h in st.h])
    np.testing.assert_array_equal(got, out.numpy())


# ---------------------------------------------------------------------------
# the wrapper on the CPU
# ---------------------------------------------------------------------------

def test_wrapper_runs_the_twin_on_cpu_and_counts_no_launch():
    """On CPU tensors ``chunk_steps`` is the plain twin, and so is the
    per-step route (``step_kernels``); no launch is counted."""
    sim = port_sim("small", "PML_4", 1, decim=3)
    ops = sim.operands
    wf = torch.tensor(padded_waveform(sim), dtype=torch.float32)
    rows = ops.probes.n_rows
    outs = []
    fdtd_cuda.reset_launch_counts()
    for fn in (fdtd_cuda.chunk_steps, fdtd_cuda.chunk_steps_plain,
               fdtd_cuda.step_kernels.chunk_steps):
        st = _random_state(sim.padded_shape, True, seed=29)
        bufs = torch.zeros((2, rows))
        fn(ops, st, wf, 9, 2, 3, bufs)
        outs.append((st.fields + st.psi_e + st.psi_h, bufs))
    for fields, bufs in outs[1:]:
        for a, b in zip(fields, outs[0][0], strict=True):
            assert torch.equal(a, b)
        assert torch.equal(bufs, outs[0][1])
    assert fdtd_cuda.launches == dict.fromkeys(fdtd_cuda.KERNELS, 0)
    assert fdtd_cuda.launches_by_form == dict.fromkeys(persist.FORMS, 0)


def test_wrapper_checks_its_window_and_buffers():
    sim = port_sim("straddle", "MUR", 1, decim=3)
    ops = sim.operands
    st = fdtd_cuda.new_state(sim.padded_shape, "cpu", pml=False)
    rows = ops.probes.n_rows
    wf = torch.zeros(20)
    with pytest.raises(ValueError, match="past the waveform"):
        fdtd_cuda.chunk_steps(ops, st, wf, 15, 2, 3, torch.zeros((2, rows)))
    with pytest.raises(ValueError, match="bufs"):
        fdtd_cuda.chunk_steps(ops, st, wf, 0, 2, 3, torch.zeros((3, rows)))
    with pytest.raises(ValueError, match="n_sub"):
        fdtd_cuda.chunk_steps(ops, st, wf, 0, 0, 3, torch.zeros((0, rows)))
    meta = fdtd_cuda.new_state(sim.padded_shape, "meta", pml=False)
    with pytest.raises(ValueError, match="meta"):
        fdtd_cuda.chunk_steps(ops, meta, wf, 0, 2, 3, torch.zeros((2, rows)))


# ---------------------------------------------------------------------------
# the chunk route against the JAX package's K1 in interpret mode
# ---------------------------------------------------------------------------

def _close(a, b, rtol=2e-4):
    """rtol 2e-4, atol 1e-5·max|ref|; 3-D arrays on their common region
    (the JAX package may pad its kernel's grid; pad cells stay zero)."""
    a = a.numpy() if torch.is_tensor(a) else np.asarray(a)
    b = np.asarray(b)
    if a.ndim == 3 and a.shape != b.shape:
        sl = tuple(slice(0, min(x, y)) for x, y in zip(a.shape, b.shape))
        a, b = a[sl], b[sl]
    atol = 1e-5 * max(float(np.abs(b).max()), 1e-20)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


@pytest.mark.parametrize("boundary", ["MUR", "PEC", "PML_4"])
def test_chunk_route_matches_tpu_chunk_kernel_interpret_mode(boundary):
    """Two chunks of 15 intervals of D = 3 steps (45 steps a chunk, so the
    second starts at parity 1): fields, ψ, uf, if_, nf_e and nf_h."""
    kw = dict(n_steps_max=90, check_every=45, end_criteria=1e-30,
              boundary=boundary, probe_decimation=3)
    scene, grid = _scene(JMeshBuilder, JScene)
    jsim = jbuild(scene, grid, f0=2.45e9, fc=1.225e9,
                  cfg=JConfig(use_pallas=True, **kw), **_FREQS)
    assert jsim.pallas_mode == "chunk" and jsim.probe_decim == 3
    ref = jsim.run()
    scene, grid = _scene(MeshBuilder, Scene)
    sim = build_simulation(scene, grid, f0=2.45e9, fc=1.225e9,
                           cfg=FDTDConfig(**kw), device="cpu", **_FREQS)
    assert sim.pallas_mode == "chunk" and sim.probe_decim == 3
    out = run_simulation(sim, fdtd_cuda.kernels)
    assert int(ref["steps"]) == out["steps"] == 90
    for fa, fb in zip(out["fields"], ref["fields"], strict=True):
        _close(fa, fb)
    for grp in ("psi_e", "psi_h"):
        assert set(out["state"][grp]) == set(ref["state"][grp])
        for k, v in ref["state"][grp].items():
            _close(out["state"][grp][k], v)
    for key in ("uf", "if_"):
        _close(out[key], ref[key])
    for key in ("nf_e", "nf_h"):
        for a, b in zip(out[key], ref[key], strict=True):
            _close(a, b)


# ---------------------------------------------------------------------------
# the engine's routing
# ---------------------------------------------------------------------------

def _spy(impl):
    """``impl`` with every entry point recorded as (name, n0 or None)."""
    calls = []

    def wrap(name, fn):
        def call(*args):
            calls.append((name, args[3] if name == "chunk_steps" else None))
            return fn(*args)
        return call

    return SimpleNamespace(**{k: wrap(k, v) for k, v in vars(impl).items()}), calls


def test_chunk_mode_calls_chunk_steps_once_per_chunk():
    sim = _engine_sim("MUR", n_steps=120, check_every=40)
    assert sim.pallas_mode == "chunk"
    spy, calls = _spy(fdtd_stream.kernels)
    out = run_simulation(sim, spy)
    assert calls == [("chunk_steps", 0), ("chunk_steps", 40), ("chunk_steps", 80)]
    ref = run_simulation(sim, fdtd_cuda.step_kernels)
    for a, b in zip(out["fields"], ref["fields"], strict=True):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(out["uf"], ref["uf"])


def test_chunk_past_n_steps_max_reads_zeros():
    """A chunk that overruns ``n_steps_max`` reads the zeros padded past
    the source: the run's samples are one float32 tensor on the device."""
    sim = _engine_sim("PEC", n_steps=100, check_every=40)
    seen = []
    real = fdtd_cuda.chunk_steps_plain

    def chunk_steps(ops, st, wf, n0, n_sub, D, bufs):
        seen.append((wf, n0, n_sub * D))
        real(ops, st, wf, n0, n_sub, D, bufs)

    spy = SimpleNamespace(**{**vars(fdtd_cuda.plain), "chunk_steps": chunk_steps})
    out = run_simulation(sim, spy)
    assert out["steps"] == 120 and [s[1] for s in seen] == [0, 40, 80]
    wf, n0, count = seen[-1]
    assert wf.dtype == torch.float32 and wf.device == sim.device
    assert n0 + count <= len(wf)
    assert torch.equal(wf[:len(sim.waveform)],
                       torch.from_numpy(sim.waveform.astype(f32)))
    assert not wf[max(len(sim.waveform), 100):].any()


def test_stream_mode_steps_and_gathers_per_interval():
    from test_torch_stream import _port_sim as stream_sim

    sim = stream_sim("MUR", T=2)
    assert sim.pallas_mode == "stream"
    spy, calls = _spy(fdtd_stream.kernels)
    run_simulation(sim, spy)
    names = [c[0] for c in calls]
    assert "chunk_steps" not in names
    intervals = names.count("probe_gather")
    assert intervals > 0
    assert names.count("stream_steps") == intervals * sim.probe_decim // 2
    assert set(names) == {"stream_steps", "probe_gather"}


def test_chunk_mode_needs_chunk_steps():
    sim = _engine_sim("MUR")
    legacy = SimpleNamespace(**{k: v for k, v in vars(fdtd_cuda.plain).items()
                                if k != "chunk_steps"})
    with pytest.raises(ValueError, match="chunk_steps"):
        run_simulation(sim, legacy)
