"""The geometry sweep in stream mode (batched K2) on the CPU.

The JAX package runs a sweep whose base resolves to stream mode through
its stream kernel K2 under ``jax.vmap``: the ``coef_ops_from`` form takes
each variant's ca/cb windows as operands. The port runs it through
``ops/fdtd.py::run_batched`` in stream mode: per probe interval D / T
``stream_steps_batch`` launches and one ``probe_gather_batch`` on the
card, their plain twins here (``stream_steps_batch_plain``,
``probe_gather_batch_plain``). The kernels themselves are held to the
twins on the card (``tests/test_torch_cuda.py``).

The JAX stream kernel under vmap does resolve on the CPU, but in
interpret mode a 480-step run of the two-patch sweep takes more than five
minutes, too slow for these tests. So the whole path is held to the JAX
package's vmapped XLA run (``use_pallas=False``) on a base built at the
port's decimation (rounded to a multiple of T), at rtol 2e-4, atol
1e-5·max|ref| (the JAX package's own kernel-vs-XLA tolerance):

(a) the twin: at B = 1 bit-equal to ``stream_steps_plain``; at B = 3
    each variant bit-equal to its own run on its own coefficients, E
    buffer and H set; a frozen variant's tensors, parity and set
    untouched; the batched gather likewise;
(b) the two-patch sweep of ``tests/test_sweep.py`` with
    ``pallas_mode="stream"``: per variant ``steps``, ``uf``, ``if_`` and
    ``e_ratio``;
(c) the freeze: the two variants of ``tests/test_torch_sweep.py`` that
    stop at different chunks, in stream mode, their final fields at that
    file's sweep bound (rtol 2e-3, atol 2e-4·max);
(d) the routing: stream mode equals chunk mode exactly on the CPU (D a
    multiple of T); a decimation that is not raises; the sweep resolves
    its mode from the base's working set, or as forced.
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from fdtd_solver_antennas_tpu.models.scene import Scene as JScene
from fdtd_solver_antennas_tpu.ops.fdtd import FDTDConfig as JConfig
from fdtd_solver_antennas_tpu.ops.fdtd import build_simulation as jbuild
from fdtd_solver_antennas_tpu.ops.mesh import MeshBuilder as JMeshBuilder
from fdtd_solver_antennas_tpu.solvers import sweep as jsweep
from fdtd_solver_antennas_tpu_torch.models.params import HornAntennaParams
from fdtd_solver_antennas_tpu_torch.models.scene import Scene
from fdtd_solver_antennas_tpu_torch.ops import fdtd as fdtd_engine
from fdtd_solver_antennas_tpu_torch.ops import fdtd_cuda, fdtd_stream
from fdtd_solver_antennas_tpu_torch.ops.fdtd import (
    FDTDConfig,
    build_simulation,
    run_batched,
)
from fdtd_solver_antennas_tpu_torch.ops.mesh import MeshBuilder
from fdtd_solver_antennas_tpu_torch.solvers import sweep
from test_torch_sweep import (
    FREEZE_VARIANTS,
    HORN,
    _batch_ops,
    _close,
    _freeze_grid,
    _freeze_scene,
    _np,
    _patches,
    _small_sim,
)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Test workers share the cores (pytest-xdist)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# (a) the twin
# ---------------------------------------------------------------------------

def _tensors(st):
    return (*st.e[0], *st.e[1], *st.h, *st.psi_e, *st.psi_h, *st.h1,
            *st.psi_e1, *st.psi_h1)


def _random_batch(sim, batch, seed, second=False):
    """A seeded random batch state; ``second`` also makes the second set
    of H and ψ, as the batched stream stepper's first launch does."""
    st = fdtd_cuda.new_batch_state(sim.padded_shape, "cpu",
                                   sim.operands.pml is not None, batch)
    if second:
        st.h1 = tuple(torch.zeros_like(t) for t in st.h)
        st.psi_e1 = tuple(torch.zeros_like(t) for t in st.psi_e)
        st.psi_h1 = tuple(torch.zeros_like(t) for t in st.psi_h)
    rng = np.random.default_rng(seed)
    for t in _tensors(st):
        t.copy_(torch.from_numpy(rng.standard_normal(t.shape).astype(np.float32)))
    return st


def _own_state(st, b):
    """Variant ``b``'s current tensors, cloned into a state of its own."""
    v = st.variant(b)
    return fdtd_cuda.YeeState(
        e=[tuple(t.clone() for t in v.e[p]) for p in range(2)],
        h=tuple(t.clone() for t in v.h),
        psi_e=tuple(t.clone() for t in v.psi_e),
        psi_h=tuple(t.clone() for t in v.psi_h), parity=v.parity)


def _current(st):
    return (*st.fields, *st.psi_e, *st.psi_h)


@pytest.mark.parametrize("T", [1, 2, 4])
@pytest.mark.parametrize("boundary", ["MUR", "PEC", "PML_4"])
def test_twin_of_one_variant_is_stream_steps_plain(boundary, T):
    sim = _small_sim(boundary)
    st = _random_batch(sim, 1, seed=T)
    st.parity = [1]
    ref = _own_state(st, 0)
    wf = [0.37, -0.21, 0.55, 0.13][:T]
    fdtd_stream.reset_launch_counts()
    fdtd_stream.stream_steps_batch(_batch_ops(sim, 1, 0), st, wf, [True])
    fdtd_stream.stream_steps_plain(sim.operands, ref, wf)
    assert st.parity == [ref.parity] == [1 ^ T & 1] and st.hset == [0]
    for a, b in zip(_current(st.variant(0)), _current(ref), strict=True):
        assert torch.equal(a, b)
    assert fdtd_stream.launches == dict.fromkeys(fdtd_stream.KERNELS, 0)


@pytest.mark.parametrize("boundary", ["MUR", "PML_4"])
def test_twin_steps_each_variant_on_its_own(boundary):
    """B = 3, distinct ca/cb, the variants at different E buffers and H
    sets, variant 1 frozen: 0 and 2 equal their own runs; 1 keeps every
    tensor, its parity and its set."""
    sim = _small_sim(boundary)
    ops = _batch_ops(sim, 3, seed=2)
    st = _random_batch(sim, 3, seed=12, second=True)
    st.parity, st.hset = [1, 0, 1], [1, 1, 0]
    refs = {b: _own_state(st, b) for b in (0, 2)}
    before = [t.clone() for t in _tensors(st)]
    wf = [0.3, -0.2, 0.5]
    fdtd_stream.stream_steps_batch(ops, st, wf, torch.tensor([1, 0, 1]))
    assert st.parity == [0, 0, 0] and st.hset == [1, 1, 0]
    for t, t0 in zip(_tensors(st), before, strict=True):
        assert torch.equal(t[1], t0[1])
    for b, ref in refs.items():
        fdtd_stream.stream_steps_plain(fdtd_cuda.variant_operands(ops, b), ref, wf)
        for x, y in zip(_current(st.variant(b)), _current(ref), strict=True):
            assert torch.equal(x, y)
    # each variant ran on its own coefficients: variant 2's are not 0's
    other = _own_state(_random_batch(sim, 3, seed=12, second=True), 2)
    other.parity = 1
    fdtd_stream.stream_steps_plain(fdtd_cuda.variant_operands(ops, 0), other, wf)
    assert not torch.equal(other.fields[0], st.variant(2).fields[0])


def test_batched_gather_twin_samples_each_active_variant():
    sim = _small_sim("PML_4")
    st = _random_batch(sim, 3, seed=4, second=True)
    st.parity, st.hset = [0, 1, 1], [1, 0, 1]
    rows = sim.operands.probes.n_rows
    bufs = torch.full((3, 2, rows), 7.0)
    fdtd_cuda.probe_gather_batch(sim.operands, st, bufs[:, 1], [True, False, True])
    assert torch.equal(bufs[:, 0], torch.full((3, rows), 7.0))
    assert torch.equal(bufs[1, 1], torch.full((rows,), 7.0))
    for b in (0, 2):
        ref = torch.zeros(rows)
        fdtd_cuda.probe_gather_plain(sim.operands, st.variant(b), ref)
        assert torch.equal(bufs[b, 1], ref)


def test_batch_fields_read_each_variants_own_set():
    sim = _small_sim("MUR")
    st = _random_batch(sim, 3, seed=8, second=True)
    st.parity, st.hset = [1, 0, 1], [0, 1, 1]
    for b in range(3):
        for got, want in zip((f[b] for f in st.fields()), st.variant(b).fields,
                             strict=True):
            assert torch.equal(got, want)
    assert torch.equal(st.fields()[3][1], st.h1[0][1])


def test_batched_stream_wrappers_validate():
    sim = _small_sim("MUR")
    ops = _batch_ops(sim, 2, seed=0)
    st = fdtd_cuda.new_batch_state(sim.padded_shape, "cpu", False, 2)
    with pytest.raises(ValueError, match="active mask"):
        fdtd_stream.stream_steps_batch(ops, st, [0.1], [True])
    for wf in ([], [0.0] * (fdtd_stream.MAX_T + 1)):
        with pytest.raises(ValueError, match="samples"):
            fdtd_stream.stream_steps_batch(ops, st, wf, [True, True])
    slab = dataclasses.replace(ops, mur_x_rows=(0, 5))
    with pytest.raises(ValueError, match="whole grid"):
        fdtd_stream.stream_steps_batch(slab, st, [0.1], [True, True])
    rows = ops.probes.n_rows
    with pytest.raises(ValueError, match="probe_gather_batch"):
        fdtd_cuda.probe_gather_batch(ops, st, torch.zeros((2, rows + 1)),
                                     [True, True])
    st.parity = [0, 1]
    with pytest.raises(ValueError, match="E buffer, H set"):
        fdtd_cuda.one_set(st, [0, 1], "stream_steps_batch")


# ---------------------------------------------------------------------------
# (b) the patch sweep in stream mode against the JAX package's vmapped run
# ---------------------------------------------------------------------------

def _jax_run(jbase, jbatched, n_variants):
    jprep = jsweep.SweepPrepared(
        True, "", sim=jbase, variants=list(range(n_variants)),
        batched_coeffs=jbatched, _vrun=jsweep._make_vmapped_run(jbase))
    return jsweep._run_batched(jprep)[0]


@pytest.fixture(scope="module")
def stream_sweep():
    prep = sweep.prepare_patch_geometry_sweep(
        _patches("torch"), n_steps_max=400, end_criteria=1e-12,
        pallas_mode="stream", device="cpu")
    assert prep.ok, prep.message
    sim = prep.sim
    assert sim.pallas_mode == "stream" and sim.probe_decim % sim.stream_T == 0
    calls = dict.fromkeys(("stream_steps_batch", "probe_gather_batch",
                           "chunk_steps_batch"), 0)

    def counted(name):
        def call(*args):
            calls[name] += 1
            return getattr(fdtd_stream.kernels, name)(*args)
        return call

    spy = SimpleNamespace(**{name: counted(name) for name in calls})
    out = run_batched(sim, prep.batched_coeffs, spy)

    # the JAX base at the port's decimation, on the JAX package's union grid
    jv = _patches("jax")
    jgrid = jsweep.prepare_patch_geometry_sweep(
        jv, n_steps_max=400, end_criteria=1e-12, use_pallas=False).sim.grid
    f0 = 2.45e9
    jbase, jbatched = jsweep._batched_coeffs_delta(
        jv, jgrid, -6.0, f0, f0 / 2,
        JConfig(n_steps_max=400, end_criteria=1e-12,
                probe_decimation=sim.probe_decim, use_pallas=False),
        np.linspace(max(1e8, f0 * 0.5), f0 * 1.5, 201), np.array([f0]))
    assert jbase.probe_decim == sim.probe_decim
    assert tuple(jbase.grid.shape) == tuple(sim.grid.shape)
    return prep, out, calls, _jax_run(jbase, jbatched, len(jv))


def test_stream_sweep_matches_jax(stream_sweep):
    """Per variant: the step count, the port's V and I spectra and the
    energy ratio."""
    _prep, out, _calls, jout = stream_sweep
    np.testing.assert_array_equal(out["steps"], np.asarray(jout["steps"]))
    juf, jif = np.asarray(jout["uf"]), np.asarray(jout["if_"])
    for b in range(len(out["steps"])):
        _close(out["uf"][b], juf[b, 0] + 1j * juf[b, 1], f"variant {b} uf")
        _close(out["if_"][b], jif[b, 0] + 1j * jif[b, 1], f"variant {b} if_")
    _close(out["e_ratio"], np.asarray(jout["e_ratio"]), "e_ratio")


def test_stream_sweep_runs_the_batched_stream_route(stream_sweep):
    """The run steps every variant with one ``stream_steps_batch`` call per
    T steps and samples with one ``probe_gather_batch`` per interval,
    never ``chunk_steps_batch``; each variant has its own spectrum."""
    prep, out, calls, _jout = stream_sweep
    sim = prep.sim
    steps = int(out["steps"].max())
    assert calls == {"stream_steps_batch": steps // sim.stream_T,
                     "probe_gather_batch": steps // sim.probe_decim,
                     "chunk_steps_batch": 0}, calls
    s0, s1 = (np.abs(sp.s11) for sp in sweep._batched_port_spectra(prep, out))
    assert not np.allclose(s0, s1, rtol=1e-3)


# ---------------------------------------------------------------------------
# (c) variants that stop at different chunks, in stream mode
# ---------------------------------------------------------------------------

FREEZE_RUN = dict(n_steps_max=3000, end_criteria=1e-2, check_every=25,
                  probe_decimation=5)
FREEZE_KW = dict(f0=2.45e9, fc=1.225e9, port_freqs_hz=np.linspace(2e9, 3e9, 11),
                 nf_freqs_hz=np.array([2.45e9]))


def _freeze_sims(mode):
    grid = _freeze_grid(MeshBuilder)
    sims = [build_simulation(_freeze_scene(Scene, k, h), grid,
                             cfg=FDTDConfig(**FREEZE_RUN, pallas_mode=mode),
                             device="cpu", **FREEZE_KW)
            for k, h in FREEZE_VARIANTS]
    coeffs = {k: torch.stack([s.coeffs[k] for s in sims]) for k in sims[0].coeffs}
    return sims[0], coeffs


@pytest.fixture(scope="module")
def freeze_stream():
    sim, coeffs = _freeze_sims("stream")
    assert sim.pallas_mode == "stream", sim.pallas_mode_reason
    out = run_batched(sim, coeffs)
    jgrid = _freeze_grid(JMeshBuilder)
    run = dict(FREEZE_RUN, probe_decimation=sim.probe_decim)
    jsims = [jbuild(_freeze_scene(JScene, k, h), jgrid,
                    cfg=JConfig(**run, use_pallas=False), **FREEZE_KW)
             for k, h in FREEZE_VARIANTS]
    jout = _jax_run(jsims[0], {k: jnp.stack([s.coeffs[k] for s in jsims])
                               for k in jsims[0].coeffs}, len(jsims))
    return sim, coeffs, out, jout


def test_stream_freeze_matches_jax(freeze_stream):
    """The variants stop at different chunks, each where the JAX package's
    vmapped while_loop stops it; its sums and final fields are those of
    its stop (the fields at the sweep's bound, rtol 2e-3, atol 2e-4·max,
    as ``tests/test_torch_sweep.py`` holds them)."""
    sim, _coeffs, out, jout = freeze_stream
    steps = out["steps"]
    np.testing.assert_array_equal(steps, np.asarray(jout["steps"]))
    assert steps[0] != steps[1] and steps[1] < sim.cfg.n_steps_max, steps
    _close(out["e_ratio"], np.asarray(jout["e_ratio"]), "e_ratio")
    juf, jif = np.asarray(jout["uf"]), np.asarray(jout["if_"])
    for b in range(len(FREEZE_VARIANTS)):
        _close(out["uf"][b], juf[b, 0] + 1j * juf[b, 1], f"variant {b} uf")
        _close(out["if_"][b], jif[b, 0] + 1j * jif[b, 1], f"variant {b} if_")
        for i, (f, jf) in enumerate(zip(out["fields"], jout["fields"])):
            jf = np.asarray(jf)[b]
            _close(_np(f[b])[tuple(slice(0, n) for n in jf.shape)], jf,
                   f"variant {b} field {i}", rtol=2e-3, atol_rel=2e-4)


# ---------------------------------------------------------------------------
# (d) the routing
# ---------------------------------------------------------------------------

def test_stream_mode_equals_chunk_mode_on_cpu(freeze_stream):
    """On the CPU a batched stream launch is T plain steps of each active
    variant, and its gather the plain gather: with D a multiple of T the
    run is chunk mode's, bit for bit, freeze included."""
    _sim, _coeffs, out, _jout = freeze_stream
    sim, coeffs = _freeze_sims("chunk")
    ref = run_batched(sim, coeffs)
    np.testing.assert_array_equal(out["steps"], ref["steps"])
    np.testing.assert_array_equal(out["e_ratio"], ref["e_ratio"])
    for key in ("uf", "if_"):
        np.testing.assert_array_equal(out[key], ref[key])
    for a, b in zip(out["fields"], ref["fields"], strict=True):
        assert torch.equal(a, b)


def test_stream_mode_needs_a_decimation_that_t_divides(freeze_stream):
    sim, coeffs, _out, _jout = freeze_stream
    bad = dataclasses.replace(sim, probe_decim=sim.stream_T + 1)
    with pytest.raises(ValueError, match="multiple of stream_T"):
        run_batched(bad, coeffs)
    with pytest.raises(ValueError, match="stream_steps_batch"):
        run_batched(sim, coeffs, fdtd_cuda.kernels)


def test_patch_sweep_resolves_its_mode(monkeypatch):
    """The two patches fit the L2: chunk mode, unless forced to stream (T
    the deepest the kernels take, D a multiple of it); past the L2 the
    same sweep resolves to stream with no argument. The port refuses an
    unknown mode (the JAX package accepts it and resolves as for None)."""
    def prep(**kw):
        p = sweep.prepare_patch_geometry_sweep(
            _patches("torch"), n_steps_max=400, device="cpu", **kw)
        assert p.ok, p.message
        return p.sim

    auto = prep()
    assert auto.pallas_mode == "chunk" and "fits the L2" in auto.pallas_mode_reason
    assert prep(pallas_mode="chunk").pallas_mode == "chunk"
    forced = prep(pallas_mode="stream")
    assert (forced.pallas_mode, forced.stream_T) == ("stream", 4)
    assert forced.probe_decim == auto.probe_decim // 4 * 4
    bad = sweep.prepare_patch_geometry_sweep(_patches("torch"), device="cpu",
                                             pallas_mode="tiled")
    assert not bad.ok and "pallas_mode='tiled'" in bad.message
    monkeypatch.setattr(fdtd_engine, "L2_BYTES", 1 << 20)
    spilled = prep()
    assert spilled.pallas_mode == "stream", spilled.pallas_mode_reason
    assert "exceeds the L2" in spilled.pallas_mode_reason


def test_horn_sweep_resolves_its_mode(monkeypatch):
    """The horn sweep resolves automatically, as the JAX package's does:
    chunk at the tests' small mesh, stream once its grid spills the L2."""
    def prep():
        p = sweep.prepare_horn_aperture_sweep(
            HornAntennaParams.from_user_units(**HORN),
            [(30.0, 24.0, 30.0), (55.0, 42.0, 45.0)], mesh_ppw=8.0,
            n_steps_max=300, device="cpu")
        assert p.ok, p.message
        return p.sim

    assert prep().pallas_mode == "chunk"
    monkeypatch.setattr(fdtd_engine, "L2_BYTES", 1 << 20)
    sim = prep()
    assert sim.pallas_mode == "stream" and sim.probe_decim % sim.stream_T == 0
