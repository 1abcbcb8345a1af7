"""The port's N-port S matrix and re-excitation against the JAX package's,
on the CPU.

The scenes are those of ``tests/test_sparams.py``: two small patches
over one ground plane with a lumped port at each centre, and one patch
alone, 3,000 steps asked (3,136 run). Both packages build them from the
same inputs; the JAX package runs its XLA path, the port its plain
PyTorch twins. Each one-hot run's ``uf``, ``if_`` and ``steps`` must
match at the north-star tolerance (rtol 2e-4, atol 1e-5·max|ref|).
Then the network invariants of ``tests/test_sparams.py`` on the port:
reciprocity, symmetry, a 1-port S equal to the ``port_spectra`` S11
path, a polarity flip that changes only the phase, ``restore`` and the
length check.

Re-excitation writes the source stamps in place: the ``sim.operands.src``
tensors, and the addresses packed into K1's and K2's launch arguments,
stay valid; a K4 stepper built before a re-excitation steps with the new
drive, and so does an explicit run built after it (one built before
keeps the drive it was built with).
"""

import numpy as np
import pytest
import torch

from _multiport_scenes import FREQS, JAX, TORCH, one_patch, two_patches
from fdtd_solver_antennas_tpu.solvers.sparams import compute_s_matrix as jcompute

from fdtd_solver_antennas_tpu_torch import SMatrixResult, compute_s_matrix
from fdtd_solver_antennas_tpu_torch.ops import fdtd_cuda, fdtd_steps, fdtd_stream
from fdtd_solver_antennas_tpu_torch.ops.fdtd import build_src_mats, set_port_excitation
from fdtd_solver_antennas_tpu_torch.parallel import build_explicit_run
from fdtd_solver_antennas_tpu_torch.post.ports import port_spectra

RTOL = 2e-4
THREADS = 2  # PyTorch intra-op threads while this file runs


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Test workers share the cores (pytest-xdist); PyTorch's default of
    one intra-op thread per core would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(n)


def _close(a, b, rtol=RTOL):
    a = a.numpy() if torch.is_tensor(a) else np.asarray(a)
    b = np.asarray(b)
    atol = 1e-5 * max(float(np.abs(b).max()), 1e-20)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


def _extract(compute, sim):
    """``compute(sim)`` with every one-hot run's (uf, if_, steps, a_j)."""
    runs = {}

    def on_run(j, out, a_j):
        runs[j] = (np.asarray(out["uf"]), np.asarray(out["if_"]),
                   int(out["steps"]), np.asarray(a_j))

    return compute(sim, on_run=on_run), runs


@pytest.fixture(scope="module")
def two_port():
    """Both packages' S matrix of the two-patch scene, the port's source
    tensors recorded before the extraction."""
    jsim = two_patches(JAX)
    tsim = two_patches(TORCH)
    src0 = tsim.operands.src
    src0_vals = [None if t is None else t.clone() for t in src0]
    jres, jruns = _extract(jcompute, jsim)
    tres, truns = _extract(compute_s_matrix, tsim)
    assert jres.ok and tres.ok, (jres.message, tres.message)
    return dict(jres=jres, jruns=jruns, tres=tres, truns=truns, tsim=tsim,
                src0=src0, src0_vals=src0_vals)


def test_one_hot_runs_match_jax(two_port):
    for j in range(2):
        juf, jif, jsteps, _ = two_port["jruns"][j]
        tuf, tif, tsteps, _ = two_port["truns"][j]
        assert tsteps == jsteps == 3136
        _close(tuf, juf)
        _close(tif, jif)


def test_s_matrix_matches_jax(two_port):
    """S = b/a, where a and b are sums of the runs' V and Z·I, which agree
    at rtol 2e-4: compared only where the incident wave is not tiny
    (|a_j| > 1e-3·max|a_j|), at rtol 1e-3 (five times the run tolerance:
    the quotient carries the error of both sums, and |V| + Z|I| reaches
    about 2.5·2√Z|a| on this grid's band) and atol 1e-5·max|S|."""
    js, ts = two_port["jres"].s, two_port["tres"].s
    assert ts.shape == js.shape == (2, 2, len(FREQS))
    np.testing.assert_array_equal(two_port["tres"].freq_hz, FREQS)
    np.testing.assert_array_equal(two_port["tres"].z_ref, [50.0, 50.0])
    assert two_port["tres"].steps_run == two_port["jres"].steps_run
    atol = 1e-5 * np.nanmax(np.abs(js))
    for j in range(2):
        a = two_port["jruns"][j][3]
        keep = np.abs(a) > 1e-3 * np.abs(a).max()
        assert keep.any()
        np.testing.assert_allclose(ts[:, j][:, keep], js[:, j][:, keep],
                                   rtol=1e-3, atol=atol)


def test_two_port_reciprocity_and_symmetry(two_port):
    res = two_port["tres"]
    s = res.s
    np.testing.assert_allclose(s[0, 0], s[1, 1], rtol=2e-3, atol=1e-6)
    np.testing.assert_allclose(s[0, 1], s[1, 0], rtol=2e-3, atol=1e-6)
    assert res.reciprocity_error() < 5e-3 * np.nanmax(np.abs(s))
    assert np.nanmax(np.abs(s[0, 1])) > 1e-4
    assert res.passivity_margin() < 1.05
    assert res.passivity_margin() == pytest.approx(
        two_port["jres"].passivity_margin(), rel=1e-3)
    np.testing.assert_allclose(res.s_db(), two_port["jres"].s_db(),
                               atol=1e-2)


def test_single_port_matches_s11():
    """The one-hot run of a 1-port scene is its prepared drive, so its S
    is the S11 of ``port_spectra`` on the same run's DFTs."""
    sim = one_patch(TORCH)
    res, runs = _extract(compute_s_matrix, sim)
    assert res.ok, res.message
    uf, if_, _steps, _ = runs[0]
    ref = port_spectra(FREQS, uf[0], if_[0], sim.dt, z_ref=50.0)
    assert res.s.shape == (1, 1, len(FREQS))
    np.testing.assert_allclose(res.s[0, 0], ref.s11, rtol=1e-6, atol=1e-9)


def test_polarity_flip_changes_coupling_sign_only(two_port):
    s_pp = two_port["tres"].s
    s_pm = compute_s_matrix(two_patches(TORCH, pol2=-1.0)).s
    np.testing.assert_allclose(s_pm[0, 0], s_pp[0, 0], rtol=1e-5, atol=1e-9)
    np.testing.assert_allclose(s_pm[1, 1], s_pp[1, 1], rtol=1e-5, atol=1e-9)
    np.testing.assert_allclose(s_pm[0, 1], -s_pp[0, 1], rtol=1e-5, atol=1e-9)
    np.testing.assert_allclose(s_pm[1, 0], -s_pp[1, 0], rtol=1e-5, atol=1e-9)
    np.testing.assert_allclose(np.abs(s_pm), np.abs(s_pp), rtol=1e-5)


def test_restore_reinstates_the_excitation_in_place(two_port):
    """After the extraction the port columns and the very same stamp
    tensors hold the prepared excitation again."""
    sim = two_port["tsim"]
    for p in sim.ports:
        np.testing.assert_array_equal(
            p.src_col, (p.src_col_unit * np.float32(p.spec.excite)))
    for t, t0, v0 in zip(sim.operands.src, two_port["src0"],
                         two_port["src0_vals"]):
        assert t is t0
        if t is not None:
            assert torch.equal(t, v0)


def test_restore_gives_the_same_run():
    sim = two_patches(TORCH, n_steps=224)
    out0 = sim.run()
    assert compute_s_matrix(sim, restore=True).ok
    out1 = sim.run()
    np.testing.assert_array_equal(out1["uf"], out0["uf"])
    np.testing.assert_array_equal(out1["if_"], out0["if_"])


def test_abort_restores_and_reports():
    sim = two_patches(TORCH, n_steps=224)
    orig = [float(p.spec.excite) for p in sim.ports]
    res = compute_s_matrix(sim, abort_cb=lambda: True)
    assert isinstance(res, SMatrixResult)
    assert not res.ok and "abort" in res.message
    assert [float(p.spec.excite) for p in sim.ports] == orig
    want = build_src_mats(sim, *sim.padded_shape)
    assert torch.equal(sim.operands.src[2], torch.from_numpy(want[2]))


def test_set_port_excitation_validates_length():
    sim = one_patch(TORCH)
    with pytest.raises(ValueError):
        set_port_excitation(sim, [1.0, 0.0])


def test_s_matrix_refuses_msl_ports():
    sim = one_patch(TORCH)
    sim.msl_ports = [object()]
    res = compute_s_matrix(sim)
    assert not res.ok and "lumped ports only" in res.message


def test_set_port_excitation_writes_the_stamps_in_place():
    """The same tensors at the same addresses, the packed launch arguments
    of K1 and of K2's march still pointing at them, their values the new
    stamps; an all-undriven component keeps a stamp of zeros."""
    sim = two_patches(TORCH, n_steps=224)
    ops = sim.operands
    src = ops.src
    assert src[0] is None and src[1] is None and src[2] is not None
    ptr = src[2].data_ptr()
    st = fdtd_cuda.new_state(sim.padded_shape, sim.device, False)
    k1 = fdtd_cuda._chunk_args(ops, st)
    f = fdtd_stream._field_set(st)
    k2 = fdtd_stream._pack(ops, f, tuple(torch.zeros_like(t) for t in f),
                           fdtd_stream.march_view(ops), None)
    before = src[2].clone()
    for scales in ([0.0, 1.0], [0.5, -2.0], [0.0, 0.0]):
        set_port_excitation(sim, scales)
        assert ops.src is src and src[2].data_ptr() == ptr
        assert k1.o.src[2] == k2.src[2] == ptr
        for p, s in zip(sim.ports, scales):
            np.testing.assert_array_equal(
                p.src_col, p.src_col_unit * np.float32(s))
        want = build_src_mats(sim, *sim.padded_shape)
        assert set(want) == {2}
        assert torch.equal(src[2], torch.from_numpy(want[2]))
    assert not src[2].any()
    set_port_excitation(sim, [1.0, 1.0])
    assert torch.equal(src[2], before)


def test_cpml_stamp_flags_cover_a_port_driven_later():
    """K2's CPML march adds a stamp only on the planes its packed launch
    arguments flag, and those arguments outlive a re-excitation: packed
    while port 2 is undriven, they flag port 2's plane all the same, so
    each drive the stamps take later is read where it is nonzero."""
    sim = two_patches(TORCH, pol2=0.0, n_steps=224, boundary="PML_4")
    ops, Px = sim.operands, sim.padded_shape[0]
    st = fdtd_cuda.new_state(sim.padded_shape, sim.device, True)
    f = fdtd_stream._field_set(st)
    k2 = fdtd_stream._pack(ops, f, tuple(torch.zeros_like(t) for t in f),
                           fdtd_stream.march_view(ops), None)
    flagged = (k2._src_planes >> 2) & 1 == 1
    assert not ((k2._src_planes & 0b011) != 0).any()
    planes = [ops.src[2].reshape(Px, -1).ne(0).any(1)]
    for scales in ([0.0, 1.0], [1.0, 1.0]):
        set_port_excitation(sim, scales)
        planes.append(ops.src[2].reshape(Px, -1).ne(0).any(1))
    assert not torch.equal(planes[0], planes[1])  # the ports lie on two planes
    assert torch.equal(flagged, planes[2])
    for on in planes:
        assert flagged[on].all()


def test_k4_stepper_built_before_steps_with_the_new_drive():
    sim = two_patches(TORCH, n_steps=224)
    D = sim.probe_decim
    wf = [float(x) for x in sim.waveform[:D]]
    zeros = tuple(torch.zeros(sim.padded_shape) for _ in range(6))
    early, _, _ = fdtd_steps.build_stepper(sim, *sim._aux[:3])
    both = early(zeros, wf)
    set_port_excitation(sim, [0.0, 1.0])
    late, _, _ = fdtd_steps.build_stepper(sim, *sim._aux[:3])
    got, want = early(zeros, wf), late(zeros, wf)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert not torch.equal(got[2], both[2])


def test_explicit_run_sees_the_drive_it_was_built_with():
    """``build_explicit_run`` copies the stamps into its slab when it is
    built: one built after a re-excitation runs the new drive, one built
    before keeps the old one."""
    sim = two_patches(TORCH, n_steps=224)
    before = build_explicit_run(sim)
    ref_both = sim.run()
    set_port_excitation(sim, [0.0, 1.0])
    ref_one = sim.run()
    after = build_explicit_run(sim)
    for run, ref in ((after, ref_one), (before, ref_both)):
        out = run()
        assert out["steps"] == ref["steps"]
        _close(out["uf"], ref["uf"])
        _close(out["if_"], ref["if_"])
        for fa, fb in zip(out["fields"], ref["fields"]):
            _close(fa, fb)
    assert not np.allclose(ref_one["uf"], ref_both["uf"])
