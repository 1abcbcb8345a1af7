"""The port's shard stepper (K3) against the TPU shard kernel on the CPU.

``shard_steps_plain`` advances one rank's halo-extended slab ``(m, Py, Pz)``;
the JAX package's ``build_pallas_shard_stepper(...)["step_call"]`` advances
the same slab in its lane layout ``(m, Py·128)``, run in interpret mode as
the JAX package's own tests run it on the CPU. From the same seeded random
state, the owned rows ``[W, W + n)`` must agree at rtol 2e-4 and atol
1e-5·max|ref| under MUR, PEC and PML_4, for a full window of K steps and a
remainder window, on an edge rank, an interior rank of a 4-way split and a
straddle slab (the top MUR wall on a block's first row, W = K + 1). The
halo rows differ by design: the TPU kernel's rolls wrap at the slab edges,
the port reads 0 there.
"""

import functools

import numpy as np
import pytest
import torch

from fdtd_solver_antennas_tpu.models.scene import Scene as JScene
from fdtd_solver_antennas_tpu.ops.fdtd import FDTDConfig as JConfig
from fdtd_solver_antennas_tpu.ops.fdtd import build_simulation as jbuild
from fdtd_solver_antennas_tpu.ops.fdtd_pallas import (
    LANE,
    build_pallas_shard_stepper,
)
from fdtd_solver_antennas_tpu.ops.mesh import MeshBuilder as JMeshBuilder

from _explicit_ranks import FREQS, scene
from fdtd_solver_antennas_tpu_torch.models.scene import Scene
from fdtd_solver_antennas_tpu_torch.ops import fdtd_cuda, fdtd_shard
from fdtd_solver_antennas_tpu_torch.ops.fdtd import FDTDConfig, build_simulation
from fdtd_solver_antennas_tpu_torch.ops.mesh import MeshBuilder

RTOL = 2e-4


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Test workers share the cores (pytest-xdist)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _controls(boundary, decim):
    return dict(n_steps_max=120, check_every=60, end_criteria=1e-30,
                boundary=boundary, probe_decimation=decim)


@functools.lru_cache(maxsize=None)
def _sims(kind, boundary, n_dev, decim):
    kw = dict(f0=2.45e9, fc=1.225e9, nf_margin_cells=2,
              pad_multiple=(n_dev, 1, 1), **FREQS)
    sc, grid = scene(JMeshBuilder, JScene, kind)
    jsim = jbuild(sc, grid, cfg=JConfig(use_pallas=False,
                                        **_controls(boundary, decim)), **kw)
    sc, grid = scene(MeshBuilder, Scene, kind)
    psim = build_simulation(sc, grid, cfg=FDTDConfig(**_controls(boundary, decim)),
                            device="cpu", **kw)
    return jsim, psim


@functools.lru_cache(maxsize=None)
def _jax_kernel(kind, boundary, n_dev, decim):
    jsim, _ = _sims(kind, boundary, n_dev, decim)
    inv_p, inv_d, mur_coef, pml = jsim._aux
    return build_pallas_shard_stepper(jsim, inv_p, inv_d, mur_coef, pml, n_dev,
                                      interpret=True)


def _to_lanes(a):
    """(m, Py, Pz) → the TPU kernel's (m, Py·128), z padded with zeros."""
    m, py, pz = a.shape
    return np.pad(a, ((0, 0), (0, 0), (0, LANE - pz))).reshape(m, py * LANE)


def _from_lanes(a, py, pz):
    return np.asarray(a).reshape(a.shape[0], py, LANE)[:, :, :pz]


# (kind, boundary, n_dev, rank, decim, window): window "K" or "rem"
CASES = [
    ("small", "MUR", 1, 0, 45, "K"),        # one rank: the chip smoke's case
    ("small", "MUR", 1, 0, 45, "rem"),      # D % K = 45 % 22 = 1 step
    ("small", "PEC", 2, 1, 45, "K"),
    ("small", "PML_4", 2, 0, 45, "K"),
    ("small", "PML_4", 4, 2, 9, "rem"),     # interior rank, K = 6, rem 3
    ("small", "MUR", 4, 1, 9, "K"),         # interior rank of a 4-way split
    ("straddle", "MUR", 4, 3, 4, "K"),      # W = K + 1 = 4
    ("straddle", "MUR", 4, 2, 4, "rem"),
]


@pytest.mark.parametrize("kind,boundary,n_dev,rank,decim,window", CASES)
def test_shard_steps_plain_matches_tpu_kernel(kind, boundary, n_dev, rank,
                                              decim, window):
    jsim, psim = _sims(kind, boundary, n_dev, decim)
    kern = _jax_kernel(kind, boundary, n_dev, decim)
    sh = fdtd_shard.build_shard_stepper(psim, n_dev, rank)
    assert (sh.n, sh.K, sh.W, sh.m, sh.rem) == (
        kern["n"], kern["K"], kern["W"], kern["m"], kern["rem"])
    k = sh.K if window == "K" else sh.rem
    assert k >= 1
    if kind == "straddle":
        assert sh.W == sh.K + 1
    Px, Py, Pz = psim.padded_shape
    has_pml = boundary.startswith("PML")
    rng = np.random.default_rng(17 + rank)
    n_arr = 6 + (12 if has_pml else 0)
    init = rng.standard_normal((n_arr, sh.m, Py, Pz)).astype(np.float32)
    # The last y plane starts at zero, as in every run: there Ey is a
    # trailing slot and the y spacing is 0, so Hx, Hz and their ψ stay 0.
    # The TPU kernel's y roll reads that plane at y = 0, where the port
    # reads 0; random values there would differ by the wrap alone.
    init[:, :, Py - 1] = 0.0
    wf = [0.37, -0.21, 0.55, 0.13, 0.4, -0.3, 0.2, 0.1] * 8

    st = sh.new_state()
    for t, a in zip((*st.fields, *st.psi_e, *st.psi_h), init):
        t.copy_(torch.from_numpy(a))
    fdtd_shard.shard_steps_plain(sh.ops, st, wf[:k])

    dev = [np.asarray(a[rank]) for a in kern["dev_statics"]]
    lanes = [_to_lanes(a) for a in init]
    f6, pe, ph = kern["step_call"](
        dev, kern["repl_statics"], tuple(lanes[:6]), tuple(lanes[6:12]),
        tuple(lanes[12:]), np.asarray(wf[:k], np.float32).reshape(1, k))
    got = (*st.fields, *st.psi_e, *st.psi_h)
    ref = (*f6, *pe, *ph)
    assert len(got) == len(ref) == n_arr
    own = sh.owned
    for i, (a, b) in enumerate(zip(got, ref)):
        b = _from_lanes(b, Py, Pz)[own]
        atol = 1e-5 * max(float(np.abs(b).max()), 1e-20)
        np.testing.assert_allclose(a[own].numpy(), b, rtol=RTOL, atol=atol,
                                   err_msg=f"array {i}")


@pytest.mark.parametrize("kind,boundary,n_dev,decim", [
    ("small", "MUR", 1, 45), ("small", "PEC", 2, 45), ("small", "MUR", 4, 9),
    ("straddle", "MUR", 4, 4), ("straddle", "PEC", 4, 4),
])
def test_geometry_matches_tpu_kernel(kind, boundary, n_dev, decim):
    """n, K, W, m and rem as the JAX builder picks them with k_steps=None;
    the straddle rule fires only under MUR."""
    _, psim = _sims(kind, boundary, n_dev, decim)
    kern = _jax_kernel(kind, boundary, n_dev, decim)
    for rank in range(n_dev):
        sh = fdtd_shard.build_shard_stepper(psim, n_dev, rank)
        assert (sh.n, sh.K, sh.W, sh.m, sh.rem) == (
            kern["n"], kern["K"], kern["W"], kern["m"], kern["rem"])
        # the slab statics are the TPU kernel's, cut row for row
        ca = _to_lanes(sh.ops.ca[2].numpy())
        np.testing.assert_array_equal(ca, kern["dev_statics"][4][rank])
        np.testing.assert_array_equal(sh.ops.inv_p[0].numpy(),
                                      kern["dev_statics"][6][rank][:, 0])
        m0 = kern["dev_statics"][8][rank][:, 0]
        mt = kern["dev_statics"][9][rank][:, 0]
        for mask, row in zip((m0, mt), sh.ops.mur_x_rows):
            assert np.flatnonzero(mask).tolist() == (
                [row] if 0 <= row < sh.m else [])


def test_owned_rows_do_not_depend_on_k():
    """K only decides how often halos are exchanged: one rank's whole
    interval of D steps in windows of 5 or 9 steps (and the remainder)
    leaves the same owned rows as the default K."""
    _, psim = _sims("small", "MUR", 1, 45)
    outs = []
    for k_steps in (None, 5, 9):
        sh = fdtd_shard.build_shard_stepper(psim, 1, 0, k_steps=k_steps)
        st = sh.new_state()
        wf = list(np.linspace(-1.0, 1.0, 45))
        n = 0
        for k in [sh.K] * (45 // sh.K) + ([sh.rem] if sh.rem else []):
            fdtd_shard.shard_steps(sh.ops, st, wf[n:n + k])
            n += k
        assert n == 45
        outs.append([f[sh.owned].clone() for f in st.fields])
    for other in outs[1:]:
        for a, b in zip(outs[0], other):
            assert torch.equal(a, b)


def test_slab_probe_tables_sum_to_the_global_samples():
    """Each rank samples only its own rows; the partial samples of the four
    slabs add up to the whole grid's probe values."""
    _, psim = _sims("small", "PML_4", 4, 9)
    Px, Py, Pz = psim.padded_shape
    rng = np.random.default_rng(5)
    fields = rng.standard_normal((6, Px, Py, Pz)).astype(np.float32)
    whole = fdtd_cuda.new_state(psim.padded_shape, "cpu", pml=False)
    for t, a in zip(whole.fields, fields):
        t.copy_(torch.from_numpy(a))
    ref = torch.zeros(psim.operands.probes.n_rows)
    fdtd_cuda.probe_gather_plain(psim.operands, whole, ref)
    total = torch.zeros_like(ref)
    for rank in range(4):
        sh = fdtd_shard.build_shard_stepper(psim, 4, rank)
        st = sh.new_state()
        lo = rank * sh.n - sh.W
        for t, a in zip(st.fields, fields):  # every slab row, halos too
            s0, s1 = max(0, lo), min(Px, lo + sh.m)
            t[s0 - lo:s1 - lo].copy_(torch.from_numpy(a[s0:s1]))
        part = torch.zeros_like(ref)
        fdtd_cuda.probe_gather(sh.ops, st, part)
        total += part
    torch.testing.assert_close(total, ref, rtol=1e-5, atol=1e-5)


def test_wrapper_runs_the_twin_on_cpu_and_checks_its_window():
    _, psim = _sims("small", "PEC", 2, 45)
    sh = fdtd_shard.build_shard_stepper(psim, 2, 0)
    a, b = sh.new_state(), sh.new_state()
    for x, y in zip(a.fields, b.fields):
        x.normal_(generator=torch.Generator().manual_seed(1))
        y.copy_(x)
    fdtd_shard.reset_launch_counts()
    fdtd_shard.shard_steps(sh.ops, a, [0.1, 0.2, 0.3])
    fdtd_shard.shard_steps_plain(sh.ops, b, [0.1, 0.2, 0.3])
    assert a.parity == b.parity == 1
    for x, y in zip(a.fields, b.fields):
        assert torch.equal(x, y)
    assert fdtd_shard.launches == {"shard_steps": 0}
    with pytest.raises(ValueError, match="samples"):
        fdtd_shard.shard_steps(sh.ops, a, [])
    with pytest.raises(ValueError, match="samples"):
        fdtd_shard.shard_steps(sh.ops, a, [0.0] * (fdtd_shard.MAX_K + 1))


def test_geometry_rejects_what_it_cannot_split():
    with pytest.raises(ValueError, match="pad_multiple"):
        fdtd_shard.shard_geometry(22, 22, 45, 4, True)
    with pytest.raises(ValueError, match=">= 2 rows"):
        fdtd_shard.shard_geometry(8, 8, 45, 8, True)
    with pytest.raises(ValueError, match="k_steps"):
        fdtd_shard.shard_geometry(24, 22, 9, 4, True, k_steps=7)
    # the straddle rule: (Qx − 1) % n == 0 under MUR only
    assert fdtd_shard.shard_geometry(16, 13, 4, 4, True) == (4, 3, 4, 12, 1)
    assert fdtd_shard.shard_geometry(16, 13, 4, 4, False) == (4, 4, 4, 12, 0)
    # the canonical patch on one rank: K = 32, m = 120, 3 launches per 89
    assert fdtd_shard.shard_geometry(56, 56, 89, 1, True) == (56, 32, 32, 120, 25)
