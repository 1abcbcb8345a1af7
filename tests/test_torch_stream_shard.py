"""K2's slab stepper (the counterpart of ``shard=``) on the CPU.

``fdtd_stream.build_stream_shard_stepper`` cuts one rank's halo-extended
x-slab for the explicit run at Pz > 128; ``stream_shard_steps`` advances
it T steps (on the CPU with ``fdtd_shard.shard_steps_plain``). Checked
here: the slab geometry keeps the JAX package's constraints (T + 1 ≤ n,
T ≤ D, rem = D % T, W = T + 1); the slab probe tables' partial samples
add up to the whole grid's; the wrapper runs the twin on CPU tensors and
counts no launch; and probe-sampled runs against the JAX package's
``shard=`` stream kernel in interpret mode on a 1-device mesh, under MUR
and under CPML (the ψ too), at rtol 2e-4 and atol 1e-5·max|ref|.
"""

import numpy as np
import pytest
import torch

from _explicit_jax import jax_explicit
from _explicit_ranks import assert_close_surface, port_sim
from fdtd_solver_antennas_tpu_torch.ops import fdtd_cuda, fdtd_shard, fdtd_stream
from fdtd_solver_antennas_tpu_torch.parallel import build_explicit_run

RTOL, ATOL_REL = 2e-4, 1e-5
MIXED_YZ = (201, 152)  # the mixed patch+horn scene's y-z extent
TALL_YZ = (121, 160)  # the tall patch's


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Test workers share the cores (pytest-xdist)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("Px,n_dev,D,mur,pml,yz", [
    (141, 1, 500, True, False, MIXED_YZ),  # the mixed scene, one rank
    (144, 4, 500, True, False, MIXED_YZ),
    (162, 2, 50, True, False, TALL_YZ),
    (162, 1, 50, False, True, TALL_YZ),  # the tall grid under CPML
    (16, 4, 10, True, False, (16, 131)),  # n = 4: T ≤ n − 1 binds
    (16, 1, 3, False, False, (16, 131)),  # T ≤ D binds
    (20, 4, 10, False, True, (21, 131)),
])
def test_geometry_keeps_the_jax_constraints(Px, n_dev, D, mur, pml, yz):
    n, T, W, m, rem = fdtd_stream.stream_shard_geometry(
        Px, *yz, D, n_dev, mur, pml)
    assert n == Px // n_dev
    assert 1 <= T and T + 1 <= n and T <= D and T <= fdtd_stream.MAX_T
    assert (W, m, rem) == (T + 1, n + 2 * T + 2, D % T)
    # the deepest T both kernels take at the slab's shape
    assert T <= fdtd_stream.max_T((m, *yz), mur, pml)
    deeper = T + 1
    if deeper <= min(n - 1, D, fdtd_stream.MAX_T):
        with pytest.raises(ValueError):
            fdtd_stream.stream_shard_geometry(Px, *yz, D, n_dev, mur, pml,
                                              t_steps=deeper)
    if T > 1:  # a shallower T is taken as asked
        assert fdtd_stream.stream_shard_geometry(
            Px, *yz, D, n_dev, mur, pml, t_steps=T - 1)[1] == T - 1


def test_geometry_at_the_large_grids():
    """The mixed scene at one rank: T = 4 (the single-card march's), a slab
    of 141 + 2·5 = 151 rows; the tall grid under PML_8: T = 4."""
    assert fdtd_stream.stream_shard_geometry(141, *MIXED_YZ, 500, 1, True,
                                             False) == (141, 4, 5, 151, 0)
    assert fdtd_stream.stream_shard_geometry(162, *TALL_YZ, 48, 1, False,
                                             True) == (162, 4, 5, 172, 0)


def test_geometry_rejects_what_it_cannot_split():
    with pytest.raises(ValueError, match="pad_multiple"):
        fdtd_stream.stream_shard_geometry(22, 16, 131, 10, 4, True, False)
    with pytest.raises(ValueError, match=">= 2 rows"):
        fdtd_stream.stream_shard_geometry(8, 16, 131, 10, 8, True, False)
    with pytest.raises(ValueError, match="T=9"):
        fdtd_stream.stream_shard_geometry(16, 16, 131, 10, 1, True, False,
                                          t_steps=9)
    with pytest.raises(ValueError, match="rank 4"):
        fdtd_stream.build_stream_shard_stepper(
            port_sim("tall_z", "MUR_1", 4), 4, 4, "cpu")


@pytest.mark.parametrize("kind,boundary,n_dev", [
    ("tall_z", "PML_4", 4), ("tall_z", "MUR_1", 2), ("tall_straddle", "MUR_1", 4),
])
def test_slab_probe_tables_sum_to_the_global_samples(kind, boundary, n_dev):
    """Each rank samples only its own rows; the partial samples of the
    slabs add up to the whole grid's probe values."""
    sim = port_sim(kind, boundary, n_dev)
    Px, Py, Pz = sim.padded_shape
    assert Pz > fdtd_shard.MAX_PZ
    rng = np.random.default_rng(7)
    fields = rng.standard_normal((6, Px, Py, Pz)).astype(np.float32)
    whole = fdtd_cuda.new_state(sim.padded_shape, "cpu", pml=False)
    for t, a in zip(whole.fields, fields):
        t.copy_(torch.from_numpy(a))
    ref = torch.zeros(sim.operands.probes.n_rows)
    fdtd_cuda.probe_gather_plain(sim.operands, whole, ref)
    total = torch.zeros_like(ref)
    for rank in range(n_dev):
        sh = fdtd_stream.build_stream_shard_stepper(sim, n_dev, rank, "cpu")
        assert sh.W == sh.K + 1 and sh.ops.shape == (sh.m, Py, Pz)
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
    sim = port_sim("tall_straddle", "MUR_1", 4, decim=4)
    sh = fdtd_stream.build_stream_shard_stepper(sim, 4, 3, "cpu")
    assert (sh.n, sh.K, sh.W, sh.m, sh.rem) == (4, 3, 4, 12, 1)
    assert sh.ops.mur_x_rows == (-8, 4)  # the straddle: the first owned row
    a, b = sh.new_state(), sh.new_state()
    for x, y in zip(a.fields, b.fields):
        x.normal_(generator=torch.Generator().manual_seed(3))
        y.copy_(x)
    fdtd_stream.reset_launch_counts()
    fdtd_stream.stream_shard_steps(sh.ops, a, [0.1, 0.2, 0.3])
    fdtd_shard.shard_steps_plain(sh.ops, b, [0.1, 0.2, 0.3])
    for x, y in zip(a.fields, b.fields):
        assert torch.equal(x, y)
    assert fdtd_stream.launches == dict.fromkeys(fdtd_stream.KERNELS, 0)
    with pytest.raises(ValueError, match="samples"):
        fdtd_stream.stream_shard_steps(sh.ops, a, [])
    with pytest.raises(ValueError, match="samples"):
        fdtd_stream.stream_shard_steps(sh.ops, a, [0.0] * (fdtd_stream.MAX_T + 1))
    with pytest.raises(ValueError, match="slab operands"):
        fdtd_stream.stream_shard_steps(
            sim.operands, fdtd_cuda.new_state(sim.padded_shape, "cpu", False),
            [0.1])


def test_one_rank_matches_the_jax_shard_stream_kernel():
    """The port's explicit run at Pz = 131 on one rank against the JAX
    package's explicit run on a 1-device mesh, whose route at Pz > 128 is
    its ``shard=`` stream kernel, here in interpret mode (about 10 s): two
    probe intervals of D = 10 under MUR. The slab is 16 rows wide in y, so
    the march's region takes T = 8 (8 + 2 steps an interval)."""
    ctl = dict(n_steps=20, check_every=20)
    ref = jax_explicit("tall_z", "MUR_1", 1, **ctl)
    run = build_explicit_run(port_sim("tall_z", "MUR_1", 1, **ctl))
    assert (run.kernel_window, run.stepper.W, run.stepper.rem) == (8, 9, 2)
    assert_close_surface(run(), ref, RTOL, ATOL_REL)


def test_one_rank_matches_the_jax_shard_stream_kernel_under_cpml():
    """As above under PML_4 (the slab march's CPML route; ψ compared),
    four probe intervals of D = 10, about 45 s. At 40 steps every near
    field face carries signal: at 20 the first H face holds 8e-9 against
    9e-5 on the next, and float32 rounding of the terms it sums (the
    port's single-card run differs there from the JAX package by as much
    as its explicit run does) exceeds 1e-5 of that. The ψ slots and the
    staged ca/cb ring bound the CPML march's T at 5 here (two launches of
    5 steps an interval; at T = 6 the 16×26 region passes the fixed
    stride of ``fdtd_stream.cpml_stride(6)``)."""
    ctl = dict(n_steps=40, check_every=40)
    ref = jax_explicit("tall_z", "PML_4", 1, **ctl)
    run = build_explicit_run(port_sim("tall_z", "PML_4", 1, **ctl))
    assert (run.kernel_window, run.stepper.W, run.stepper.rem) == (5, 6, 0)
    assert 16 * 26 > fdtd_stream.cpml_stride(6) and 16 * 24 <= fdtd_stream.cpml_stride(5)
    out = run()
    assert set(out["state"]["psi_e"]) and set(out["state"]["psi_h"])
    assert_close_surface(out, ref, RTOL, ATOL_REL)
