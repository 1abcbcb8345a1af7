"""The grouped probe table and its gather, on the CPU.

The probe rows are four blocks, each at its own width: port V, port I,
face E and face H (``ops/fdtd_cuda.py::ProbeTable``), stored term-major
with each entry's cell and component coded on the host. Only port V pads,
and only to its longest row. The scene here has two ports whose V rows
differ in length (a patch and a small horn through the multi-antenna
solver at mesh quality 1): its samples must be bit-equal to the first
design's gather over one table padded to the longest row, its slab tables
(the explicit path) must add up to them at one and two ranks, and a short
run must match the JAX package's, whose ``sample_probes`` gathers the
four blocks unpadded, at rtol 2e-4, atol 1e-5·max|ref| (the JAX package's
own kernel-vs-XLA tolerance).
"""

import dataclasses

import numpy as np
import pytest
import torch

import fdtd_solver_antennas_tpu.solvers.multi_patch_3d as jmulti_mod
from fdtd_solver_antennas_tpu.models.params import HornAntennaParams as JHorn
from fdtd_solver_antennas_tpu.models.params import PatchAntennaParams as JPatch
from fdtd_solver_antennas_tpu.ops.fdtd import rebuild_run_fn

import fdtd_solver_antennas_tpu_torch.solvers.multi_patch_3d as multi_mod
from fdtd_solver_antennas_tpu_torch.models.params import (
    HornAntennaParams,
    PatchAntennaParams,
)
from fdtd_solver_antennas_tpu_torch.ops import fdtd_cuda, fdtd_shard
from fdtd_solver_antennas_tpu_torch.ops.fdtd import build_probe_gathers, probe_blocks

RTOL = 2e-4
PATCH = dict(frequency_ghz=2.45, er=4.3, h_mm=1.6, loss_tangent=0.02)
# a horn just above its TE10 cutoff at 2.45 GHz, short, beside the patch
HORN = dict(frequency_ghz=2.45, throat_a_mm=70.0, throat_b_mm=35.0,
            aperture_A_mm=80.0, aperture_B_mm=50.0, length_mm=20.0)
KW = dict(mesh_quality=1, phi_step_deg=30.0, theta_step_deg=15.0,
          auto_margin_mm=(20.0, 20.0, 20.0))
PLACE = dict(center_x_m=0.12, rot_z_deg=30.0)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Test workers share the cores (pytest-xdist)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _prepare_port():
    p = multi_mod.prepare_multi_patch_3d(
        [multi_mod.PatchLike("p", PatchAntennaParams.from_user_units(**PATCH))],
        horns=[multi_mod.HornLike("h", HornAntennaParams.from_user_units(**HORN),
                                  **PLACE)],
        device="cpu", **KW)
    assert p.ok, p.message
    return p


@pytest.fixture(scope="module")
def two_ports():
    return _prepare_port().sim


def _padded_table(gathers, n_cells):
    """The first design's table: the four blocks stacked into one
    (rows, k) table, every row padded with weight 0 to the longest."""
    blocks = probe_blocks(gathers, n_cells)
    k = max(i.shape[1] for i, _ in blocks)
    idx = np.concatenate([np.pad(i, ((0, 0), (0, k - i.shape[1])))
                          for i, _ in blocks])
    w = np.concatenate([np.pad(x, ((0, 0), (0, k - x.shape[1])))
                        for _, x in blocks])
    return idx, w.astype(np.float32)


def _padded_gather(idx, w, fields):
    """The first design's gather: each row's k terms summed in order."""
    flat = torch.cat([f.reshape(-1) for f in fields])
    terms = flat[torch.from_numpy(idx)] * torch.from_numpy(w)
    acc = torch.zeros(idx.shape[0])
    for m in range(idx.shape[1]):
        acc = acc + terms[:, m]
    return acc


def _random_state(shape, seed):
    rng = np.random.default_rng(seed)
    st = fdtd_cuda.new_state(shape, "cpu", pml=False)
    for t in st.fields:
        t.copy_(torch.from_numpy(rng.standard_normal(shape).astype(np.float32)))
    return st


def test_the_scene_has_port_rows_of_different_lengths(two_ports):
    gathers = build_probe_gathers(two_ports)
    v_len = (gathers[7] != 0).sum(1)
    assert len(v_len) == 2 and v_len.min() < v_len.max()
    t = two_ports.operands.probes
    assert t.k[0] == v_len.max() and t.k[0] > max(t.k[1:])


@pytest.mark.parametrize("seed", [0, 1])
def test_grouped_gather_is_bit_equal_to_the_padded_one(two_ports, seed):
    sim = two_ports
    n = int(np.prod(sim.padded_shape))
    idx, w = _padded_table(build_probe_gathers(sim), n)
    st = _random_state(sim.padded_shape, seed)
    out = torch.full((sim.operands.probes.n_rows,), float("nan"))
    fdtd_cuda.probe_gather(sim.operands, st, out)
    ref = _padded_gather(idx, w, st.fields)
    assert torch.equal(out, ref)
    assert fdtd_cuda.launches["probe_gather"] == 0  # the CPU runs the twin


def test_table_bytes_are_the_sum_of_its_blocks(two_ports):
    """Each block keeps its own width: the bytes are 8 a term of each
    block's own rows × k, and only port V holds padding (weight 0)."""
    sim = two_ports
    t = sim.operands.probes
    g = build_probe_gathers(sim)
    widths = (g[6].shape[1], g[8].shape[1], g[0].shape[1], g[2].shape[1])
    rows = (g[6].shape[0], g[8].shape[0], g[0].shape[0], g[2].shape[0])
    assert t.k == widths == (t.k[0], 4, 2, 4) and t.rows == rows
    assert t.nbytes == 8 * sum(r * k for r, k in zip(rows, widths))
    assert t.code.dim() == t.w.dim() == 1
    assert t.code.dtype == torch.int32 and t.w.dtype == torch.float32
    zeros = [int((w == 0).sum()) for *_, w in t.blocks()]
    assert zeros[1:] == [0, 0, 0]
    v_len = (g[7] != 0).sum(1)
    assert zeros[0] == int((t.k[0] - v_len).sum()) > 0
    padded = 8 * sum(rows) * max(widths)
    assert t.nbytes < padded


def test_table_is_term_major_with_coded_cells(two_ports):
    """Term m of row r of block b sits at offsets[b] + m·rows[b] + r, its
    code the cell (upper bits) and component (lower 3) of the stack index
    the gathers give."""
    sim = two_ports
    n = int(np.prod(sim.padded_shape))
    t = sim.operands.probes
    for (r0, rows, k, code, w), (idx, wb) in zip(
            t.blocks(), probe_blocks(build_probe_gathers(sim), n), strict=True):
        code = code.numpy().astype(np.int64)
        np.testing.assert_array_equal((code & 7) * n + (code >> 3), idx.T)
        np.testing.assert_array_equal(w.numpy(), wb.T)
    assert t.row_starts == tuple(np.cumsum((0,) + t.rows))


def test_table_rejects_what_it_cannot_code():
    none = np.zeros((0, 0))
    with pytest.raises(ValueError, match="too many"):
        fdtd_cuda.ProbeTable.from_blocks([(none, none)] * 4, 2**28)
    with pytest.raises(ValueError, match="outside"):
        fdtd_cuda.ProbeTable.from_blocks(
            [(np.array([[12]]), np.ones((1, 1)))] + [(none, none)] * 3, 2)
    with pytest.raises(ValueError, match="probe blocks"):
        fdtd_cuda.ProbeTable.from_blocks([(none, none)] * 3, 2)
    empty = fdtd_cuda.ProbeTable.empty()
    assert empty.n_rows == 0 and empty.nbytes == 0


@pytest.mark.parametrize("n_dev", [1, 2])
def test_slab_tables_add_up_to_the_samples(two_ports, n_dev):
    """The explicit path's slab tables keep the blocks and their widths;
    their partial samples over the ranks' slabs add up to the whole
    grid's (bit for bit at one rank)."""
    sim = two_ports
    Px = sim.padded_shape[0]
    assert Px % n_dev == 0
    whole = _random_state(sim.padded_shape, seed=5)
    ref = torch.zeros(sim.operands.probes.n_rows)
    fdtd_cuda.probe_gather(sim.operands, whole, ref)
    total = torch.zeros_like(ref)
    for rank in range(n_dev):
        sh = fdtd_shard.build_shard_stepper(sim, n_dev, rank)
        t = sh.ops.probes
        assert (t.rows, t.k) == (sim.operands.probes.rows, sim.operands.probes.k)
        assert t.nbytes == sim.operands.probes.nbytes
        st = sh.new_state()
        lo = rank * sh.n - sh.W
        for dst, src in zip(st.fields, whole.fields):  # halos too
            s0, s1 = max(0, lo), min(Px, lo + sh.m)
            dst[s0 - lo:s1 - lo].copy_(src[s0:s1])
        part = torch.zeros_like(ref)
        fdtd_cuda.probe_gather(sh.ops, st, part)
        total += part
    if n_dev == 1:
        assert torch.equal(total, ref)
    else:
        torch.testing.assert_close(total, ref, rtol=1e-5, atol=1e-5)


def _close(a, b):
    a = a.numpy() if torch.is_tensor(a) else np.asarray(a)
    b = np.asarray(b)
    atol = 1e-5 * max(float(np.abs(b).max()), 1e-20)
    np.testing.assert_allclose(a, b, rtol=RTOL, atol=atol)


def test_short_run_matches_the_jax_package():
    """One probe interval of the two-port scene through the port (plain
    twins, the grouped table) and the JAX package (XLA, unpadded
    gathers): fields, port V/I and face DFTs, S11 per port."""
    p = _prepare_port()
    j = jmulti_mod.prepare_multi_patch_3d(
        [jmulti_mod.PatchLike("p", JPatch.from_user_units(**PATCH))],
        horns=[jmulti_mod.HornLike("h", JHorn.from_user_units(**HORN), **PLACE)],
        **KW)
    assert j.ok, j.message
    assert p.sim.grid.shape == j.sim.grid.shape
    assert p.sim.probe_decim == j.sim.probe_decim
    steps = p.sim.probe_decim
    for prep, jax_sim in ((p, False), (j, True)):
        prep.sim.cfg = dataclasses.replace(
            prep.sim.cfg, n_steps_max=steps, check_every=steps)
        if jax_sim:
            rebuild_run_fn(prep.sim)
    outs = {}
    for key, prep in (("port", p), ("jax", j)):
        real = prep.sim.run

        def run(*a, _real=real, _key=key, **kw):
            outs[_key] = _real(*a, **kw)
            return outs[_key]

        prep.sim.run = run
    p_res = multi_mod.run_prepared_multi_patch_3d(p, frequency_hz=2.45e9, verbose=0)
    j_res = jmulti_mod.run_prepared_multi_patch_3d(j, frequency_hz=2.45e9, verbose=0)
    po, jo = outs["port"], outs["jax"]
    assert int(po["steps"]) == int(jo["steps"]) == steps
    for a, b in zip(po["fields"], jo["fields"], strict=True):
        _close(a, b)
    for key in ("uf", "if_"):
        _close(po[key], jo[key])
    for key in ("nf_e", "nf_h"):
        for a, b in zip(po[key], jo[key], strict=True):
            _close(a, b)
    assert p_res.ok and j_res.ok, (p_res.message, j_res.message)
    for a, b in zip(p_res.diagnostics["s11_all_ports"],
                    j_res.diagnostics["s11_all_ports"], strict=True):
        _close(a, b)
