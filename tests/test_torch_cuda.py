"""The port's CUDA kernels against their plain PyTorch twins, on the card.

These tests need an NVIDIA GPU and skip elsewhere: a CUDA kernel has no
CPU mode. The file imports nothing of JAX, so it runs on the machine
with the card, where JAX is not installed (``tests/conftest.py`` imports
JAX, hence ``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import dataclasses

import numpy as np
import pytest
import torch

from fdtd_solver_antennas_tpu_torch.models.scene import Scene
from fdtd_solver_antennas_tpu_torch.ops import fdtd_cuda, fdtd_shard, fdtd_stream
from fdtd_solver_antennas_tpu_torch.ops.fdtd import (
    FDTDConfig,
    build_simulation,
    run_simulation,
)
from fdtd_solver_antennas_tpu_torch.ops.mesh import MeshBuilder

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CUDA kernels have no CPU mode)")
    return torch.device("cuda", torch.cuda.current_device())


def _sim(boundary, n_steps=120, decim=4, pad_x=1, device="cuda",
         mode=None):
    """The small scene of tests/test_pallas_kernel.py, on the card (or
    ``device``), its x extent padded to a multiple of ``pad_x``, its
    stepping kernels ``mode`` (None: as the resolver picks)."""
    mb = MeshBuilder()
    mb.add_line("x", [-40, 40, 0.0, -6.0])
    mb.add_line("y", [-40, 40, 0.0])
    mb.add_line("z", [-20, 30])
    mb.add_line("z", np.linspace(0, 1.6, 3))
    grid = mb.build(5.0)
    scene = Scene()
    scene.add_material_box("sub", 4.3, 0.005, [-20, -20, 0], [20, 20, 1.6], 0)
    scene.add_metal_box("patch", [-15, -12, 1.6], [15, 12, 1.6], priority=10)
    scene.add_metal_box("gnd", [-20, -20, 0], [20, 20, 0], priority=10)
    scene.add_lumped_port(1, 50.0, [-6, 0, 0], [-6, 0, 1.6], direction="z")
    cfg = FDTDConfig(n_steps_max=n_steps, check_every=n_steps,
                     end_criteria=1e-30, boundary=boundary,
                     probe_decimation=decim, pallas_mode=mode)
    return build_simulation(
        scene, grid, f0=2.45e9, fc=1.225e9, cfg=cfg, device=device,
        port_freqs_hz=np.linspace(2e9, 3e9, 11),
        nf_freqs_hz=np.array([2.45e9]), pad_multiple=(pad_x, 1, 1))


def _close(a, b, rtol=2e-4):
    """rtol 2e-4, atol 1e-5·max|plain|: the JAX package's own tolerance."""
    a = a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)
    b = b.cpu().numpy() if torch.is_tensor(b) else np.asarray(b)
    atol = 1e-5 * max(float(np.abs(b).max()), 1e-20)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


@pytest.mark.parametrize("boundary", ["MUR", "PEC", "PML_4"])
def test_chunk_through_kernels_matches_plain(cuda, boundary):
    sim = _sim(boundary)
    fdtd_cuda.reset_launch_counts()
    k = run_simulation(sim, fdtd_cuda.kernels)
    assert fdtd_cuda.launches == {"h_update": 0, "e_update": 0, "e_update_mur": 0,
                                  "mur_faces": 0,
                                  "probe_gather": 0, "chunk_steps": 1,
                                  "chunk_steps_batch": 0,
                                  "probe_gather_batch": 0}
    p = run_simulation(sim, fdtd_cuda.plain)
    assert k["steps"] == p["steps"] == 120
    for fa, fb in zip(k["fields"], p["fields"], strict=True):
        _close(fa, fb)
    for key in ("uf", "if_"):
        _close(k[key], p[key])
    for key in ("nf_e", "nf_h"):
        for a, b in zip(k[key], p[key], strict=True):
            _close(a, b)
    for grp in ("psi_e", "psi_h"):
        for name, v in p["state"][grp].items():
            _close(k["state"][grp][name], v)


def _psi_to_slabs(ops, st):
    """Each ψ of ``st`` 0 outside its slab, as every run leaves it: the
    march skips a ψ there (``fdtd_stream.psi_slabs``)."""
    if ops.pml is not None:
        for t, keep in zip((*st.psi_e, *st.psi_h), fdtd_stream.psi_slabs(ops)):
            t.masked_fill_(~keep, 0.0)


def _random_state(sim, device, seed):
    rng = np.random.default_rng(seed)
    st = fdtd_cuda.new_state(sim.padded_shape, device,
                             pml=sim.operands.pml is not None)
    for t in (*st.e[0], *st.e[1], *st.h, *st.psi_e, *st.psi_h):
        t.copy_(torch.from_numpy(rng.standard_normal(t.shape).astype(np.float32)))
    _psi_to_slabs(sim.operands, st)
    return st


def _clone(st):
    return fdtd_cuda.YeeState(
        e=[tuple(t.clone() for t in st.e[p]) for p in range(2)],
        h=tuple(t.clone() for t in st.h),
        psi_e=tuple(t.clone() for t in st.psi_e),
        psi_h=tuple(t.clone() for t in st.psi_h))


@pytest.mark.parametrize("boundary", ["MUR", "PML_4"])
def test_each_kernel_equals_its_twin_bit_for_bit(cuda, boundary):
    """Built without fused multiply-add, the field kernels round like the
    plain ops, cell for cell (h/e with CPML ψ, and the MUR walls)."""
    sim = _sim(boundary)
    ops = sim.operands
    base = _random_state(sim, cuda, seed=3)
    steps = [lambda m, st: m.h_update(ops, st),
             lambda m, st: m.e_update(ops, st, 0.37)]
    if boundary == "MUR":
        steps.append(lambda m, st: [m.mur_faces(ops, st, a) for a in range(3)])
    for step in steps:
        a, b = _clone(base), _clone(base)
        step(fdtd_cuda.kernels, a)
        step(fdtd_cuda.plain, b)
        for x, y in zip((*a.e[1], *a.h, *a.psi_e, *a.psi_h),
                        (*b.e[1], *b.h, *b.psi_e, *b.psi_h), strict=True):
            assert torch.equal(x, y)


def _guarded_state(shape, device, pml, seed):
    """A random state whose tensors are rows [1, m + 1) of larger tensors
    (contiguous views): the guard rows 0 and m + 1 hold a sentinel, so a
    write past either end of the slab shows."""
    rng = np.random.default_rng(seed)
    m = shape[0]
    bigs = []

    def t():
        big = torch.full((m + 2, *shape[1:]), 7.5, device=device)
        big[1:m + 1].copy_(torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)))
        bigs.append(big)
        return big[1:m + 1]

    psi = (lambda: tuple(t() for _ in range(6))) if pml else (lambda: ())
    st = fdtd_cuda.YeeState(e=[(t(), t(), t()), (t(), t(), t())],
                            h=(t(), t(), t()), psi_e=psi(), psi_h=psi())
    return st, bigs


@pytest.mark.parametrize("case", ["whole", "one-rank slab", "rank 0 of 4",
                                  "rank 3 of 4", "x-y block"])
def test_mur_faces_on_slabs_equals_its_twin(cuda, case):
    """``mur_faces`` places its walls from ``YeeOperands.mur_walls``: on a
    whole grid rows 0 and q − 1 (K1's per-step route); on a slab or block
    where the global walls fall, a wall outside it skipped. Bit-equal to
    the twin on every cell, the guard rows around the slab untouched. The
    slabs are the walk's (one halo row a side) of the straddle scene of
    tests/_explicit_ranks.py: at 4 ranks rank 0 holds the bottom wall
    only, rank 3 the top wall on its first owned row (its inward
    neighbour in the halo row); at one rank both walls lie inside."""
    from _explicit_ranks import port_sim

    n_dev, rank, y = {"whole": (1, 0, None), "rank 0 of 4": (4, 0, None),
                      "rank 3 of 4": (4, 3, None), "one-rank slab": (1, 0, None),
                      "x-y block": (2, 1, (1, 8, 1))}[case]
    sim = port_sim("straddle", "MUR", n_dev, device="cuda")
    ops = sim.operands if case == "whole" else fdtd_shard.slab_operands(
        sim, rank, sim.padded_shape[0] // n_dev, 1, cuda, y=y)
    if case == "rank 3 of 4":
        assert ops.mur_x_rows == (-11, 1)  # the top wall on the first owned row
    if case == "x-y block":
        assert ops.mur_y_rows == (-7, 8)
    a, big_a = _guarded_state(ops.shape, cuda, False, seed=5)
    b, big_b = _guarded_state(ops.shape, cuda, False, seed=5)
    fdtd_cuda.reset_launch_counts()
    for axis in range(3):
        fdtd_cuda.mur_faces(ops, a, axis)
        fdtd_cuda.plain.mur_faces(ops, b, axis)
    torch.cuda.synchronize()
    assert fdtd_cuda.launches["mur_faces"] == 3
    for x, y_ in zip(big_a, big_b, strict=True):
        assert torch.equal(x, y_)
        assert (x[0] == 7.5).all() and (x[-1] == 7.5).all()


@pytest.mark.parametrize("case", ["canonical", "canonical PEC", "small PML_4",
                                  "whole", "one-rank slab", "rank 0 of 4",
                                  "rank 2 of 4", "rank 3 of 4", "x-y block"])
def test_e_update_mur_equals_its_twin(cuda, case):
    """``e_update_mur`` (one launch: E and the MUR walls of x, y and z)
    against ``e_update_mur_plain`` (``e_update_plain``, then
    ``mur_faces_plain`` per axis), bit for bit: on the canonical grid, on
    the slabs and the block of ``test_mur_faces_on_slabs_equals_its_twin``
    (rank 2 of 4: the top wall on its upper halo row), the guard rows
    around a slab untouched; without walls (PEC, CPML with its ψ) the
    kernel is ``e_update``."""
    from _explicit_ranks import port_sim

    if case.startswith(("canonical", "small")):
        sim = (_canonical_sim("PEC" if "PEC" in case else "MUR")
               if case.startswith("canonical") else _sim("PML_4"))
        ops = sim.operands
        a = _random_state(sim, cuda, seed=11)
        b, bigs = _clone(a), None
    else:
        n_dev, rank, y = {"whole": (1, 0, None), "one-rank slab": (1, 0, None),
                          "rank 0 of 4": (4, 0, None), "rank 2 of 4": (4, 2, None),
                          "rank 3 of 4": (4, 3, None),
                          "x-y block": (2, 1, (1, 8, 1))}[case]
        sim = port_sim("straddle", "MUR", n_dev, device="cuda")
        ops = sim.operands if case == "whole" else fdtd_shard.slab_operands(
            sim, rank, sim.padded_shape[0] // n_dev, 1, cuda, y=y)
        if case == "rank 2 of 4":
            assert ops.mur_x_rows == (-7, 5)  # the top wall on the halo row
        a, bigs = _guarded_state(ops.shape, cuda, False, seed=5)
        b, big_b = _guarded_state(ops.shape, cuda, False, seed=5)
    fdtd_cuda.reset_launch_counts()
    fdtd_cuda.e_update_mur(ops, a, 0.37)
    fdtd_cuda.plain.e_update_mur(ops, b, 0.37)
    torch.cuda.synchronize()
    assert fdtd_cuda.launches["e_update_mur"] == 1
    assert sum(fdtd_cuda.launches.values()) == 1
    if bigs is not None:
        for x, y_ in zip(bigs, big_b, strict=True):
            assert torch.equal(x, y_)
            assert (x[0] == 7.5).all() and (x[-1] == 7.5).all()
    for x, y_ in zip((*a.e[0], *a.e[1], *a.h, *a.psi_e, *a.psi_h),
                     (*b.e[0], *b.e[1], *b.h, *b.psi_e, *b.psi_h), strict=True):
        assert torch.equal(x, y_)


@pytest.mark.parametrize("boundary", ["MUR", "PEC", "PML_4"])
def test_walk_on_one_card_matches_chunk_mode(cuda, boundary):
    """The per-step walk on one rank takes no straddle, so it launches only
    ``h_update`` and ``e_update_mur`` a step (E and the MUR walls fused;
    under PEC and CPML the same kernel without walls) and ``probe_gather``
    an interval: no ``e_update`` and no ``mur_faces``; it matches the
    chunk-mode run."""
    from fdtd_solver_antennas_tpu_torch.parallel import build_explicit_run

    sim = _sim(boundary, decim=12)
    run = build_explicit_run(sim, use_kernel=False)
    assert run.stepper.fused
    fdtd_cuda.reset_launch_counts()
    fdtd_shard.reset_launch_counts()
    out = run()
    assert fdtd_cuda.launches == {"h_update": 120, "e_update": 0,
                                  "e_update_mur": 120, "mur_faces": 0,
                                  "probe_gather": 10, "chunk_steps": 0,
                                  "chunk_steps_batch": 0,
                                  "probe_gather_batch": 0}
    assert fdtd_shard.launches == {"shard_steps": 0}
    ref = sim.run()
    assert out["steps"] == ref["steps"] == 120
    for a, b in zip(out["fields"], ref["fields"], strict=True):
        _close(a, b)
    for key in ("uf", "if_"):
        _close(out[key], ref[key])


def _stream_sim(boundary, tall=False, T=None, n_steps=120, mode="stream",
                decim=4):
    """The scene of tests/test_stream_kernel.py (``tall``: 131 z lines),
    forced onto the stream kernel with ``T`` steps per launch."""
    mb = MeshBuilder()
    pml = boundary.startswith("PML")
    span = 52 if pml else 40
    mb.add_line("x", [-span, span, 0.0, -6.0])
    mb.add_line("y", [-span * 0.75, span * 0.75, 0.0])
    if tall:
        mb.add_line("z", np.linspace(-20, 30, 131))
    else:
        mb.add_line("z", [-20, 30])
        mb.add_line("z", np.linspace(0, 1.6, 3))
    grid = mb.build(4.0 if pml else 5.0)
    scene = Scene()
    scene.add_material_box("sub", 4.3, 0.005, [-20, -20, 0], [20, 20, 1.6], 0)
    scene.add_metal_box("patch", [-15, -12, 1.6], [15, 12, 1.6], priority=10)
    scene.add_metal_box("gnd", [-20, -20, 0], [20, 20, 0], priority=10)
    scene.add_lumped_port(1, 50.0, [-6, 0, 0], [-6, 0, 1.6], direction="z")
    cfg = FDTDConfig(n_steps_max=n_steps, check_every=40, end_criteria=1e-30,
                     boundary=boundary, probe_decimation=decim,
                     pallas_mode=mode, stream_T=T if mode == "stream" else None)
    return build_simulation(
        scene, grid, f0=2.45e9, fc=1.225e9, cfg=cfg, device="cuda",
        port_freqs_hz=np.linspace(2e9, 3e9, 7),
        nf_freqs_hz=np.array([2.45e9]))


@pytest.mark.parametrize("T", [1, 2, 4])
@pytest.mark.parametrize("boundary,tall", [("MUR", False), ("PEC", False),
                                           ("PML_4", False), ("MUR", True)])
def test_stream_steps_equals_its_twin(cuda, boundary, tall, T):
    """One launch of T steps on a random state against T plain steps;
    the launch writes the state's other field set."""
    sim = _stream_sim(boundary, tall, T)
    ops = sim.operands
    base = _random_state(sim, cuda, seed=5)
    wf = [0.37, -0.21, 0.55, 0.13][:T]
    a, b = _clone(base), _clone(base)
    before = a.h[0]
    fdtd_stream.reset_launch_counts()
    fdtd_stream.stream_steps(ops, a, wf)
    assert fdtd_stream.launches == {"stream_steps": 1, "stream_shard_steps": 0,
                                   "stream_steps_batch": 0}
    assert fdtd_stream.launches_by_kernel["stream_march"] == 1
    assert a.h[0] is not before
    fdtd_stream.stream_steps_plain(ops, b, wf)
    torch.cuda.synchronize()
    for x, y in zip((*a.e[a.parity], *a.h, *a.psi_e, *a.psi_h),
                    (*b.e[b.parity], *b.h, *b.psi_e, *b.psi_h), strict=True):
        _close(x, y)


def test_stream_steps_refuses_psi_outside_slabs(cuda):
    """The march skips a ψ outside its slab, so a state whose ψ is not 0
    there raises at its first launch, before any kernel runs, where the
    twin would step it."""
    sim = _stream_sim("PML_4", False, 4)
    ops = sim.operands
    st = _random_state(sim, cuda, seed=7)
    keep = fdtd_stream.psi_slabs(ops)[7].flatten()  # psi_h[1]: its axis z
    st.psi_h[1][3, 2, int(torch.nonzero(~keep)[0])] = 0.5
    fdtd_stream.reset_launch_counts()
    with pytest.raises(ValueError, match=r"psi_h\[1\]"):
        fdtd_stream.stream_steps(ops, st, [0.37, -0.21, 0.55, 0.13])
    assert fdtd_stream.launches_by_kernel["stream_march"] == 0


@pytest.mark.parametrize("boundary", ["MUR", "PEC", "PML_4"])
def test_stream_run_matches_plain_and_chunk(cuda, boundary):
    """A forced stream run through the kernel equals the same run through
    the plain twins and the chunk kernels; every launch is counted."""
    sim = _stream_sim(boundary, T=4)
    assert sim.pallas_mode == "stream" and sim.stream_T == 4
    fdtd_stream.reset_launch_counts()
    fdtd_cuda.reset_launch_counts()
    k = run_simulation(sim, fdtd_stream.kernels)
    assert fdtd_stream.launches["stream_steps"] == 120 // 4
    assert fdtd_stream.launches_by_kernel == {
        "stream_march": 120 // 4, "shard_march": 0, "stream_march_batch": 0}
    assert fdtd_cuda.launches["probe_gather"] == 120 // 4
    assert fdtd_cuda.launches["h_update"] == 0
    p = run_simulation(sim, fdtd_stream.plain)
    c = run_simulation(_stream_sim(boundary, mode="chunk"), fdtd_cuda.kernels)
    for ref in (p, c):
        assert k["steps"] == ref["steps"] == 120
        for fa, fb in zip(k["fields"], ref["fields"], strict=True):
            _close(fa, fb)
        for key in ("uf", "if_"):
            _close(k[key], ref[key])
        for key in ("nf_e", "nf_h"):
            for a, b in zip(k[key], ref[key], strict=True):
                _close(a, b)
        for grp in ("psi_e", "psi_h"):
            for name, v in ref["state"][grp].items():
                _close(k["state"][grp][name], v)


def test_stream_pml8_run_matches_chunk(cuda):
    """The canonical patch under PML_8 forced onto the stream path (the
    CPML march, T = 4: 120 launches, nothing else steps) equals the same
    480 steps in chunk mode (K1): fields, ψ, port and near-field samples."""
    from fdtd_solver_antennas_tpu_torch.models.params import PatchAntennaParams
    from fdtd_solver_antennas_tpu_torch.solvers.patch_fixed import build_patch_scene

    scene, grid, f0, fc = build_patch_scene(PatchAntennaParams.from_user_units(
        frequency_ghz=2.45, er=4.3, h_mm=1.6, loss_tangent=0.02))

    def sim(mode):
        cfg = FDTDConfig(n_steps_max=480, check_every=480, end_criteria=1e-30,
                         boundary="PML_8", probe_decimation=48,
                         pallas_mode=mode, stream_T=4 if mode == "stream" else None)
        return build_simulation(scene, grid, f0=f0, fc=fc, cfg=cfg,
                                device="cuda",
                                port_freqs_hz=np.linspace(2e9, 3e9, 11),
                                nf_freqs_hz=np.array([2.45e9]))

    stream = sim("stream")
    assert stream.pallas_mode == "stream" and stream.stream_T == 4
    fdtd_stream.reset_launch_counts()
    fdtd_cuda.reset_launch_counts()
    k = run_simulation(stream, fdtd_stream.kernels)
    assert fdtd_stream.launches_by_kernel == {
        "stream_march": 120, "shard_march": 0, "stream_march_batch": 0}
    assert fdtd_cuda.launches["chunk_steps"] == 0
    c = run_simulation(sim("chunk"), fdtd_cuda.kernels)
    assert k["steps"] == c["steps"] == 480
    for fa, fb in zip(k["fields"], c["fields"], strict=True):
        _close(fa, fb)
    for key in ("uf", "if_"):
        _close(k[key], c[key])
    for key in ("nf_e", "nf_h"):
        for x, y in zip(k[key], c[key], strict=True):
            _close(x, y)
    for grp in ("psi_e", "psi_h"):
        for name, v in c["state"][grp].items():
            _close(k["state"][grp][name], v)


def _lone_sim(boundary, T):
    """43×33×49 lines: with the march's 16×16 core, y and z end on the
    lone-plane shift (n % 16 == 1), and x is cut into 3-plane segments
    (43 % 3 == 1) that shift too."""
    mb = MeshBuilder()
    mb.add_line("x", np.linspace(-21, 21, 43))
    mb.add_line("y", np.linspace(-16, 16, 33))
    mb.add_line("z", np.linspace(-24, 24, 49))
    grid = mb.build(4.0)
    scene = Scene()
    scene.add_material_box("sub", 4.3, 0.005, [-10, -10, 0], [10, 10, 2], 0)
    scene.add_metal_box("patch", [-8, -6, 2], [8, 6, 2], priority=10)
    scene.add_metal_box("gnd", [-10, -10, 0], [10, 10, 0], priority=10)
    scene.add_lumped_port(1, 50.0, [-6, 0, 0], [-6, 0, 2], direction="z")
    cfg = FDTDConfig(n_steps_max=120, check_every=40, end_criteria=1e-30,
                     boundary=boundary, probe_decimation=T,
                     pallas_mode="stream", stream_T=T)
    return build_simulation(
        scene, grid, f0=2.45e9, fc=1.225e9, cfg=cfg, device="cuda",
        port_freqs_hz=np.linspace(2e9, 3e9, 7),
        nf_freqs_hz=np.array([2.45e9]))


_MARCH_CASES = [(b, sc, T) for b in ("MUR", "PEC", "PML_4")
                for sc in ("small", "z131", "lone")
                for T in range(1, 6 if b == "PEC" else 5)]


@pytest.mark.parametrize("boundary,scene,T", _MARCH_CASES)
def test_stream_march_equals_its_twin(cuda, boundary, scene, T):
    """One march launch of T steps on a random state against T plain
    steps (rtol 2e-4, atol 1e-5·max|plain|), on grids cut into several x
    segments; the lone-plane grid shifts its cut on every axis. Under
    CPML the ψ too."""
    sim = (_lone_sim(boundary, T) if scene == "lone"
           else _stream_sim(boundary, scene == "z131", T, decim=T))
    ops = sim.operands
    mur = boundary == "MUR"
    _, origin, _, (_, seg_origin, segs), smem = fdtd_stream.march_plan(
        ops.shape, ops.grid_shape, T, mur, pml=ops.pml is not None)
    assert segs >= 2 and smem <= fdtd_stream.SMEM_LIMIT
    if scene == "lone":
        assert tuple(ops.shape) == (43, 33, 49)
        assert (origin, seg_origin) == (((1, 1), 1) if mur else ((0, 0), 0))
    base = _random_state(sim, cuda, seed=43 + T)
    wf = [0.37, -0.21, 0.55, 0.13, -0.4][:T]
    a, b = _clone(base), _clone(base)
    fdtd_stream.reset_launch_counts()
    fdtd_stream.stream_steps(ops, a, wf)
    assert fdtd_stream.launches_by_kernel == {
        "stream_march": 1, "shard_march": 0, "stream_march_batch": 0}
    fdtd_stream.stream_steps_plain(ops, b, wf)
    torch.cuda.synchronize()
    for x, y in zip((*a.e[a.parity], *a.h, *a.psi_e, *a.psi_h),
                    (*b.e[b.parity], *b.h, *b.psi_e, *b.psi_h), strict=True):
        _close(x, y)


@pytest.mark.parametrize("boundary", ["MUR", "PEC"])
def test_stream_march_run_on_the_lone_plane_grid_matches_chunk(cuda, boundary):
    """A 120-step stream run through the march on the lone-plane grid
    equals the same run through K1's chunk kernels."""
    sim = _lone_sim(boundary, 4)
    fdtd_stream.reset_launch_counts()
    k = run_simulation(sim, fdtd_stream.kernels)
    assert fdtd_stream.launches_by_kernel["stream_march"] == 120 // 4
    chunk = dataclasses.replace(sim, pallas_mode="chunk", stream_T=1)
    c = run_simulation(chunk, fdtd_cuda.kernels)
    assert k["steps"] == c["steps"] == 120
    for fa, fb in zip(k["fields"], c["fields"], strict=True):
        _close(fa, fb)
    for key in ("uf", "if_"):
        _close(k[key], c[key])
    for key in ("nf_e", "nf_h"):
        for a, b in zip(k[key], c[key], strict=True):
            _close(a, b)


def test_march_shared_memory_formula_matches_the_kernel(cuda):
    for boundary in ("MUR", "PEC"):
        sim = _stream_sim(boundary, tall=True, T=4)
        st = fdtd_cuda.new_state(sim.padded_shape, cuda, pml=False)
        fdtd_stream.stream_steps(sim.operands, st, [0.0] * 4)
        lib = fdtd_stream._library()
        mur = boundary == "MUR"
        for T in range(1, fdtd_stream.max_T(sim.padded_shape, mur, False) + 1):
            plan = fdtd_stream.march_plan(sim.padded_shape, sim.grid.shape, T, mur)
            for i in range(2):
                assert lib.fdtd_march_smem_bytes(st._stream.addr[i], T) == plan[4]


def test_stream_shared_memory_formula_matches_the_kernel(cuda):
    """The CPML march's shared memory (E and H rings, T ψ slots of twelve
    floats a cell): C and ``march_plan`` agree at every T it takes."""
    sim = _stream_sim("PML_4", tall=True, T=4)
    st = fdtd_cuda.new_state(sim.padded_shape, cuda, pml=True)
    fdtd_stream.stream_steps(sim.operands, st, [0.0] * 4)
    lib = fdtd_stream._library()
    for T in range(1, fdtd_stream.max_T(sim.padded_shape, False, True) + 1):
        plan = fdtd_stream.march_plan(sim.padded_shape, sim.grid.shape, T,
                                      False, pml=True)
        for i in range(2):
            assert lib.fdtd_march_smem_bytes(st._stream.addr[i], T) == plan[4]
        assert fdtd_stream.blocks_per_sm(st, T) >= 1


def test_wrappers_reject_bad_operands(cuda):
    sim = _sim("MUR")
    st = fdtd_cuda.new_state(sim.padded_shape, cuda, pml=False)
    out = torch.zeros(sim.operands.probes.n_rows + 1, device=cuda)
    with pytest.raises(ValueError, match="shape"):
        fdtd_cuda.probe_gather(sim.operands, st, out)
    bad = fdtd_cuda.new_state(sim.padded_shape, cuda, pml=False)
    bad.h = (bad.h[0].double(), bad.h[1], bad.h[2])
    with pytest.raises(ValueError, match="float32"):
        fdtd_cuda.h_update(sim.operands, bad)
    pec = _sim("PEC")
    with pytest.raises(ValueError, match="MUR"):
        fdtd_cuda.mur_faces(pec.operands, st, 0)


@pytest.mark.parametrize("boundary,n_dev,rank,window", [
    ("MUR", 1, 0, "K"), ("MUR", 1, 0, "rem"), ("PEC", 4, 2, "K"),
    ("PML_4", 4, 1, "K"), ("PML_4", 4, 0, "rem"), ("MUR", 4, 3, "rem"),
])
def test_shard_steps_equals_its_twin(cuda, boundary, n_dev, rank, window):
    """One cooperative launch of k steps on a random slab state against k
    plain steps, bit for bit on the owned rows. Px = 19 (20 at 4 ranks):
    one rank takes K = 19 with remainder 7 of D = 45, four ranks K = 5
    with remainder 4 of D = 9."""
    sim = _sim(boundary, decim=45 if n_dev == 1 else 9, pad_x=n_dev)
    sh = fdtd_shard.build_shard_stepper(sim, n_dev, rank)
    k = sh.K if window == "K" else sh.rem
    assert k >= 1
    rng = np.random.default_rng(23 + rank)
    a = sh.new_state()
    for t in (*a.e[0], *a.e[1], *a.h, *a.psi_e, *a.psi_h):
        t.copy_(torch.from_numpy(rng.standard_normal(t.shape).astype(np.float32)))
    b = _clone(a)
    wf = list(rng.uniform(-1.0, 1.0, k))
    fdtd_shard.reset_launch_counts()
    fdtd_shard.shard_steps(sh.ops, a, wf)
    assert fdtd_shard.launches == {"shard_steps": 1}
    fdtd_shard.shard_steps_plain(sh.ops, b, wf)
    torch.cuda.synchronize()
    assert a.parity == b.parity == k & 1
    for x, y in zip((*a.e[a.parity], *a.h, *a.psi_e, *a.psi_h),
                    (*b.e[b.parity], *b.h, *b.psi_e, *b.psi_h), strict=True):
        assert torch.equal(x[sh.owned], y[sh.owned])


@pytest.mark.parametrize("boundary", ["MUR", "PEC", "PML_4"])
def test_explicit_run_on_one_card_equals_chunk_mode(cuda, boundary):
    """The explicit path on one rank launches only the shard kernel and
    K1's probe gather, and equals the chunk-mode run."""
    from fdtd_solver_antennas_tpu_torch.parallel import build_explicit_run

    sim = _sim(boundary, decim=12)
    run = build_explicit_run(sim)
    assert run.kernel_window == 12 and sim.operands.shape[0] >= 12
    fdtd_cuda.reset_launch_counts()
    fdtd_shard.reset_launch_counts()
    out = run()
    assert fdtd_shard.launches == {"shard_steps": 120 // 12}
    assert fdtd_cuda.launches == {"h_update": 0, "e_update": 0, "e_update_mur": 0,
                                  "mur_faces": 0,
                                  "probe_gather": 120 // 12, "chunk_steps": 0,
                                  "chunk_steps_batch": 0,
                                  "probe_gather_batch": 0}
    assert out["fields"][0].device.type == "cuda"
    ref = sim.run()
    assert out["steps"] == ref["steps"] == 120
    for a, b in zip(out["fields"], ref["fields"], strict=True):
        assert torch.equal(a, b)
    for key in ("uf", "if_"):
        _close(out[key], ref[key])
    for key in ("nf_e", "nf_h"):
        for a, b in zip(out[key], ref[key], strict=True):
            _close(a, b)


def _z131_sim(kind, boundary, n_dev, decim):
    """Pz > 128, K2's slab route on the explicit path: a scene of
    tests/_explicit_ranks.py on the card, ``tall_z`` (16×16×131) or
    ``tall_straddle`` (13 x lines: at 4 ranks, Px = 16, n = 4, the top MUR
    wall is the last rank's first row)."""
    from _explicit_ranks import port_sim

    return port_sim(kind, boundary, n_dev, decim=decim, check_every=120,
                    device="cuda")


@pytest.mark.parametrize("boundary,n_dev,rank,window,straddle", [
    ("MUR", 1, 0, "T", False), ("MUR", 1, 0, "rem", False),
    ("PEC", 4, 2, "T", False), ("PML_4", 4, 1, "T", False),
    ("PML_4", 1, 0, "rem", False), ("MUR", 4, 0, "T", True),
    ("MUR", 4, 1, "T", True), ("MUR", 4, 2, "T", True),
    ("MUR", 4, 3, "T", True), ("MUR", 4, 3, "rem", True),
])
def test_stream_shard_steps_equals_its_twin(cuda, boundary, n_dev, rank,
                                            window, straddle):
    """One launch of K2's slab stepper (the march; under CPML with the
    ψ) on a random slab state against its plain
    twin, bit for bit on the owned rows; at 4 ranks of the straddle
    scene: rank 0 (the lower wall at slab row W), rank 1 (W = n: the
    lower wall on slab row 0), rank 2 (the upper wall in its upper halo)
    and rank 3 (the upper wall on its first owned row)."""
    sim = _z131_sim("tall_straddle" if straddle else "tall_z", boundary,
                    n_dev, decim=4 if straddle else 9)
    sh = fdtd_stream.build_stream_shard_stepper(sim, n_dev, rank)
    assert sh.W == sh.K + 1 and sh.K + 1 <= sh.n
    k = sh.K if window == "T" else sh.rem
    assert k >= 1
    rng = np.random.default_rng(29 + rank)
    a = sh.new_state()
    for t in (*a.e[0], *a.e[1], *a.h, *a.psi_e, *a.psi_h):
        t.copy_(torch.from_numpy(rng.standard_normal(t.shape).astype(np.float32)))
    _psi_to_slabs(sh.ops, a)
    b = _clone(a)
    wf = list(rng.uniform(-1.0, 1.0, k))
    fdtd_stream.reset_launch_counts()
    fdtd_stream.stream_shard_steps(sh.ops, a, wf)
    assert fdtd_stream.launches["stream_shard_steps"] == 1
    assert fdtd_stream.launches_by_kernel["shard_march"] == 1
    fdtd_shard.shard_steps_plain(sh.ops, b, wf)
    torch.cuda.synchronize()
    for x, y in zip((*a.e[a.parity], *a.h, *a.psi_e, *a.psi_h),
                    (*b.e[b.parity], *b.h, *b.psi_e, *b.psi_h), strict=True):
        assert torch.equal(x[sh.owned], y[sh.owned])


@pytest.mark.parametrize("boundary", ["MUR", "PEC", "PML_4"])
def test_explicit_run_at_z131_on_one_card_equals_the_single_card_run(
        cuda, boundary):
    """Pz > 128: the explicit path on one rank launches only K2's slab
    kernels and K1's probe gather, and equals the single-card run."""
    from fdtd_solver_antennas_tpu_torch.parallel import build_explicit_run

    sim = _z131_sim("tall_z", boundary, 1, decim=10)
    run = build_explicit_run(sim)
    T = run.kernel_window
    per = 10 // T + (10 % T > 0)
    fdtd_cuda.reset_launch_counts()
    fdtd_shard.reset_launch_counts()
    fdtd_stream.reset_launch_counts()
    out = run()
    assert fdtd_stream.launches_by_kernel["shard_march"] == 12 * per
    assert fdtd_stream.launches["stream_shard_steps"] == 12 * per
    assert fdtd_stream.launches["stream_steps"] == 0
    assert fdtd_shard.launches == {"shard_steps": 0}
    assert fdtd_cuda.launches["probe_gather"] == 12
    assert fdtd_cuda.launches["chunk_steps"] == 0
    ref = sim.run()
    assert out["steps"] == ref["steps"] == 120
    for a, b in zip(out["fields"], ref["fields"], strict=True):
        _close(a, b)
    for key in ("uf", "if_"):
        _close(out[key], ref[key])
    for key in ("nf_e", "nf_h"):
        for a, b in zip(out[key], ref[key], strict=True):
            _close(a, b)


def test_shard_kernel_launch_fits_the_card(cuda):
    """The cooperative grid is what the card keeps resident at once."""
    blocks = fdtd_shard.grid_blocks()
    props = torch.cuda.get_device_properties(cuda)
    assert props.multi_processor_count <= blocks
    assert blocks % props.multi_processor_count == 0


def _canonical_sim(boundary):
    """The canonical 2.45 GHz FR-4 patch on the card (D = 89)."""
    from fdtd_solver_antennas_tpu_torch.models.params import PatchAntennaParams
    from fdtd_solver_antennas_tpu_torch.solvers.patch_fixed import build_patch_scene

    scene, grid, f0, fc = build_patch_scene(PatchAntennaParams.from_user_units(
        frequency_ghz=2.45, er=4.3, h_mm=1.6, loss_tangent=0.02))
    cfg = FDTDConfig(n_steps_max=1000, end_criteria=1e-30, boundary=boundary)
    return build_simulation(scene, grid, f0=f0, fc=fc, cfg=cfg, device="cuda",
                            port_freqs_hz=np.linspace(2e9, 3e9, 11),
                            nf_freqs_hz=np.array([2.45e9]))


def _chunk_inputs(sim, device, seed, n0=7, n_sub=2):
    """A random state at parity 1, a random waveform on the device and
    staging buffers for ``n_sub`` intervals from step ``n0``."""
    st = _random_state(sim, device, seed)
    st.parity = 1
    rng = np.random.default_rng(seed + 1)
    wf = torch.from_numpy(rng.uniform(
        -1.0, 1.0, n0 + n_sub * sim.probe_decim + 3).astype(np.float32)).to(device)
    bufs = torch.zeros((n_sub, sim.operands.probes.n_rows), device=device)
    return st, wf, bufs


def _assert_same_chunk(a, bufs_a, b, bufs_b):
    assert a.parity == b.parity
    for x, y in zip((*a.e[a.parity], *a.h, *a.psi_e, *a.psi_h),
                    (*b.e[b.parity], *b.h, *b.psi_e, *b.psi_h), strict=True):
        assert torch.equal(x, y)
    assert torch.equal(bufs_a, bufs_b)


@pytest.mark.parametrize("boundary,form", [
    ("MUR", None), ("PEC", None), ("PML_8", None), ("MUR", "streamed")])
def test_chunk_steps_equals_its_twin(cuda, boundary, form):
    """One launch of two intervals of D = 89 steps at the canonical patch,
    from parity 1 and step 7, against the plain twin, bit for bit: fields,
    ψ and every probe sample."""
    sim = _canonical_sim(boundary)
    D = sim.probe_decim
    a, wf, bufs_a = _chunk_inputs(sim, cuda, seed=73)
    b, bufs_b = _clone(a), bufs_a.clone()
    b.parity = a.parity
    plan = fdtd_cuda.chunk_launch_plan(sim.operands, a, form)
    assert plan.form == (form or "resident")
    fdtd_cuda.reset_launch_counts()
    fdtd_cuda.chunk_steps(sim.operands, a, wf, 7, 2, D, bufs_a, form=form)
    assert fdtd_cuda.launches["chunk_steps"] == 1
    assert fdtd_cuda.launches_by_form[plan.form] == 1
    fdtd_cuda.chunk_steps_plain(sim.operands, b, wf, 7, 2, D, bufs_b)
    torch.cuda.synchronize()
    assert a.parity == 1 ^ (2 * D) & 1
    _assert_same_chunk(a, bufs_a, b, bufs_b)


@pytest.mark.parametrize("boundary", ["MUR", "PML_8"])
def test_chunk_steps_equals_the_per_step_kernels(cuda, boundary):
    """The chunk kernel against the first design's route on the same
    state: the per-step kernels and ``probe_gather``, bit for bit."""
    sim = _canonical_sim(boundary)
    D = sim.probe_decim
    a, wf, bufs_a = _chunk_inputs(sim, cuda, seed=79)
    b, bufs_b = _clone(a), bufs_a.clone()
    b.parity = a.parity
    fdtd_cuda.reset_launch_counts()
    fdtd_cuda.chunk_steps(sim.operands, a, wf, 7, 2, D, bufs_a)
    fdtd_cuda.step_kernels.chunk_steps(sim.operands, b, wf, 7, 2, D, bufs_b)
    torch.cuda.synchronize()
    mur = 3 * 2 * D if boundary == "MUR" else 0
    assert fdtd_cuda.launches == {"h_update": 2 * D, "e_update": 2 * D,
                                  "e_update_mur": 0, "mur_faces": mur,
                                  "probe_gather": 2,
                                  "chunk_steps": 1, "chunk_steps_batch": 0,
                                  "probe_gather_batch": 0}
    _assert_same_chunk(a, bufs_a, b, bufs_b)


def test_canonical_run_makes_one_chunk_launch_per_chunk(cuda):
    """``PreparedSimulation.run`` on the canonical patch: 25 chunks of 5 ×
    89 steps, one ``chunk_steps`` launch each in the resident form, no
    per-step launch."""
    from fdtd_solver_antennas_tpu_torch.models.params import PatchAntennaParams
    from fdtd_solver_antennas_tpu_torch.solvers.patch_fixed import prepare_patch_fixed

    prep = prepare_patch_fixed(PatchAntennaParams.from_user_units(
        frequency_ghz=2.45, er=4.3, h_mm=1.6, loss_tangent=0.02), device="cuda")
    assert prep.ok and prep.sim.pallas_mode == "chunk"
    fdtd_cuda.reset_launch_counts()
    out = prep.sim.run()
    assert out["steps"] == 11_125
    assert fdtd_cuda.launches == {"h_update": 0, "e_update": 0, "e_update_mur": 0,
                                  "mur_faces": 0,
                                  "probe_gather": 0, "chunk_steps": 25,
                                  "chunk_steps_batch": 0,
                                  "probe_gather_batch": 0}
    assert fdtd_cuda.launches_by_form == {"streamed": 0, "resident": 25,
                                          "marched": 0}


def test_chunk_plan_refuses_the_resident_form_where_it_does_not_fit(cuda):
    tall = _synthetic_ops((161, 121, 160), "MUR", cuda)
    st = fdtd_cuda.new_state(tall.shape, cuda, pml=False)
    assert fdtd_cuda.chunk_launch_plan(tall, st).form == "streamed"
    with pytest.raises(ValueError, match="resident form does not fit"):
        fdtd_cuda.chunk_launch_plan(tall, st, "resident")


def _batch_inputs(sim, device, batch, seed, n_sub=2):
    """Batched operands (variant b's ca/cb scaled by a seeded factor near 1,
    variant 0 the sim's own), a random batch state at parity 1, a random
    waveform on the device and staging buffers of ``n_sub`` intervals."""
    rng = np.random.default_rng(seed)
    ops = sim.operands
    scale = torch.from_numpy(rng.uniform(0.9, 1.1, (batch, 1, 1, 1)).astype(
        np.float32)).to(device)
    scale[0] = 1.0
    bops = fdtd_cuda.batch_operands(ops, [c[None] * scale for c in ops.ca],
                                    [c[None] * scale for c in ops.cb])
    st = fdtd_cuda.new_batch_state(sim.padded_shape, device,
                                   ops.pml is not None, batch)
    for t in (*st.e[0], *st.e[1], *st.h, *st.psi_e, *st.psi_h):
        t.copy_(torch.from_numpy(rng.standard_normal(t.shape).astype(np.float32)))
    _psi_to_slabs(ops, st)
    st.parity = [1] * batch
    wf = torch.from_numpy(rng.uniform(
        -1.0, 1.0, 7 + 2 * n_sub * sim.probe_decim).astype(np.float32)).to(device)
    bufs = torch.zeros((batch, n_sub, ops.probes.n_rows), device=device)
    return bops, st, wf, bufs


def _clone_batch(st):
    def c(ts):
        return tuple(t.clone() for t in ts)

    return fdtd_cuda.YeeBatch(
        e=[c(st.e[0]), c(st.e[1])], h=c(st.h), psi_e=c(st.psi_e),
        psi_h=c(st.psi_h), parity=list(st.parity), h1=c(st.h1),
        psi_e1=c(st.psi_e1), psi_h1=c(st.psi_h1), hset=list(st.hset))


def _batch_tensors(st):
    return (*st.e[0], *st.e[1], *st.h, *st.psi_e, *st.psi_h)


@pytest.mark.parametrize("form", [None, "streamed"])
@pytest.mark.parametrize("batch", [1, 3, 8])
@pytest.mark.parametrize("boundary", ["MUR", "PEC", "PML_4"])
def test_chunk_steps_batch_equals_its_twin(cuda, boundary, batch, form):
    """Two chunks of the batched kernel against its plain twin: the first
    with every variant stepping, the second with variant 1 frozen (B > 1)
    midway through the batch; every field, ψ and probe sample at rtol
    2e-4, atol 1e-5·max|plain|, and the frozen variant untouched."""
    sim = _sim(boundary, decim=5)
    D, n_sub = sim.probe_decim, 3  # 15 steps a chunk: each flips the parity
    ops, a, wf, bufs_a = _batch_inputs(sim, cuda, batch, seed=97 + batch,
                                       n_sub=n_sub)
    b, bufs_b = _clone_batch(a), bufs_a.clone()
    plan = fdtd_cuda.chunk_launch_plan(ops, a, form)
    assert plan.form == form or form is None
    masks = [[True] * batch, [b_ != 1 for b_ in range(batch)]]
    fdtd_cuda.reset_launch_counts()
    frozen = None
    for i, mask in enumerate(masks):
        n0 = 7 + i * n_sub * D
        if i == 1:
            frozen = [t[1].clone() for t in _batch_tensors(a)] if batch > 1 else None
            frozen_bufs = bufs_a[1].clone() if batch > 1 else None
        fdtd_cuda.chunk_steps_batch(ops, a, wf, n0, n_sub, D, bufs_a, mask,
                                    form=form)
        fdtd_cuda.chunk_steps_batch_plain(ops, b, wf, n0, n_sub, D, bufs_b, mask)
        torch.cuda.synchronize()
        assert a.parity == b.parity
        for x, y in zip(_batch_tensors(a), _batch_tensors(b), strict=True):
            _close(x, y)
        _close(bufs_a, bufs_b)
    assert fdtd_cuda.launches["chunk_steps_batch"] == 2
    assert fdtd_cuda.launches_by_form[plan.form] == 2
    if frozen is not None:
        for t, t0 in zip(_batch_tensors(a), frozen):
            assert torch.equal(t[1], t0)
        assert torch.equal(bufs_a[1], frozen_bufs)
        assert a.parity[1] == 0 and a.parity[0] == 1  # one flip, two flips


@pytest.mark.parametrize("form", [None, "streamed"])
@pytest.mark.parametrize("boundary", ["MUR", "PML_8"])
def test_chunk_steps_batch_of_one_equals_chunk_steps(cuda, boundary, form):
    """B = 1 at the canonical patch: the batched kernel is bit-equal to the
    unbatched one on the same state, in the same storage form."""
    sim = _canonical_sim(boundary)
    D = sim.probe_decim
    ops, a, wf, bufs_a = _batch_inputs(sim, cuda, 1, seed=101)
    b = a.variant(0)
    b = fdtd_cuda.YeeState(e=[tuple(t.clone() for t in b.e[p]) for p in range(2)],
                           h=tuple(t.clone() for t in b.h),
                           psi_e=tuple(t.clone() for t in b.psi_e),
                           psi_h=tuple(t.clone() for t in b.psi_h), parity=1)
    bufs_b = bufs_a[0].clone()
    plan = fdtd_cuda.chunk_launch_plan(ops, a, form)
    assert plan.form == fdtd_cuda.chunk_launch_plan(sim.operands, b, form).form
    fdtd_cuda.chunk_steps_batch(ops, a, wf, 7, 2, D, bufs_a, [True], form=form)
    fdtd_cuda.chunk_steps(sim.operands, b, wf, 7, 2, D, bufs_b, form=form)
    torch.cuda.synchronize()
    _assert_same_chunk(a.variant(0), bufs_a[0], b, bufs_b)


@pytest.mark.parametrize("core", [None, (4, 6)])
@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("boundary", ["MUR", "PEC"])
def test_marched_chunk_equals_its_twin(cuda, boundary, batch, core):
    """The marched form (``ops/chunk_march.py``) over two chunks of 3
    intervals of D = 5 (a round of T = 3 and one of 2 each), the second
    with variant 1 frozen (B > 1), at the plan's core and at a 4 × 6 core
    (more tiles and segments): each variant's current fields and every
    sample bit-equal to the plain twin, the frozen variant's every slice,
    samples, E buffer and H set untouched, one launch a chunk counted
    under "marched"."""
    from fdtd_solver_antennas_tpu_torch.ops import chunk_march

    sim = _sim(boundary, decim=5)
    D, n_sub = sim.probe_decim, 3
    ops, a, wf, bufs_a = _batch_inputs(sim, cuda, batch, seed=89 + batch,
                                       n_sub=n_sub)
    b, bufs_b = _clone_batch(a), bufs_a.clone()
    plan = (fdtd_cuda.chunk_launch_plan(ops, a, "marched") if core is None
            else chunk_march.plan(ops, batch, core=core))
    assert plan.form == "marched"
    fdtd_cuda.reset_launch_counts()
    for i, mask in enumerate(([True] * batch, [v != 1 for v in range(batch)])):
        n0 = 7 + i * n_sub * D
        if i == 1 and batch > 1:
            frozen = [t[1].clone() for t in (*_batch_tensors(a), *a.h1)]
            frozen_set = (a.parity[1], a.hset[1])
            frozen_bufs = bufs_a[1].clone()
        if core is None:
            fdtd_cuda.chunk_steps_batch(ops, a, wf, n0, n_sub, D, bufs_a, mask,
                                        form="marched")
        else:
            act = tuple(mask)
            chunk_march.chunk_steps(ops, a, wf, n0, n_sub, D, bufs_a, act, plan,
                                    fdtd_cuda._device_mask(a, act))
        fdtd_cuda.chunk_steps_batch_plain(ops, b, wf, n0, n_sub, D, bufs_b, mask)
        torch.cuda.synchronize()
        for x, y in zip(a.fields(), b.fields(), strict=True):
            assert torch.equal(x, y)
        assert torch.equal(bufs_a, bufs_b)
    if core is None:
        assert fdtd_cuda.launches["chunk_steps_batch"] == 2
        assert fdtd_cuda.launches_by_form["marched"] == 2
    if batch > 1:
        for t, t0 in zip((*_batch_tensors(a), *a.h1), frozen):
            assert torch.equal(t[1], t0)
        assert torch.equal(bufs_a[1], frozen_bufs)
        assert (a.parity[1], a.hset[1]) == frozen_set


@pytest.mark.parametrize("boundary", ["MUR", "PEC"])
def test_marched_chunk_of_one_equals_chunk_steps(cuda, boundary):
    """B = 1 at the canonical patch in the marched form: its current
    fields and samples bit-equal to ``chunk_steps`` on the same state."""
    sim = _canonical_sim(boundary)
    D = sim.probe_decim
    ops, a, wf, bufs_a = _batch_inputs(sim, cuda, 1, seed=103)
    v = a.variant(0)
    b = fdtd_cuda.YeeState(e=[tuple(t.clone() for t in v.e[p]) for p in range(2)],
                           h=tuple(t.clone() for t in v.h), parity=1)
    bufs_b = bufs_a[0].clone()
    fdtd_cuda.chunk_steps_batch(ops, a, wf, 7, 2, D, bufs_a, [True],
                                form="marched")
    fdtd_cuda.chunk_steps(sim.operands, b, wf, 7, 2, D, bufs_b)
    torch.cuda.synchronize()
    for x, y in zip(a.variant(0).fields, b.fields, strict=True):
        assert torch.equal(x, y)
    assert torch.equal(bufs_a[0], bufs_b)


def test_marched_form_raises_on_a_failed_launch(cuda):
    """A launch the kernel refuses (more blocks than items) raises; nothing
    carries on on the twin."""
    import dataclasses

    from fdtd_solver_antennas_tpu_torch.ops import chunk_march

    sim = _sim("MUR", decim=5)
    ops, a, wf, bufs = _batch_inputs(sim, cuda, 2, seed=7, n_sub=1)
    plan = chunk_march.plan(ops, 2)
    bad = dataclasses.replace(plan, blocks=2 * plan.items_per_variant + 1)
    act = (True, True)
    with pytest.raises(RuntimeError, match="marched"):
        chunk_march.chunk_steps(ops, a, wf, 0, 1, 5, bufs, act, bad,
                                fdtd_cuda._device_mask(a, act))


def test_batch_plan_refuses_the_resident_form_at_the_sweeps_shape(cuda):
    """Eight variants of the 8-variant sweep's union grid do not fit on
    chip together: the plan gives the marched form (the batch spills the
    L2 under MUR), the streamed form where asked, and refuses the
    resident one (no launch is tried)."""
    ops = _synthetic_ops((100, 109, 50), "MUR", cuda)
    batch = 8
    bops = fdtd_cuda.batch_operands(ops, [c[None].repeat(batch, 1, 1, 1)
                                          for c in ops.ca],
                                    [c[None].repeat(batch, 1, 1, 1)
                                     for c in ops.cb])
    st = fdtd_cuda.new_batch_state(ops.shape, cuda, False, batch)
    assert fdtd_cuda.chunk_launch_plan(bops, st).form == "marched"
    assert fdtd_cuda.chunk_launch_plan(bops, st, "streamed").form == "streamed"
    with pytest.raises(ValueError, match="resident form does not fit"):
        fdtd_cuda.chunk_launch_plan(bops, st, "resident")


def test_sweep_run_makes_one_batch_launch_per_chunk(cuda):
    """The patch sweep of tests/test_sweep.py's two geometries on the card:
    one ``chunk_steps_batch`` launch per chunk and no ``chunk_steps``,
    equal to the same run through the plain twin on the card, the two
    variants' spectra distinct."""
    from fdtd_solver_antennas_tpu_torch.models.params import PatchAntennaParams
    from fdtd_solver_antennas_tpu_torch.ops.fdtd import chunk_geometry, run_batched
    from fdtd_solver_antennas_tpu_torch.solvers.sweep import (
        prepare_patch_geometry_sweep, run_patch_geometry_sweep)

    variants = [PatchAntennaParams.from_user_units(
        frequency_ghz=2.45, er=4.3, h_mm=1.6, L_mm=L, W_mm=W)
        for L, W in [(26.0, 33.0), (32.0, 41.0)]]
    prep = prepare_patch_geometry_sweep(variants, n_steps_max=1000,
                                        end_criteria=1e-12, device="cuda")
    assert prep.ok, prep.message
    fdtd_cuda.reset_launch_counts()
    res = run_patch_geometry_sweep(prep)
    assert res.ok, res.message
    chunk = chunk_geometry(prep.sim)[2]
    assert fdtd_cuda.launches["chunk_steps_batch"] == -(-res.steps_run // chunk)
    assert fdtd_cuda.launches["chunk_steps"] == 0
    plain = run_batched(prep.sim, prep.batched_coeffs, fdtd_cuda.plain)
    np.testing.assert_array_equal(res.steps, plain["steps"])
    for b, sp in enumerate(res.spectra):
        _close(sp.uf / prep.sim.dft_dt, plain["uf"][b, 0])
    assert not np.allclose(np.abs(res.spectra[0].s11),
                           np.abs(res.spectra[1].s11), rtol=1e-3)


def _stream_batch(st):
    """Every variant's current fields and ψ, by its own E buffer and set."""
    out = []
    for b in range(st.batch):
        v = st.variant(b)
        out += [*v.fields, *v.psi_e, *v.psi_h]
    return out


@pytest.mark.parametrize("T", [2, 4])
@pytest.mark.parametrize("boundary", ["MUR", "PEC", "PML_4"])
def test_stream_steps_batch_equals_its_twin(cuda, boundary, T):
    """Two batched stream launches of B = 3 variants (distinct ca/cb)
    against the twin: every variant stepping in the first, variant 1
    frozen in the second; each variant's fields and ψ at rtol 2e-4, atol
    1e-5·max|plain|, the frozen variant's tensors, parity and set
    untouched. The launch is the batched march (under CPML with the ψ)."""
    sim = _stream_sim(boundary, T=T)
    ops, a, _wf, _bufs = _batch_inputs(sim, cuda, 3, seed=131 + T)
    b = _clone_batch(a)
    wf = [0.37, -0.21, 0.55, 0.13][:T]
    route = "stream_march_batch"
    fdtd_stream.reset_launch_counts()
    for i, mask in enumerate(([True] * 3, [True, False, True])):
        if i == 1:
            frozen = [t[1].clone() for t in (*_batch_tensors(a), *a.h1,
                                              *a.psi_e1, *a.psi_h1)]
            state1 = (a.parity[1], a.hset[1])
        fdtd_stream.stream_steps_batch(ops, a, wf, mask)
        fdtd_stream.stream_steps_batch_plain(ops, b, wf, mask)
        torch.cuda.synchronize()
        for x, y in zip(_stream_batch(a), _stream_batch(b), strict=True):
            _close(x, y)
    assert fdtd_stream.launches_by_kernel[route] == 2
    assert fdtd_stream.launches["stream_steps_batch"] == 2
    for t, t0 in zip((*_batch_tensors(a), *a.h1, *a.psi_e1, *a.psi_h1), frozen,
                     strict=True):
        assert torch.equal(t[1], t0)
    assert (a.parity[1], a.hset[1]) == state1 == (0, 1)
    assert (a.parity[0], a.hset[0]) == (1, 0)  # two launches


@pytest.mark.parametrize("boundary", ["MUR", "PML_4"])
def test_stream_steps_batch_of_one_equals_stream_steps(cuda, boundary):
    """B = 1: the batched kernel is bit-equal to the unbatched one on the
    same state."""
    sim = _stream_sim(boundary, T=4)
    ops, a, _wf, _bufs = _batch_inputs(sim, cuda, 1, seed=137)
    ref = a.variant(0)
    ref = fdtd_cuda.YeeState(
        e=[tuple(t.clone() for t in ref.e[p]) for p in range(2)],
        h=tuple(t.clone() for t in ref.h),
        psi_e=tuple(t.clone() for t in ref.psi_e),
        psi_h=tuple(t.clone() for t in ref.psi_h), parity=1)
    wf = [0.37, -0.21, 0.55, 0.13]
    fdtd_stream.stream_steps_batch(ops, a, wf, [True])
    fdtd_stream.stream_steps(sim.operands, ref, wf)
    torch.cuda.synchronize()
    got = a.variant(0)
    for x, y in zip((*got.fields, *got.psi_e, *got.psi_h),
                    (*ref.fields, *ref.psi_e, *ref.psi_h), strict=True):
        assert torch.equal(x, y)


def test_probe_gather_batch_equals_its_twin(cuda):
    sim = _stream_sim("PML_4", T=4)
    ops, a, _wf, _bufs = _batch_inputs(sim, cuda, 3, seed=139)
    fdtd_stream.stream_steps_batch(ops, a, [0.2, 0.1], [True] * 3)
    rows = ops.probes.n_rows
    got = torch.full((3, 2, rows), 7.0, device=cuda)
    want = got.clone()
    fdtd_cuda.reset_launch_counts()
    fdtd_cuda.probe_gather_batch(ops, a, got[:, 1], [True, False, True])
    fdtd_cuda.probe_gather_batch_plain(ops, a, want[:, 1], [True, False, True])
    torch.cuda.synchronize()
    assert fdtd_cuda.launches["probe_gather_batch"] == 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("boundary", ["MUR", "PML_4"])
def test_run_batched_in_stream_mode_matches_plain(cuda, boundary):
    """``run_batched`` on a stream-mode sim: one batched stream launch per
    T steps and one batched gather per interval, no chunk launch; equal to
    the same run through the plain twins on the card."""
    from fdtd_solver_antennas_tpu_torch.ops.fdtd import run_batched

    sim = _stream_sim(boundary, T=4)
    scale = torch.tensor([1.0, 0.97], device=cuda).view(2, 1, 1, 1)
    coeffs = {k: v[None] * scale for k, v in sim.coeffs.items()}
    fdtd_stream.reset_launch_counts()
    fdtd_cuda.reset_launch_counts()
    k = run_batched(sim, coeffs)
    assert fdtd_stream.launches["stream_steps_batch"] == 120 // 4
    assert fdtd_cuda.launches["probe_gather_batch"] == 120 // 4
    assert fdtd_cuda.launches["chunk_steps_batch"] == 0
    assert fdtd_cuda.launches["probe_gather"] == 0
    p = run_batched(sim, coeffs, fdtd_stream.plain)
    np.testing.assert_array_equal(k["steps"], p["steps"])
    for fa, fb in zip(k["fields"], p["fields"], strict=True):
        _close(fa, fb)
    for key in ("uf", "if_"):
        _close(k[key], p[key])
    bad = dataclasses.replace(sim, probe_decim=5)
    with pytest.raises(ValueError, match="multiple of stream_T"):
        run_batched(bad, coeffs)


@pytest.mark.parametrize("scene", ["small", "canonical"])
@pytest.mark.parametrize("boundary", ["MUR", "PEC"])
def test_interval_steps_equals_its_twin(cuda, scene, boundary):
    """Three successive launches of one probe interval each on a random
    state against the plain steps, bit for bit after every launch."""
    from fdtd_solver_antennas_tpu_torch.ops import fdtd_steps

    sim = _sim(boundary, decim=9) if scene == "small" else _canonical_sim(boundary)
    D = sim.probe_decim
    if scene == "canonical":
        assert D == 89
    step_fn, _, _ = fdtd_steps.build_stepper(sim, *sim._aux[:3])
    a = _random_state(sim, cuda, seed=29)
    b = _clone(a)
    rng = np.random.default_rng(31)
    fdtd_steps.reset_launch_counts()
    for i in range(3):
        wf = torch.from_numpy(rng.uniform(-1.0, 1.0, D).astype(np.float32)).to(cuda)
        fdtd_steps.interval_steps(sim.operands, a, wf)
        fdtd_steps.interval_steps_plain(sim.operands, b, wf)
        torch.cuda.synchronize()
        assert fdtd_steps.launches == {"interval_steps": i + 1}
        assert a.parity == b.parity
        for x, y in zip(a.fields, b.fields, strict=True):
            assert torch.equal(x, y)


def test_step_fn_runs_on_the_card_by_default(cuda):
    """``build_stepper`` takes the simulation's device; an odd interval's
    result comes back in new tensors, held to the plain steps, and the
    caller's tensors keep their values."""
    from fdtd_solver_antennas_tpu_torch.ops import fdtd_steps

    sim = _sim("MUR", decim=7)
    step_fn, _, _ = fdtd_steps.build_stepper(sim, *sim._aux[:3])
    ref = _random_state(sim, cuda, seed=37)
    fields = tuple(f.clone() for f in ref.fields)
    wf = torch.linspace(-1.0, 1.0, 7, device=cuda)
    fdtd_steps.reset_launch_counts()
    out = step_fn(fields, wf)
    assert not any(x is y for x, y in zip(out, fields))
    for x, y in zip(fields, ref.fields, strict=True):  # inputs unchanged
        assert torch.equal(x, y)
    assert fdtd_steps.launches == {"interval_steps": 1}
    fdtd_steps.interval_steps_plain(sim.operands, ref, wf)
    for x, y in zip(out, ref.fields, strict=True):
        assert x.device.type == "cuda" and torch.equal(x, y)


# ---------------------------------------------------------------------------
# the grouped probe table and its gather
# ---------------------------------------------------------------------------

def _two_port_sim():
    """A patch and a small horn whose port V rows differ in length, at
    mesh quality 1 (``tests/test_torch_probe.py``'s scene), on the card."""
    from fdtd_solver_antennas_tpu_torch.models.params import (
        HornAntennaParams, PatchAntennaParams)
    from fdtd_solver_antennas_tpu_torch.solvers import multi_patch_3d as multi

    horn = HornAntennaParams.from_user_units(
        frequency_ghz=2.45, throat_a_mm=70.0, throat_b_mm=35.0,
        aperture_A_mm=80.0, aperture_B_mm=50.0, length_mm=20.0)
    patch = PatchAntennaParams.from_user_units(
        frequency_ghz=2.45, er=4.3, h_mm=1.6, loss_tangent=0.02)
    p = multi.prepare_multi_patch_3d(
        [multi.PatchLike("p", patch)],
        horns=[multi.HornLike("h", horn, center_x_m=0.12, rot_z_deg=30.0)],
        device="cuda", mesh_quality=1, phi_step_deg=30.0, theta_step_deg=15.0,
        auto_margin_mm=(20.0, 20.0, 20.0))
    assert p.ok, p.message
    return p.sim


def _gather_both(ops, st, device):
    out_k = torch.full((ops.probes.n_rows,), float("nan"), device=device)
    out_p = out_k.clone()
    fdtd_cuda.reset_launch_counts()
    fdtd_cuda.probe_gather(ops, st, out_k)
    assert fdtd_cuda.launches["probe_gather"] == 1
    fdtd_cuda.probe_gather_plain(ops, st, out_p)
    torch.cuda.synchronize()
    return out_k, out_p


def test_probe_gather_equals_its_twin_on_the_two_port_scene(cuda):
    sim = _two_port_sim()
    t = sim.operands.probes
    assert t.k[0] > max(t.k[1:])  # the two V rows differ in length
    for parity in (0, 1):
        st = _random_state(sim, cuda, seed=97 + parity)
        st.parity = parity
        out_k, out_p = _gather_both(sim.operands, st, cuda)
        assert torch.equal(out_k, out_p)


def test_probe_gather_equals_its_twin_at_the_mixed_scenes_shape(cuda):
    """A random state of the mixed scene's shape and a random table of its
    blocks' rows and widths (port V 2 × 70, port I 2 × 4, face E and H
    286,704 × 2 and × 4), bit for bit."""
    shape = (141, 201, 152)
    n = int(np.prod(shape))
    rng = np.random.default_rng(101)
    blocks = []
    for rows, k in ((2, 70), (2, 4), (286_704, 2), (286_704, 4)):
        w = rng.uniform(-1.0, 1.0, (rows, k)).astype(np.float32)
        if k == 70:
            w[0, 8:] = 0.0  # the patch's V row: 8 terms, padded
        blocks.append((rng.integers(0, 6 * n, (rows, k)), w))
    ops = dataclasses.replace(
        _synthetic_ops(shape, "MUR", cuda),
        probes=fdtd_cuda.ProbeTable.from_blocks(blocks, n, cuda))
    st = fdtd_cuda.new_state(shape, cuda, pml=False)
    g = torch.Generator(device=cuda).manual_seed(5)
    for f in (*st.e[0], *st.h):
        f.normal_(generator=g)
    out_k, out_p = _gather_both(ops, st, cuda)
    assert torch.equal(out_k, out_p)


def test_device_holds_no_padded_probe_table(cuda):
    """The operands carry the grouped table alone: 8 bytes a term of each
    block's own width, no (rows, k) table padded to the longest row."""
    sim = _two_port_sim()
    t = sim.operands.probes
    assert t.code.is_cuda and t.w.is_cuda and t.code.dim() == t.w.dim() == 1
    assert t.nbytes == 8 * sum(r * k for r, k in zip(t.rows, t.k))
    assert t.nbytes < 8 * t.n_rows * max(t.k)
    tensors = [v for f in dataclasses.fields(sim.operands)
               for v in [getattr(sim.operands, f.name)] if torch.is_tensor(v)]
    assert not tensors  # every table lives in the ProbeTable


# ---------------------------------------------------------------------------
# the persistent steppers K3 and K4: both storage forms, every boundary
# ---------------------------------------------------------------------------

def _synthetic_ops(shape, boundary, device, seed=43):
    """Random operands of ``shape`` (grid = array) on ``device``; the
    source on Ez only."""
    rng = np.random.default_rng(seed)

    def arr(*s, lo=-1.0):
        return torch.from_numpy(rng.uniform(lo, 1.0, s).astype(np.float32)).to(device)

    return fdtd_cuda.YeeOperands(
        shape=tuple(shape), grid_shape=tuple(shape), dtmu=0.25,
        inv_p=tuple(arr(n, lo=0.2) for n in shape),
        inv_d=tuple(arr(n, lo=0.2) for n in shape),
        ca=tuple(arr(*shape, lo=0.5) for _ in range(3)),
        cb=tuple(arr(*shape) for _ in range(3)),
        src=(None, None, arr(*shape)),
        mur=((0.3, -0.2), (0.1, 0.4), (-0.5, 0.2)) if boundary == "MUR" else None,
        pml=None,
        probes=fdtd_cuda.ProbeTable.empty(device))


@pytest.mark.parametrize("form", ["resident", "streamed"])
@pytest.mark.parametrize("boundary", ["MUR", "PEC"])
def test_interval_steps_forms_equal_the_twin(cuda, boundary, form):
    """Three successive launches of each storage form against the plain
    steps, bit for bit after every launch; the cell count is no multiple
    of the threads launched, so the last block and thread are partial."""
    from fdtd_solver_antennas_tpu_torch.ops import fdtd_steps

    sim = _sim(boundary, decim=9)
    a = _random_state(sim, cuda, seed=61)
    b = _clone(a)
    plan = fdtd_steps.launch_plan(sim.operands, a, form)
    assert plan.form == form
    assert (plan.cells_per_thread > 0) == (form == "resident")
    cells = int(np.prod(sim.padded_shape))
    assert cells % (plan.blocks * plan.threads) != 0
    rng = np.random.default_rng(67)
    fdtd_steps.reset_launch_counts()
    for i in range(3):
        wf = torch.from_numpy(rng.uniform(-1.0, 1.0, 9).astype(np.float32)).to(cuda)
        fdtd_steps.interval_steps(sim.operands, a, wf, form=form)
        fdtd_steps.interval_steps_plain(sim.operands, b, wf)
        torch.cuda.synchronize()
        assert fdtd_steps.launches_by_form[form] == i + 1
        assert a.parity == b.parity
        for x, y in zip(a.fields, b.fields, strict=True):
            assert torch.equal(x, y)


@pytest.mark.parametrize("form", ["resident", "streamed"])
@pytest.mark.parametrize("boundary,n_dev,rank", [
    ("MUR", 1, 0), ("MUR", 4, 3), ("MUR", 4, 0), ("PEC", 4, 2),
    ("PML_4", 4, 1),
])
def test_shard_steps_forms_equal_the_twin(cuda, boundary, n_dev, rank, form):
    """Three successive K-step launches of each storage form on one slab
    against the plain steps, owned rows bit for bit after every launch
    (no halo restock between them: the slab alone)."""
    sim = _sim(boundary, decim=45 if n_dev == 1 else 9, pad_x=n_dev)
    sh = fdtd_shard.build_shard_stepper(sim, n_dev, rank)
    rng = np.random.default_rng(71 + rank)
    a = sh.new_state()
    for t in (*a.e[0], *a.e[1], *a.h, *a.psi_e, *a.psi_h):
        t.copy_(torch.from_numpy(rng.standard_normal(t.shape).astype(np.float32)))
    b = _clone(a)
    plan = fdtd_shard.launch_plan(sh.ops, a, form)
    assert plan.form == form
    assert int(np.prod(sh.ops.shape)) % (plan.blocks * plan.threads) != 0
    fdtd_shard.reset_launch_counts()
    for i in range(3):
        wf = list(rng.uniform(-1.0, 1.0, sh.K))
        fdtd_shard.shard_steps(sh.ops, a, wf, form=form)
        fdtd_shard.shard_steps_plain(sh.ops, b, wf)
        torch.cuda.synchronize()
        assert fdtd_shard.launches_by_form[form] == i + 1
        assert a.parity == b.parity
        for x, y in zip((*a.e[a.parity], *a.h, *a.psi_e, *a.psi_h),
                        (*b.e[b.parity], *b.h, *b.psi_e, *b.psi_h), strict=True):
            assert torch.equal(x[sh.owned], y[sh.owned])


def test_persistent_steppers_pick_the_form_from_the_shape(cuda):
    """The canonical grid and slab hold their operands on chip, at most
    two blocks an SM; the 161×121×160 grid streams them, and forcing the
    resident form there raises."""
    from fdtd_solver_antennas_tpu_torch.ops import fdtd_steps

    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    canonical = _canonical_sim("MUR")
    st = fdtd_cuda.new_state(canonical.padded_shape, cuda, pml=False)
    plan = fdtd_steps.launch_plan(canonical.operands, st)
    assert plan.form == "resident" and plan.blocks <= 2 * sms
    assert plan.cells_per_thread * plan.blocks * plan.threads >= 56 * 55 * 50
    sh = fdtd_shard.build_shard_stepper(canonical, 1, 0)
    plan = fdtd_shard.launch_plan(sh.ops, sh.new_state())
    assert plan.form == "resident" and sh.ops.shape == (120, 55, 50)
    tall = _synthetic_ops((161, 121, 160), "MUR", cuda)
    st = fdtd_cuda.new_state(tall.shape, cuda, pml=False)
    assert fdtd_steps.launch_plan(tall, st).form == "streamed"
    with pytest.raises(ValueError, match="resident form does not fit"):
        fdtd_steps.launch_plan(tall, st, "resident")
    with pytest.raises(ValueError, match="form must be"):
        fdtd_steps.launch_plan(tall, st, "registers")


def test_grid_barrier_launch_runs_at_the_steppers_block_count(cuda):
    from fdtd_solver_antennas_tpu_torch.ops import fdtd_steps

    canonical = _canonical_sim("PEC")
    st = fdtd_cuda.new_state(canonical.padded_shape, cuda, pml=False)
    plan = fdtd_steps.launch_plan(canonical.operands, st)
    fdtd_steps.reset_launch_counts()
    fdtd_steps.grid_barriers(plan, 2 * 89)
    torch.cuda.synchronize()
    assert fdtd_steps.launches == {"interval_steps": 0}


@pytest.mark.parametrize("R,C,iters", [(56, 55 * 128, 7), (3, 300, 4),
                                       (2, 16384, 2), (5, 512, 0)])
def test_roll_chain_equals_its_twin_bit_for_bit(cuda, R, C, iters):
    from fdtd_solver_antennas_tpu_torch.ops import roll_chain as rc

    rng = np.random.default_rng(41)
    a = torch.from_numpy(rng.uniform(0.5, 1.5, (R, C)).astype(np.float32)).to(cuda)
    rc.reset_launch_counts()
    out = rc.roll_chain(a, iters)
    assert rc.launches == {"roll_chain": 1}
    assert torch.equal(out, rc.roll_chain_plain(a, iters))
    with pytest.raises(ValueError, match="C <="):
        rc.roll_chain(torch.zeros(1, 16388, device=cuda), 1)


@pytest.mark.parametrize("R,C,iters", [(56, 55 * 128, 200), (8, 512, 5),
                                       (3, 132, 9)])
def test_roll_chain_designs_equal_the_twin(cuda, R, C, iters):
    """One block a row, bit for bit, at the roofline's shape and at small
    ones (132: a row barely wider than the shift by 128), with its plan."""
    from fdtd_solver_antennas_tpu_torch.ops import roll_chain as rc

    rng = np.random.default_rng(43)
    a = torch.from_numpy(rng.uniform(0.5, 1.5, (R, C)).astype(np.float32)).to(cuda)
    plan = rc.plan(a.shape)
    assert plan["blocks"] == R and plan["threads"] % 32 == 0
    assert plan["threads"] * plan["per_thread"] * 4 >= C
    rc.reset_launch_counts()
    out = rc.roll_chain(a, iters)
    assert rc.launches == {"roll_chain": 1}
    assert torch.equal(out, rc.roll_chain_plain(a, iters))


def test_roofline_entry_point_runs_on_the_card(cuda):
    from fdtd_solver_antennas_tpu_torch.examples import chunk_roofline
    from fdtd_solver_antennas_tpu_torch.ops import roll_chain as rc

    rc.reset_launch_counts()
    cal = chunk_roofline.calibrate_rolls(iters=50, best_of=2)
    assert cal["device"] == torch.cuda.get_device_name(cuda)
    assert cal["shape"] == [56, 7040] and cal["iters"] >= 50
    assert cal["wall_s"] >= chunk_roofline.FLOOR_RATIO * cal["floor_s"] > 0
    assert cal["roll_gelems_per_s"] > 0 and rc.launches["roll_chain"] >= 5


def _msl_sim(boundary, mode=None):
    """The microstrip patch with its MSL port (a dense Ez source plane and
    three V / two I probe rows, the third I row empty), 492 steps."""
    from fdtd_solver_antennas_tpu_torch.models.params import PatchAntennaParams
    from fdtd_solver_antennas_tpu_torch.physics import C0
    from fdtd_solver_antennas_tpu_torch.solvers.microstrip import (
        FeedDirection, build_microstrip_scene)

    params = PatchAntennaParams.from_user_units(
        frequency_ghz=2.45, er=4.3, h_mm=1.6, loss_tangent=0.02)
    f0 = params.frequency_hz
    res = C0 / (1.5 * f0) / 1e-3 / 20.0
    scene, mb, _ = build_microstrip_scene(
        params, FeedDirection.NEG_X, 20.0, res, port_mode="msl")
    cfg = FDTDConfig(n_steps_max=492, end_criteria=1e-30, boundary=boundary,
                     pallas_mode=mode)
    return build_simulation(
        scene, mb.build(res, ratio=1.4), f0=f0, fc=f0 / 2, cfg=cfg,
        device="cuda", port_freqs_hz=np.linspace(2e9, 3e9, 21))


def _assert_runs_close(k, p):
    assert k["steps"] == p["steps"]
    for fa, fb in zip(k["fields"], p["fields"], strict=True):
        _close(fa, fb)
    for key in ("uf", "if_"):
        assert k[key].shape[0] == 3
        _close(k[key], p[key])
    for key in ("nf_e", "nf_h"):
        for a, b in zip(k[key], p[key], strict=True):
            _close(a, b)
    for grp in ("psi_e", "psi_h"):
        for name, v in p["state"][grp].items():
            _close(k["state"][grp][name], v)


@pytest.mark.parametrize("boundary", ["MUR", "PML_8"])
def test_msl_chunk_run_equals_plain(cuda, boundary):
    """The MSL scene in chunk mode: one ``chunk_steps`` launch per chunk
    and nothing else, equal to the plain twins, the MSL rows included."""
    sim = _msl_sim(boundary)
    assert sim.pallas_mode == "chunk"
    assert sim.operands.probes.rows[:2] == (3, 3)
    fdtd_cuda.reset_launch_counts()
    k = run_simulation(sim, fdtd_cuda.kernels)
    assert fdtd_cuda.launches["chunk_steps"] == 1
    assert sum(fdtd_cuda.launches.values()) == 1
    _assert_runs_close(k, run_simulation(sim, fdtd_cuda.plain))


@pytest.mark.parametrize("boundary", ["MUR", "PML_8"])
def test_msl_stream_run_equals_plain(cuda, boundary):
    """The MSL scene forced onto the stream path: the MSL plane goes
    through the march and the MSL rows through ``probe_gather``."""
    sim = _msl_sim(boundary, mode="stream")
    T, D = sim.stream_T, sim.probe_decim
    fdtd_cuda.reset_launch_counts()
    fdtd_stream.reset_launch_counts()
    k = run_simulation(sim, fdtd_stream.kernels)
    steps = k["steps"]
    assert fdtd_stream.launches_by_kernel["stream_march"] == steps // T > 0
    assert fdtd_cuda.launches["probe_gather"] == steps // D
    assert fdtd_cuda.launches["chunk_steps"] == 0
    _assert_runs_close(k, run_simulation(sim, fdtd_stream.plain))


# ---------------------------------------------------------------------------
# re-excitation in place (ops.fdtd.set_port_excitation)
# ---------------------------------------------------------------------------

def _two_patch_sim(mode, n_steps=1344):
    """tests/test_sparams.py's two-patch scene (63×20×21, two lumped
    z-ports) on the card for a fixed 1,344 steps (3 chunks of 4 × 112);
    ``mode`` forces K1's chunk kernel or K2's march (T = 4)."""
    scene = Scene()
    scene.add_material_box("sub", 2.2, 0.0, [-30, -15, 0], [30, 15, 1.6], 0)
    scene.add_metal_box("gnd", [-30, -15, 0], [30, 15, 0], priority=10)
    for cx, name in ((-13.0, "pa"), (13.0, "pb")):
        scene.add_metal_box(
            name, [cx - 6, -5, 1.6], [cx + 6, 5, 1.6], priority=10)
    scene.add_lumped_port(1, 50.0, [-13, 0, 0], [-13, 0, 1.6], direction="z")
    scene.add_lumped_port(2, 50.0, [13, 0, 0], [13, 0, 1.6], direction="z")
    mb = MeshBuilder()
    mb.add_line("x", np.linspace(-34, 34, 35))
    mb.add_line("x", [-19.0, -13.0, -7.0, 7.0, 13.0, 19.0])
    mb.add_line("y", np.linspace(-19, 19, 20))
    mb.add_line("z", list(np.linspace(-8, 12, 11)) + [0.0, 0.8, 1.6])
    cfg = FDTDConfig(n_steps_max=n_steps, end_criteria=1e-30, check_every=500,
                     pallas_mode=mode, stream_T=4 if mode == "stream" else None)
    return build_simulation(
        scene, mb.build(3.0), f0=2.45e9, fc=1.225e9, cfg=cfg, device="cuda",
        port_freqs_hz=np.linspace(2e9, 3e9, 11),
        nf_freqs_hz=np.array([2.45e9]))


def _assert_linear(a, b, ab):
    """Drive (1, 1) equals (1, 0) + (0, 1) to float32 rounding: the port
    DFT sums within 1e-6 of their peak (8 ulps), the fields within 1e-4
    of each component's peak (rounding over the steps, in fields far
    below the peak where the two drives cancel)."""
    for key in ("uf", "if_"):
        np.testing.assert_allclose(a[key] + b[key], ab[key], rtol=0,
                                   atol=1e-6 * np.abs(ab[key]).max())
    for fa, fb, fab in zip(a["fields"], b["fields"], ab["fields"], strict=True):
        fab = fab.cpu().numpy()
        np.testing.assert_allclose((fa + fb).cpu().numpy(), fab, rtol=0,
                                   atol=1e-4 * np.abs(fab).max())


@pytest.mark.parametrize("mode", ["chunk", "stream"])
def test_reexcitation_is_linear_on_the_card(cuda, mode):
    """Three drives of one prepared scene, re-excited in place between the
    runs: K1's resident form (it copies the stamps to shared memory at
    each launch) and K2's march see each new stamp."""
    from fdtd_solver_antennas_tpu_torch.ops.fdtd import set_port_excitation

    sim = _two_patch_sim(mode)
    if mode == "chunk":
        st = fdtd_cuda.new_state(sim.padded_shape, cuda, False)
        assert fdtd_cuda.chunk_launch_plan(sim.operands, st).form == "resident"
    src = sim.operands.src
    runs = []
    for drive in ((1.0, 0.0), (0.0, 1.0), (1.0, 1.0)):
        set_port_excitation(sim, drive)
        assert sim.operands.src is src
        fdtd_cuda.reset_launch_counts()
        fdtd_stream.reset_launch_counts()
        runs.append(run_simulation(sim, fdtd_stream.kernels))
        assert runs[-1]["steps"] == 1344
        if mode == "chunk":
            assert fdtd_cuda.launches_by_form["resident"] == 3
            assert sum(fdtd_cuda.launches.values()) == 3
        else:
            assert fdtd_stream.launches_by_kernel["stream_march"] == 1344 // 4
            assert fdtd_cuda.launches["chunk_steps"] == 0
    _assert_linear(*runs)
    assert not np.allclose(runs[0]["uf"], runs[1]["uf"])


@pytest.mark.parametrize("mode", ["chunk", "stream"])
def test_reexcitation_reaches_a_running_state(cuda, mode):
    """Re-excited between two launches on one state: the packed launch
    arguments kept on the state (K1's ``_chunk``, K2's ``_stream``) are
    reused and point at the rewritten stamps, so the second launch steps
    with the new drive, as the plain twin does."""
    from fdtd_solver_antennas_tpu_torch.ops.fdtd import (
        ProbeDFT, padded_waveform, set_port_excitation)

    sim = _two_patch_sim(mode)
    ops, D = sim.operands, sim.probe_decim
    wf = padded_waveform(sim)

    def go(impl, second):
        set_port_excitation(sim, (1.0, 0.0))
        st = fdtd_cuda.new_state(sim.padded_shape, cuda, False)
        bufs = ProbeDFT(sim, 2, cuda).bufs
        if mode == "chunk":
            wf_t = torch.tensor(wf, dtype=torch.float32, device=cuda)
            impl.chunk_steps(ops, st, wf_t, 0, 2, D, bufs)
            cached = st._chunk
            set_port_excitation(sim, second)
            impl.chunk_steps(ops, st, wf_t, 2 * D, 2, D, bufs)
            assert st._chunk is cached
        else:
            for k in range(4 * D // 4):
                if k == 2 * D // 4:
                    cached = st._stream
                    set_port_excitation(sim, second)
                impl.stream_steps(ops, st, wf[4 * k:4 * k + 4])
            assert st._stream is cached
        return (*st.fields, bufs)

    kern = go(fdtd_stream.kernels, (0.0, 1.0))
    plain = go(fdtd_stream.plain, (0.0, 1.0))
    same = go(fdtd_stream.kernels, (1.0, 0.0))
    for a, b in zip(kern, plain, strict=True):
        _close(a, b)
    assert not torch.allclose(kern[2], same[2])


@pytest.mark.parametrize("mode", ["chunk", "stream"])
def test_run_on_a_second_card_from_a_worker_thread(cuda, mode):
    """A run on ``cuda:1`` from a new thread (which starts on device 0)
    launches on ``cuda:1``: bit-equal to the same run from the main
    thread, and neither thread's current device moves."""
    import threading

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    dev = torch.device("cuda", 1)
    before = torch.cuda.current_device()
    ref = _sim("MUR", device=dev, mode=mode).run()
    assert torch.cuda.current_device() == before
    box = {}

    def work():
        box["before"] = torch.cuda.current_device()
        box["out"] = _sim("MUR", device=dev, mode=mode).run()
        box["after"] = torch.cuda.current_device()

    t = threading.Thread(target=work, daemon=True)
    t.start()
    t.join(300)
    assert not t.is_alive() and "out" in box
    assert box["before"] == box["after"] == 0
    out = box["out"]
    assert out["fields"][0].device == dev
    assert int(out["steps"]) == int(ref["steps"])
    for a, b in zip(out["fields"], ref["fields"], strict=True):
        assert torch.equal(a, b)
    host = (lambda x: x.cpu().numpy() if torch.is_tensor(x)
            else np.asarray(x))
    for key in ("uf", "if_", "nf_e", "nf_h"):
        assert np.array_equal(host(out[key]), host(ref[key])), key

