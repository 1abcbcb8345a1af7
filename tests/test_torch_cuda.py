"""The port's CUDA kernels against their plain PyTorch twins, on the card.

These tests need an NVIDIA GPU and skip elsewhere: a CUDA kernel has no
CPU mode. The file imports nothing of JAX, so it runs on the machine
with the card, where JAX is not installed (``tests/conftest.py`` imports
JAX, hence ``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from fdtd_solver_antennas_tpu_torch.models.scene import Scene
from fdtd_solver_antennas_tpu_torch.ops import fdtd_cuda
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


def _sim(boundary, n_steps=120):
    """The small scene of tests/test_pallas_kernel.py, on the card."""
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
                     end_criteria=1e-30, boundary=boundary, probe_decimation=4)
    return build_simulation(
        scene, grid, f0=2.45e9, fc=1.225e9, cfg=cfg, device="cuda",
        port_freqs_hz=np.linspace(2e9, 3e9, 11),
        nf_freqs_hz=np.array([2.45e9]))


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
    n_mur = 3 * 120 if boundary == "MUR" else 0
    assert fdtd_cuda.launches == {"h_update": 120, "e_update": 120,
                                  "mur_faces": n_mur, "probe_gather": 30}
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


def _random_state(sim, device, seed):
    rng = np.random.default_rng(seed)
    st = fdtd_cuda.new_state(sim.padded_shape, device,
                             pml=sim.operands.pml is not None)
    for t in (*st.e[0], *st.e[1], *st.h, *st.psi_e, *st.psi_h):
        t.copy_(torch.from_numpy(rng.standard_normal(t.shape).astype(np.float32)))
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


def test_wrappers_reject_bad_operands(cuda):
    sim = _sim("MUR")
    st = fdtd_cuda.new_state(sim.padded_shape, cuda, pml=False)
    out = torch.zeros(sim.operands.probe_idx.shape[0] + 1, device=cuda)
    with pytest.raises(ValueError, match="shape"):
        fdtd_cuda.probe_gather(sim.operands, st, out)
    bad = fdtd_cuda.new_state(sim.padded_shape, cuda, pml=False)
    bad.h = (bad.h[0].double(), bad.h[1], bad.h[2])
    with pytest.raises(ValueError, match="float32"):
        fdtd_cuda.h_update(sim.operands, bad)
    pec = _sim("PEC")
    with pytest.raises(ValueError, match="MUR"):
        fdtd_cuda.mur_faces(pec.operands, st, 0)
