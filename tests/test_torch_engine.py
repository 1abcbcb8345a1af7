"""The port's engine against the JAX package's engine on the CPU.

The small scene of ``tests/test_pallas_kernel.py`` runs through the JAX
XLA path (``use_pallas=False``) and through the port, whose step on the
CPU is the plain PyTorch twin of its CUDA kernels. The whole output
surface — fields, port and NF2FF DFTs, ψ, steps, e_ratio — must agree at
rtol 2e-4 and atol 1e-5·max|ref|, the JAX package's own kernel-vs-XLA
tolerance. One MUR case is held against the TPU chunk kernel itself in
interpret mode, and checkpoints carry across between the packages.
"""

import numpy as np
import pytest
import torch

from fdtd_solver_antennas_tpu.models.scene import Scene as JScene
from fdtd_solver_antennas_tpu.ops.fdtd import FDTDConfig as JConfig
from fdtd_solver_antennas_tpu.ops.fdtd import build_simulation as jbuild
from fdtd_solver_antennas_tpu.ops.mesh import MeshBuilder as JMeshBuilder

from fdtd_solver_antennas_tpu_torch.models.scene import Scene
from fdtd_solver_antennas_tpu_torch.ops import fdtd_cuda
from fdtd_solver_antennas_tpu_torch.ops.fdtd import (
    FDTDConfig,
    build_simulation,
    run_simulation,
    state_to_numpy,
)
from fdtd_solver_antennas_tpu_torch.ops.mesh import MeshBuilder

RTOL = 2e-4


def _scene(mesh_builder, scene_cls):
    mb = mesh_builder()
    mb.add_line("x", [-40, 40, 0.0, -6.0])
    mb.add_line("y", [-40, 40, 0.0])
    mb.add_line("z", [-20, 30])
    mb.add_line("z", np.linspace(0, 1.6, 3))
    grid = mb.build(5.0)
    scene = scene_cls()
    scene.add_material_box("sub", 4.3, 0.005, [-20, -20, 0], [20, 20, 1.6], 0)
    scene.add_metal_box("patch", [-15, -12, 1.6], [15, 12, 1.6], priority=10)
    scene.add_metal_box("gnd", [-20, -20, 0], [20, 20, 0], priority=10)
    scene.add_lumped_port(1, 50.0, [-6, 0, 0], [-6, 0, 1.6], direction="z")
    return scene, grid


_FREQS = dict(port_freqs_hz=np.linspace(2e9, 3e9, 11),
              nf_freqs_hz=np.array([2.45e9]))


def _controls(boundary, n_steps, check_every=None):
    return dict(n_steps_max=n_steps, check_every=check_every or n_steps,
                end_criteria=1e-30, boundary=boundary, probe_decimation=4)


def _jax_sim(boundary="MUR", n_steps=120, use_pallas=False, check_every=None):
    scene, grid = _scene(JMeshBuilder, JScene)
    cfg = JConfig(use_pallas=use_pallas,
                  **_controls(boundary, n_steps, check_every))
    return jbuild(scene, grid, f0=2.45e9, fc=1.225e9, cfg=cfg, **_FREQS)


def _port_sim(boundary="MUR", n_steps=120, check_every=None):
    scene, grid = _scene(MeshBuilder, Scene)
    cfg = FDTDConfig(**_controls(boundary, n_steps, check_every))
    return build_simulation(scene, grid, f0=2.45e9, fc=1.225e9, cfg=cfg,
                            device="cpu", **_FREQS)


def _close(a, b, rtol=RTOL):
    a = a.numpy() if torch.is_tensor(a) else np.asarray(a)
    b = np.asarray(b)
    atol = 1e-5 * max(float(np.abs(b).max()), 1e-20)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


def _assert_same_surface(out, ref):
    assert int(out["steps"]) == int(ref["steps"])
    _close(out["e_ratio"], float(ref["e_ratio"]))
    for fa, fb in zip(out["fields"], ref["fields"], strict=True):
        _close(fa, fb)
    _close(out["uf"], ref["uf"])
    _close(out["if_"], ref["if_"])
    for key in ("nf_e", "nf_h"):
        for a, b in zip(out[key], ref[key], strict=True):
            _close(a, b)
    for grp in ("psi_e", "psi_h"):
        assert set(out["state"][grp]) == set(ref["state"][grp])
        for k, v in ref["state"][grp].items():
            _close(out["state"][grp][k], v)


@pytest.mark.parametrize("boundary", ["MUR", "PEC", "PML_4"])
def test_port_matches_jax_xla_path(boundary):
    ref = _jax_sim(boundary).run()
    out = _port_sim(boundary).run()
    assert not out["aborted"]
    _assert_same_surface(out, ref)


def test_port_matches_tpu_chunk_kernel_interpret_mode():
    """MUR against K1 itself, run in interpret mode as the JAX package's
    own kernel tests run it on the CPU."""
    sim_pl = _jax_sim("MUR", use_pallas=True)
    assert sim_pl.pallas_mode == "chunk"
    ref = sim_pl.run()
    out = _port_sim("MUR").run()
    for fa, fb in zip(out["fields"], ref["fields"], strict=True):
        _close(fa, fb)
    _close(out["uf"], ref["uf"])
    _close(out["if_"], ref["if_"])
    for key in ("nf_e", "nf_h"):
        for a, b in zip(out[key], ref[key], strict=True):
            _close(a, b)


@pytest.mark.parametrize("boundary", ["MUR", "PML_4"])
def test_resume_from_jax_state_matches_jax_resume(boundary):
    """A JAX mid-run checkpoint resumes in both packages for one chunk."""
    first = _jax_sim(boundary, n_steps=60).run()
    state = {k: (tuple(np.asarray(f) for f in v) if k == "fields" else
                 {kk: np.asarray(vv) for kk, vv in v.items()}
                 if isinstance(v, dict) else np.asarray(v))
             for k, v in first["state"].items()}
    assert int(state["n"]) == 60
    ref = _jax_sim(boundary, n_steps=120, check_every=60).run(resume_state=state)
    out = _port_sim(boundary, n_steps=120, check_every=60).run(resume_state=state)
    assert int(ref["steps"]) == int(out["steps"]) == 120
    _assert_same_surface(out, ref)


def test_resume_from_a_padded_checkpoint():
    """A checkpoint written with extra zero planes (the JAX package pads
    its arrays for its TPU kernels) resumes to the same result."""
    first = _port_sim("PML_4", n_steps=60).run()
    st = state_to_numpy(first["state"])

    def pad(a):
        return np.pad(a, ((0, 3), (0, 2), (0, 5)))

    padded = dict(st, fields=tuple(pad(f) for f in st["fields"]),
                  psi_e={k: pad(v) for k, v in st["psi_e"].items()},
                  psi_h={k: pad(v) for k, v in st["psi_h"].items()})
    a = _port_sim("PML_4", n_steps=120, check_every=60).run(resume_state=st)
    b = _port_sim("PML_4", n_steps=120, check_every=60).run(
        resume_state=padded)
    for fa, fb in zip(a["fields"], b["fields"], strict=True):
        assert torch.equal(fa, fb)
    np.testing.assert_array_equal(a["uf"], b["uf"])


def test_port_state_resumes_in_jax():
    """The inverse direction: the port's checkpoint, via state_to_numpy,
    resumes the JAX package to the same result as an unbroken JAX run."""
    first = _port_sim("PML_4", n_steps=60).run()
    state = state_to_numpy(first["state"])
    assert state["fields"][0].dtype == np.float32 and state["n"] == 60
    resumed = _jax_sim("PML_4", n_steps=120, check_every=60).run(
        resume_state=state)
    whole = _jax_sim("PML_4", n_steps=120, check_every=60).run()
    _assert_same_surface(resumed, whole)


def test_resume_rescales_dfts_to_a_new_decimation():
    """A checkpoint tagged with another probe decimation has its DFT sums
    scaled by old/new, as the JAX package does."""
    sim = _port_sim("MUR", n_steps=120, check_every=60)
    first = sim.run()
    st = state_to_numpy(first["state"])
    st2 = dict(st, decim=np.int32(2 * int(st["decim"])))
    st2["n"] = np.int32(10**6)  # past n_steps_max: nothing more runs
    sim2 = _port_sim("MUR", n_steps=120, check_every=60)
    out = sim2.run(resume_state=st2)
    assert out["steps"] == 10**6
    _close(out["state"]["uf"], 2 * st["uf"])
    _close(out["state"]["nf_h"], 2 * st["nf_h"])


def test_energy_check_stops_where_jax_stops():
    """The energy-decay exit fires at the same chunk as the JAX package's:
    past the source, at a whole number of chunks."""
    kw = dict(n_steps_max=20_000, check_every=100, end_criteria=1e-2,
              probe_decimation=4)
    scene, grid = _scene(JMeshBuilder, JScene)
    ref = jbuild(scene, grid, f0=2.45e9, fc=1.225e9,
                 cfg=JConfig(use_pallas=False, **kw), **_FREQS).run()
    scene, grid = _scene(MeshBuilder, Scene)
    sim = build_simulation(scene, grid, f0=2.45e9, fc=1.225e9,
                           cfg=FDTDConfig(**kw), device="cpu", **_FREQS)
    out = sim.run()
    assert out["steps"] == int(ref["steps"])
    assert out["steps"] % 100 == 0
    assert sim.n_source_steps < out["steps"] < 20_000
    assert out["e_ratio"] < 1e-2
    _close(out["e_ratio"], float(ref["e_ratio"]))
    _close(out["uf"], ref["uf"])


def test_progress_and_abort_callbacks():
    ticks = []
    sim = _port_sim("MUR", n_steps=120, check_every=40)
    out = sim.run(progress_cb=lambda *a: ticks.append(a),
                  abort_cb=lambda: len(ticks) >= 1)
    assert out["aborted"] and out["steps"] == 40
    assert ticks == [(40, 120, ticks[0][2])]
    ticks.clear()
    out = _port_sim("MUR", n_steps=120, check_every=40).run(
        progress_cb=lambda *a: ticks.append(a))
    assert [t[0] for t in ticks] == [40, 80, 120, 120]


def test_plain_impl_equals_dispatching_impl_on_cpu():
    """On CPU tensors the wrappers run exactly the plain twins."""
    sim = _port_sim("PML_4")
    a = run_simulation(sim, fdtd_cuda.kernels)
    b = run_simulation(sim, fdtd_cuda.plain)
    for fa, fb in zip(a["fields"], b["fields"]):
        assert torch.equal(fa, fb)
    np.testing.assert_array_equal(a["uf"], b["uf"])
    assert fdtd_cuda.launches == dict.fromkeys(fdtd_cuda.KERNELS, 0)


def test_cuda_request_without_cuda_raises():
    """No silent fallback: asking for CUDA where there is none raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    scene, grid = _scene(MeshBuilder, Scene)
    with pytest.raises(RuntimeError, match="cuda"):
        build_simulation(scene, grid, f0=2.45e9, fc=1.225e9, device="cuda")


def test_wrappers_reject_other_devices():
    sim = _port_sim("MUR")
    st = fdtd_cuda.new_state(sim.padded_shape, "meta", pml=False)
    with pytest.raises(ValueError, match="meta"):
        fdtd_cuda.h_update(sim.operands, st)
