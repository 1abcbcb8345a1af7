"""The port's stream mode (K2) against the JAX package's XLA path on the CPU.

The scene of ``tests/test_stream_kernel.py`` (MUR, PEC and PML_4, and its
tall z = 131 variant) runs through the JAX XLA path and through the port
forced onto the stream kernel with T = 1, 2 and 4 steps per launch. On the
CPU the launch is its plain twin, T calls of the plain leapfrog step, so
stream mode must also equal chunk mode exactly. The whole output surface
must agree at rtol 2e-4 and atol 1e-5·max|ref|, the JAX package's own
kernel-vs-XLA tolerance. The mode resolver is checked on its inputs, and
a JAX checkpoint resumes on the stream path.
"""

import functools

import numpy as np
import pytest
import torch

from fdtd_solver_antennas_tpu.models.scene import Scene as JScene
from fdtd_solver_antennas_tpu.ops.fdtd import FDTDConfig as JConfig
from fdtd_solver_antennas_tpu.ops.fdtd import build_simulation as jbuild
from fdtd_solver_antennas_tpu.ops.mesh import MeshBuilder as JMeshBuilder

from fdtd_solver_antennas_tpu_torch.models.scene import Scene
from fdtd_solver_antennas_tpu_torch.ops import fdtd_stream
from fdtd_solver_antennas_tpu_torch.ops.fdtd_cuda import (
    PSI_KEYS,
    new_batch_state,
    new_state,
)
from fdtd_solver_antennas_tpu_torch.ops.fdtd import (
    L2_BYTES,
    FDTDConfig,
    build_simulation,
    resolve_pallas_mode,
    run_simulation,
    working_set_bytes,
)
from fdtd_solver_antennas_tpu_torch.ops.mesh import MeshBuilder

RTOL = 2e-4
THREADS = 1  # PyTorch intra-op threads while this file runs
N_STEPS = 120
_FREQS = dict(port_freqs_hz=np.linspace(2e9, 3e9, 7),
              nf_freqs_hz=np.array([2.45e9]))


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Test workers share the cores (pytest-xdist); PyTorch's default of
    one intra-op thread per core would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(n)


def _scene(mesh_builder, scene_cls, boundary, tall):
    """``_build`` of tests/test_stream_kernel.py: PML gets a wider
    footprint; ``tall`` puts 131 lines on z."""
    pml = boundary.startswith("PML")
    mb = mesh_builder()
    span = 52 if pml else 40
    mb.add_line("x", [-span, span, 0.0, -6.0])
    mb.add_line("y", [-span * 0.75, span * 0.75, 0.0])
    if tall:
        mb.add_line("z", np.linspace(-20, 30, 131))
    else:
        mb.add_line("z", [-20, 30])
        mb.add_line("z", np.linspace(0, 1.6, 3))
    grid = mb.build(4.0 if pml else 5.0)
    scene = scene_cls()
    scene.add_material_box("sub", 4.3, 0.005, [-20, -20, 0], [20, 20, 1.6], 0)
    scene.add_metal_box("patch", [-15, -12, 1.6], [15, 12, 1.6], priority=10)
    scene.add_metal_box("gnd", [-20, -20, 0], [20, 20, 0], priority=10)
    scene.add_lumped_port(1, 50.0, [-6, 0, 0], [-6, 0, 1.6], direction="z")
    return scene, grid


def _controls(boundary, n_steps):
    return dict(n_steps_max=n_steps, check_every=40, end_criteria=1e-30,
                boundary=boundary, probe_decimation=4)


def _jax_sim(boundary, tall=False, n_steps=N_STEPS, **cfg):
    scene, grid = _scene(JMeshBuilder, JScene, boundary, tall)
    cfg = JConfig(**{"use_pallas": False, **_controls(boundary, n_steps), **cfg})
    return jbuild(scene, grid, f0=2.45e9, fc=1.225e9, cfg=cfg, **_FREQS)


def _port_sim(boundary, tall=False, n_steps=N_STEPS, mode="stream", T=None,
              **cfg):
    scene, grid = _scene(MeshBuilder, Scene, boundary, tall)
    cfg = FDTDConfig(pallas_mode=mode, stream_T=T,
                     **{**_controls(boundary, n_steps), **cfg})
    return build_simulation(scene, grid, f0=2.45e9, fc=1.225e9, cfg=cfg,
                            device="cpu", **_FREQS)


@functools.lru_cache(maxsize=None)
def _jax_ref(boundary, tall):
    return _jax_sim(boundary, tall).run()


def _close(a, b, rtol=RTOL, scale=None):
    """rtol 2e-4, atol 1e-5·max|ref|. ``scale`` replaces max|ref| by the
    max over the component's stack (E, H or a ψ group): on the tall grid
    Hz peaks 170× below Hx and Hy, and its float32 rounding comes from
    them."""
    a = a.numpy() if torch.is_tensor(a) else np.asarray(a)
    b = np.asarray(b)
    ref_max = float(np.abs(b).max()) if scale is None else scale
    np.testing.assert_allclose(a, b, rtol=rtol, atol=1e-5 * max(ref_max, 1e-20))


def _stack_max(arrays):
    return max((float(np.abs(np.asarray(x)).max()) for x in arrays), default=0.0)


def _assert_same_surface(out, ref):
    assert int(out["steps"]) == int(ref["steps"])
    _close(out["e_ratio"], float(ref["e_ratio"]))
    for stack in (slice(0, 3), slice(3, 6)):
        scale = _stack_max(ref["fields"][stack])
        for fa, fb in zip(out["fields"][stack], ref["fields"][stack], strict=True):
            _close(fa, fb, scale=scale)
    _close(out["uf"], ref["uf"])
    _close(out["if_"], ref["if_"])
    for key in ("nf_e", "nf_h"):
        for a, b in zip(out[key], ref[key], strict=True):
            _close(a, b)
    for grp in ("psi_e", "psi_h"):
        assert set(out["state"][grp]) == set(ref["state"][grp])
        scale = _stack_max(ref["state"][grp].values())
        for k, v in ref["state"][grp].items():
            _close(out["state"][grp][k], v, scale=scale)


@pytest.mark.parametrize("T", [1, 2, 4])
@pytest.mark.parametrize("tall", [False, True])
@pytest.mark.parametrize("boundary", ["MUR", "PEC", "PML_4"])
def test_stream_matches_jax_xla_path(boundary, tall, T):
    sim = _port_sim(boundary, tall, T=T)
    assert sim.pallas_mode == "stream" and sim.stream_T == T
    assert sim.probe_decim == 4
    out = sim.run()
    assert not out["aborted"]
    _assert_same_surface(out, _jax_ref(boundary, tall))


@pytest.mark.parametrize("boundary", ["MUR", "PEC", "PML_4"])
def test_stream_mode_equals_chunk_mode_on_cpu(boundary):
    """On the CPU a stream launch is T plain leapfrog steps: bit-equal."""
    a = _port_sim(boundary, mode="stream", T=4).run()
    b = _port_sim(boundary, mode="chunk").run()
    for fa, fb in zip((*a["fields"], *a["state"]["psi_e"].values()),
                      (*b["fields"], *b["state"]["psi_e"].values())):
        assert torch.equal(fa, fb)
    np.testing.assert_array_equal(a["uf"], b["uf"])
    np.testing.assert_array_equal(a["if_"], b["if_"])
    assert fdtd_stream.launches == dict.fromkeys(fdtd_stream.KERNELS, 0)


def test_plain_impl_equals_dispatching_impl_in_stream_mode():
    sim = _port_sim("PML_4", T=2)
    a = run_simulation(sim, fdtd_stream.kernels)
    b = run_simulation(sim, fdtd_stream.plain)
    for fa, fb in zip(a["fields"], b["fields"]):
        assert torch.equal(fa, fb)
    from fdtd_solver_antennas_tpu_torch.ops import fdtd_cuda

    with pytest.raises(ValueError, match="stream_steps"):
        run_simulation(sim, fdtd_cuda.kernels)


def test_resolver_canonical_patch_stays_chunk():
    from fdtd_solver_antennas_tpu_torch.models.params import PatchAntennaParams
    from fdtd_solver_antennas_tpu_torch.solvers.patch_fixed import build_patch_scene

    params = PatchAntennaParams.from_user_units(
        frequency_ghz=2.45, er=4.3, h_mm=1.6, loss_tangent=0.02)
    _scene_, grid, _f0, _fc = build_patch_scene(params)
    assert grid.shape == (56, 55, 50)
    assert working_set_bytes(grid.shape, 1, False) < L2_BYTES
    mode, T, decim, why = resolve_pallas_mode(FDTDConfig(), grid.shape, 1, 89)
    assert (mode, T, decim) == ("chunk", 1, 89), why


@pytest.mark.parametrize("shape,boundary,t_max", [
    ((161, 121, 160), "MUR", 4),       # the tall patch
    ((141, 201, 152), "MUR", 4),       # the 4.2M-cell mixed scene
    ((161, 121, 160), "PML_8", 4),
    ((141, 201, 152), "PML_8", 4),     # the mixed scene under PML_8
    ((161, 121, 160), "PEC", 5),
])
def test_resolver_large_grids_go_stream(shape, boundary, t_max):
    """The deepest T is the march's: its region (core + 2T per axis) fits
    the threads and shared memory at T and not at T + 1."""
    cfg = FDTDConfig(boundary=boundary)
    assert working_set_bytes(shape, 2, cfg.pml_cells() > 0) > L2_BYTES
    mode, T, decim, why = resolve_pallas_mode(cfg, shape, 2, 316)
    assert mode == "stream" and T == t_max, why
    assert decim == (316 // T) * T
    mur = boundary == "MUR"
    pml = cfg.pml_cells() > 0
    assert "march under" in why
    smem = fdtd_stream.march_plan(shape, shape, T, mur, pml=pml)[4]
    assert smem <= fdtd_stream.SMEM_LIMIT
    with pytest.raises(ValueError, match=f"march takes no T={T + 1}"):
        fdtd_stream.march_plan(shape, shape, T + 1, mur, pml=pml)
    # a decimation below the deepest T bounds T, as in the JAX package
    assert resolve_pallas_mode(cfg, shape, 2, 3)[1:3] == (3, 3)


def test_resolver_rejects_what_it_cannot_honor():
    shape = (161, 121, 160)
    with pytest.raises(ValueError, match="stream_T=4 cannot be honored"):
        resolve_pallas_mode(FDTDConfig(pallas_mode="stream", stream_T=4),
                            shape, 1, 2)
    with pytest.raises(ValueError, match="stream_T=8 cannot be honored"):
        resolve_pallas_mode(FDTDConfig(stream_T=8), shape, 1, 316)
    with pytest.raises(ValueError, match="pallas_mode"):
        resolve_pallas_mode(FDTDConfig(pallas_mode="tiled"), shape, 1, 316)
    with pytest.raises(ValueError, match="cannot be honored"):
        _port_sim("MUR", T=4, probe_decimation=2)
    # forced chunk is always honoured
    assert resolve_pallas_mode(FDTDConfig(pallas_mode="chunk"), shape, 1,
                               316)[:2] == ("chunk", 1)


def test_probe_decimation_rounds_as_jax_does():
    """A forced T = 4 with decimation 10 samples every 8 steps in both
    packages (the JAX package resolving its own stream kernel)."""
    j = _jax_sim("MUR", use_pallas=True, pallas_mode="stream", stream_T=4,
                 probe_decimation=10)
    assert j.pallas_mode == "stream" and j.stream_T == 4
    p = _port_sim("MUR", T=4, probe_decimation=10)
    assert p.stream_T == 4
    assert p.probe_decim == j.probe_decim == 8


@pytest.mark.parametrize("boundary", ["MUR", "PML_4"])
def test_jax_checkpoint_resumes_on_stream_path(boundary):
    """A JAX mid-run checkpoint resumes on the port's stream path to the
    same result as the JAX package resuming it."""
    first = _jax_sim(boundary, n_steps=60).run()
    state = {k: (tuple(np.asarray(f) for f in v) if k == "fields" else
                 {kk: np.asarray(vv) for kk, vv in v.items()}
                 if isinstance(v, dict) else np.asarray(v))
             for k, v in first["state"].items()}
    ref = _jax_sim(boundary).run(resume_state=state)
    out = _port_sim(boundary, T=4).run(resume_state=state)
    assert int(out["steps"]) == N_STEPS
    _assert_same_surface(out, ref)


def _psi_outside_slabs(sim, state):
    """max |ψ| over the cells outside each ψ's slab
    (``fdtd_stream.psi_slabs``: its axis's flat profile run)."""
    keep = fdtd_stream.psi_slabs(sim.operands)
    arrays = [state[grp][k] for grp in ("psi_e", "psi_h") for k in PSI_KEYS]
    assert len(arrays) == len(keep) == 12
    return max(float(torch.as_tensor(np.asarray(a))[~k.expand(a.shape)].abs().max())
               for a, k in zip(arrays, keep))


@pytest.mark.parametrize("start", ["new_state", "jax_checkpoint"])
def test_twin_keeps_psi_zero_outside_slabs(start):
    """The invariant the march's ψ skipping rests on: the plain twin keeps
    every ψ at exactly 0 outside its slab, over 200 steps from
    ``new_state``, and from a JAX checkpoint (60 steps, itself 0 there)
    resumed on the stream path to step 120; the ψ inside the slabs move."""
    if start == "new_state":
        sim = _port_sim("PML_4", n_steps=200, T=4)
        out = sim.run()
        assert int(out["steps"]) == 200
    else:
        first = _jax_sim("PML_4", n_steps=60).run()
        state = {k: (tuple(np.asarray(f) for f in v) if k == "fields" else
                     {kk: np.asarray(vv) for kk, vv in v.items()}
                     if isinstance(v, dict) else np.asarray(v))
                 for k, v in first["state"].items()}
        sim = _port_sim("PML_4", T=4)
        assert _psi_outside_slabs(sim, state) == 0.0
        out = sim.run(resume_state=state)
        assert int(out["steps"]) == N_STEPS
    assert _psi_outside_slabs(sim, out["state"]) == 0.0
    assert min(float(v.abs().max()) for v in out["state"]["psi_h"].values()) > 0


@pytest.mark.parametrize("batch", [0, 3])
@pytest.mark.parametrize("where", ["nowhere", "slab", "flat"])
def test_check_psi_flat_refuses_psi_outside_slabs(where, batch):
    """``fdtd_stream.check_psi_flat``, which the card's march runs on every
    state it is first given, passes a state whose ψ are 0 outside their
    slabs (non-zero inside one or not) and names the ψ that is not: the
    march skips a ψ there, so such a state would step differently from
    the twin."""
    sim = _port_sim("PML_4", T=4)
    ops = sim.operands
    st = (new_batch_state(sim.padded_shape, "cpu", True, batch) if batch
          else new_state(sim.padded_shape, "cpu", True))
    keep = fdtd_stream.psi_slabs(ops)[7].flatten()  # psi_h[1]: its axis z
    assert fdtd_stream.PSI_AXIS[1] == 2 and keep.any() and not keep.all()
    if where != "nowhere":
        z = int(torch.nonzero(keep if where == "slab" else ~keep)[0])
        st.psi_h[1][..., 3, 2, z] = 0.5
    psi = (*st.psi_e, *st.psi_h)
    if where == "flat":
        with pytest.raises(ValueError, match=r"psi_h\[1\]"):
            fdtd_stream.check_psi_flat(ops, psi)
    else:
        fdtd_stream.check_psi_flat(ops, psi)
