"""The port's interval stepper (K4) against the TPU interval kernel on the CPU.

``fdtd_steps.build_stepper``'s ``step_fn`` advances the six fields by one
probe interval of D steps; on CPU tensors it runs the plain twin. The JAX
package's ``build_pallas_stepper`` does the same in its lane layout, run
in interpret mode as the JAX package's own tests run it on the CPU. Both
start from zero fields and are driven by the same waveform chunks for
several consecutive intervals (the TPU kernel's roll wrap relies on the
zero-coefficient masking invariant, which random edge values would
break); after every interval the six fields must agree at rtol 2e-4 and
atol 1e-5·max|ref|, max|ref| over the six fields (the z-directed port
leaves Hz at round-off level, as ``tests/test_pallas_kernel.py`` notes). The twin itself must equal D plain ``leapfrog_step``s
bit for bit, also on a grid with Pz > 128, which the TPU kernel refuses.
"""

import functools

import numpy as np
import pytest
import torch

from fdtd_solver_antennas_tpu.models.scene import Scene as JScene
from fdtd_solver_antennas_tpu.ops.fdtd import FDTDConfig as JConfig
from fdtd_solver_antennas_tpu.ops.fdtd import build_simulation as jbuild
from fdtd_solver_antennas_tpu.ops.fdtd_pallas import build_pallas_stepper
from fdtd_solver_antennas_tpu.ops.mesh import MeshBuilder as JMeshBuilder

from fdtd_solver_antennas_tpu_torch.models.scene import Scene
from fdtd_solver_antennas_tpu_torch.ops import fdtd_cuda, fdtd_steps
from fdtd_solver_antennas_tpu_torch.ops.fdtd import FDTDConfig, build_simulation
from fdtd_solver_antennas_tpu_torch.ops.mesh import MeshBuilder

RTOL = 2e-4
D = 4
INTERVALS = 5


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Test workers share the cores (pytest-xdist)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene(mesh_builder, scene_cls, tall=False):
    """The small scene of tests/test_pallas_kernel.py (``tall``: the
    140-line z mesh of its z > 128 test)."""
    mb = mesh_builder()
    if tall:
        mb.add_line("x", [-30, 30, 0.0, -6.0])
        mb.add_line("y", [-30, 30, 0.0])
        mb.add_line("z", np.linspace(-40, 56, 140))
        grid = mb.build(8.0)
    else:
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


def _controls(boundary):
    return dict(n_steps_max=120, check_every=120, end_criteria=1e-30,
                boundary=boundary, probe_decimation=D)


_KW = dict(f0=2.45e9, fc=1.225e9, port_freqs_hz=np.linspace(2e9, 3e9, 11),
           nf_freqs_hz=np.array([2.45e9]))


@functools.lru_cache(maxsize=None)
def _port_sim(boundary, tall=False):
    sc, grid = _scene(MeshBuilder, Scene, tall)
    return build_simulation(sc, grid, cfg=FDTDConfig(**_controls(boundary)),
                            device="cpu", **_KW)


def _jax_sim(boundary):
    sc, grid = _scene(JMeshBuilder, JScene)
    return jbuild(sc, grid, cfg=JConfig(use_pallas=False, **_controls(boundary)),
                  **_KW)


def _zero_fields(sim):
    return tuple(torch.zeros(sim.padded_shape) for _ in range(6))


@pytest.mark.parametrize("boundary", ["MUR", "PEC"])
def test_stepper_matches_tpu_interval_kernel(boundary):
    import jax.numpy as jnp

    jsim = _jax_sim(boundary)
    psim = _port_sim(boundary)
    assert psim.probe_decim == jsim.probe_decim == D
    assert tuple(psim.padded_shape) == tuple(jsim.grid.shape)
    wf = np.asarray(jsim.waveform, np.float32)
    np.testing.assert_array_equal(np.asarray(psim.waveform, np.float32), wf)

    jstep, jto, jfrom = build_pallas_stepper(jsim, *jsim._aux[:3])
    pstep, pto, pfrom = fdtd_steps.build_stepper(psim, *psim._aux[:3])
    jf = tuple(jto(jnp.zeros(jsim.grid.shape, jnp.float32)) for _ in range(6))
    pf = tuple(pto(f) for f in _zero_fields(psim))
    for i in range(INTERVALS):
        chunk = wf[i * D:(i + 1) * D]
        jf = jstep(jf, jnp.asarray(chunk))
        pf = pstep(pf, chunk)
        refs = [np.asarray(jfrom(b)) for b in jf]
        scale = max(float(np.abs(r).max()) for r in refs)
        assert scale > 0
        for c, (a, ref) in enumerate(zip(pf, refs, strict=True)):
            np.testing.assert_allclose(pfrom(a).numpy(), ref, rtol=RTOL,
                                       atol=1e-5 * scale,
                                       err_msg=f"interval {i} field {c}")


def _random_fields(sim, seed):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(sim.padded_shape)
                                  .astype(np.float32)) for _ in range(6))


@pytest.mark.parametrize("boundary,tall", [("MUR", False), ("PEC", False),
                                           ("MUR", True)])
def test_plain_step_fn_equals_leapfrog_steps(boundary, tall):
    """D plain leapfrog steps per interval, bit for bit, over successive
    intervals; the Pz > 128 grid the TPU kernel refuses runs too."""
    sim = _port_sim(boundary, tall)
    if tall:
        assert sim.padded_shape[2] > 128
    step_fn, _, _ = fdtd_steps.build_stepper(sim, *sim._aux[:3])
    fields = _random_fields(sim, seed=3)
    st = fdtd_cuda.new_state(sim.padded_shape, "cpu", pml=False)
    for t, f in zip(st.fields, fields):
        t.copy_(f)
    ops = sim.operands
    rng = np.random.default_rng(4)
    fdtd_steps.reset_launch_counts()
    for _ in range(3):
        wf = rng.uniform(-1.0, 1.0, D).astype(np.float32)
        out = step_fn(fields, wf)
        assert not any(a is b for a, b in zip(out, fields))  # new tensors
        for s in wf:
            fdtd_cuda.leapfrog_step(fdtd_cuda.plain, ops, st, float(s))
        for a, b in zip(out, st.fields, strict=True):
            assert torch.equal(a, b)
        fields = out
    assert fdtd_steps.launches == {"interval_steps": 0}


def test_odd_interval_lands_in_the_callers_tensors():
    """With D odd the last E sits in the second buffer; the tensors
    step_fn returns hold the result all the same."""
    sim = _port_sim("MUR")
    fields = _random_fields(sim, seed=8)
    ref = fdtd_cuda.new_state(sim.padded_shape, "cpu", pml=False)
    for t, f in zip(ref.fields, fields):
        t.copy_(f)
    odd = fdtd_steps.build_stepper(
        _with_decim(sim, 3), *sim._aux[:3])[0]
    out = odd(fields, [0.1, -0.2, 0.3])
    fdtd_steps.interval_steps_plain(sim.operands, ref, [0.1, -0.2, 0.3])
    assert ref.parity == 1
    for a, b in zip(out, ref.fields, strict=True):
        assert torch.equal(a, b)


@pytest.mark.parametrize("boundary", ["MUR", "PEC"])
def test_step_fn_leaves_its_inputs_unchanged(boundary):
    """As the JAX stepper returns new arrays: the six input tensors are
    bit for bit what they were after a call, and the outputs still equal
    the TPU interval kernel's (interpret mode) from the same inputs."""
    import jax.numpy as jnp

    jsim = _jax_sim(boundary)
    psim = _port_sim(boundary)
    wf = np.asarray(jsim.waveform, np.float32)
    jstep, jto, jfrom = build_pallas_stepper(jsim, *jsim._aux[:3])
    pstep, _, _ = fdtd_steps.build_stepper(psim, *psim._aux[:3])
    jf = tuple(jto(jnp.zeros(jsim.grid.shape, jnp.float32)) for _ in range(6))
    pf = _zero_fields(psim)
    for i in range(2):  # from zero fields into a live state, as above
        chunk = wf[i * D:(i + 1) * D]
        jf = jstep(jf, jnp.asarray(chunk))
        pf = pstep(pf, chunk)
    before = tuple(f.clone() for f in pf)
    chunk = wf[2 * D:3 * D]
    out = pstep(pf, chunk)
    for a, b in zip(pf, before, strict=True):
        assert torch.equal(a, b)
    refs = [np.asarray(jfrom(b)) for b in jstep(jf, jnp.asarray(chunk))]
    scale = max(float(np.abs(r).max()) for r in refs)
    assert scale > 0
    for c, (a, ref) in enumerate(zip(out, refs, strict=True)):
        assert a is not pf[c]
        np.testing.assert_allclose(a.numpy(), ref, rtol=RTOL, atol=1e-5 * scale,
                                   err_msg=f"field {c}")


def _with_decim(sim, decim):
    import dataclasses

    return dataclasses.replace(sim, probe_decim=decim)


def test_cpml_and_bad_inputs_raise():
    sc, grid = _scene(MeshBuilder, Scene)
    pml = build_simulation(sc, grid, cfg=FDTDConfig(**_controls("PML_4")),
                           device="cpu", **_KW)
    with pytest.raises(ValueError, match="MUR/PEC"):
        fdtd_steps.build_stepper(pml, *pml._aux[:3])
    sim = _port_sim("MUR")
    step_fn, to_flat, from_flat = fdtd_steps.build_stepper(sim, *sim._aux[:3])
    f = _zero_fields(sim)
    assert to_flat(f[0]) is f[0] and from_flat(f[0]) is f[0]
    with pytest.raises(ValueError, match="samples"):
        step_fn(f, [0.0] * (D + 1))
    with pytest.raises(ValueError, match="six"):
        step_fn(f[:5], [0.0] * D)
    with pytest.raises(ValueError, match="shape"):
        step_fn((torch.zeros(3, 3, 3),) + f[1:], [0.0] * D)
    with pytest.raises(ValueError, match="at least one"):
        fdtd_steps.interval_steps(sim.operands, fdtd_cuda.new_state(
            sim.padded_shape, "cpu", pml=False), [])


def test_stepper_defaults_to_the_simulations_device():
    """The stepper's operands live where the simulation does; asking for
    the card where there is none raises."""
    sim = _port_sim("PEC")
    step_fn, _, _ = fdtd_steps.build_stepper(sim, *sim._aux[:3])
    out = step_fn(_zero_fields(sim), [1.0] * D)
    assert out[0].device.type == "cpu" and float(out[2].abs().max()) > 0
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        fdtd_steps.build_stepper(sim, *sim._aux[:3], device="cuda")
