"""The port's roll-calibration kernel (K5) and its roofline entry point, on
the CPU.

``examples/chunk_roofline.py::calibrate_rolls`` builds its TPU kernel with
no interpret switch, so the kernel body is copied here into a
``pl.pallas_call(interpret=True)``; ``roll_chain_plain`` must equal it bit
for bit, and equal a ``jnp.roll`` chain bit for bit at 8×512 and at the
default 56×7,040 with few iterations. The port's entry point
``python -m fdtd_solver_antennas_tpu_torch.examples.chunk_roofline`` runs
on the CPU at a small size and prints one JSON line with the JAX script's
keys.
"""

import inspect
import json

import numpy as np
import pytest
import torch

from fdtd_solver_antennas_tpu_torch.examples import chunk_roofline
from fdtd_solver_antennas_tpu_torch.ops import roll_chain as rc

JAX_KEYS = {"metric", "roll_rate_gelems_per_s", "rolls_per_padded_elem",
            "padding_factor", "bound_gcells_per_s", "calibration"}
JAX_CALIBRATION_KEYS = {"roll_gelems_per_s", "wall_s", "shape", "iters"}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Test workers share the cores (pytest-xdist)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _input(R, C, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(0.5, 1.5, (R, C)).astype(np.float32)


def _tpu_kernel(R, C, iters):
    """The body of examples/chunk_roofline.py::calibrate_rolls, in
    interpret mode."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    def kern(a_ref, o_ref):
        a = a_ref[:]

        def body(i, x):
            x = pltpu.roll(x, 1, 1) + a
            x = pltpu.roll(x, 128, 1) * np.float32(0.9999)
            x = pltpu.roll(x, C - 1, 1) + a
            x = pltpu.roll(x, C - 128, 1) * np.float32(0.9999)
            return x

        o_ref[:] = jax.lax.fori_loop(0, iters, body, a)

    return pl.pallas_call(
        kern,
        out_shape=jax.ShapeDtypeStruct((R, C), jnp.float32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        interpret=True,
    )


def _jnp_chain(a, iters):
    import jax.numpy as jnp

    C = a.shape[1]
    a = jnp.asarray(a)
    x = a
    for _ in range(iters):
        x = jnp.roll(x, 1, 1) + a
        x = jnp.roll(x, 128, 1) * np.float32(0.9999)
        x = jnp.roll(x, C - 1, 1) + a
        x = jnp.roll(x, C - 128, 1) * np.float32(0.9999)
    return np.asarray(x)


def test_plain_chain_equals_the_tpu_kernel_body():
    R, C, iters = 8, 512, 3
    a = _input(R, C)
    ref = np.asarray(_tpu_kernel(R, C, iters)(a))
    got = rc.roll_chain_plain(torch.from_numpy(a), iters).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("R,C,iters", [(8, 512, 3), (56, 55 * 128, 2)])
def test_plain_chain_equals_a_jnp_roll_chain(R, C, iters):
    a = _input(R, C, seed=1)
    got = rc.roll_chain_plain(torch.from_numpy(a), iters).numpy()
    np.testing.assert_array_equal(got, _jnp_chain(a, iters))


def test_wrapper_runs_the_twin_on_cpu_and_checks_its_input():
    a = torch.from_numpy(_input(4, 256))
    rc.reset_launch_counts()
    assert torch.equal(rc.roll_chain(a, 5), rc.roll_chain_plain(a, 5))
    out = rc.roll_chain(a, 0)
    assert torch.equal(out, a) and out is not a
    assert rc.launches == {"roll_chain": 0}
    with pytest.raises(ValueError, match="C >= 128"):
        rc.roll_chain(torch.zeros(4, 100), 1)
    with pytest.raises(ValueError, match="iters"):
        rc.roll_chain(a, -1)


@pytest.mark.parametrize("shape,match", [
    ((4, 130), "a multiple of 4"), ((4, 7042), "a multiple of 4"),
    ((4, 124), "C >= 128"), ((0, 512), r"takes \(R, C\)"),
    ((2, 4, 128), r"takes \(R, C\)")])
def test_shapes_outside_the_design_raise(shape, match):
    """The kernel moves whole float4s of rows of at least 128 columns: a
    shape outside that design raises, on the CPU as on the card, before
    any launch."""
    rc.reset_launch_counts()
    with pytest.raises(ValueError, match=match):
        rc.roll_chain(torch.ones(shape), 1)
    assert rc.launches == {"roll_chain": 0}


def test_main_prints_one_json_line_with_the_jax_keys(capsys):
    result = chunk_roofline.main(["--device", "cpu", "--rows", "8", "--cols",
                                  "512", "--iters", "3", "--best-of", "1"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    printed = json.loads(lines[0])
    assert set(printed) == JAX_KEYS and printed == json.loads(json.dumps(result))
    cal = printed["calibration"]
    assert JAX_CALIBRATION_KEYS <= set(cal)
    assert cal["shape"] == [8, 512] and cal["iters"] >= 3
    assert cal["device"] == "cpu" and cal["sm_count"] is None
    assert printed["metric"] == "chunk_kernel_roofline"
    assert printed["rolls_per_padded_elem"] == chunk_roofline.ROLL_OPS == 20
    rate = cal["roll_gelems_per_s"]
    assert rate == 4 * 8 * 512 * cal["iters"] / cal["wall_s"] / 1e9
    assert printed["bound_gcells_per_s"] == pytest.approx(
        rate / 20 / printed["padding_factor"])


def test_padding_factor_is_the_ports_canonical_patch():
    """Padded cells per Yee cell of the canonical patch as the port builds
    it (no padding beyond the grid's own planes)."""
    from fdtd_solver_antennas_tpu_torch.models.params import PatchAntennaParams
    from fdtd_solver_antennas_tpu_torch.solvers.patch_fixed import build_patch_scene

    _, grid, _, _ = build_patch_scene(PatchAntennaParams.from_user_units(
        frequency_ghz=2.45, er=4.3, h_mm=1.6, loss_tangent=0.02))
    shape = np.array(grid.shape)
    assert tuple(shape) == (56, 55, 50)
    assert chunk_roofline.PAD == np.prod(shape) / np.prod(shape - 1)


def test_floor_guard_raises_iters_until_the_chain_dominates():
    """A chain that does not take FLOOR_RATIO times an empty launch gets
    more iterations; one that never does raises."""
    calls = []

    def fake(n):  # 1 ms per launch plus 10 us per iteration
        calls.append(n)
        return 1e-3 + 1e-5 * n

    n, wall, floor = chunk_roofline.guarded_wall(fake, 100, 2)
    assert floor == 1e-3 and wall >= chunk_roofline.FLOOR_RATIO * floor
    assert n == 1600 and calls[:2] == [0, 0] and calls[-1] == 1600
    with pytest.raises(RuntimeError, match="does not see"):
        chunk_roofline.guarded_wall(lambda n: 1e-3, 10, 1)


def test_entry_point_defaults_to_the_card():
    sig = inspect.signature(chunk_roofline.calibrate_rolls)
    assert sig.parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        chunk_roofline.calibrate_rolls(8, 512, 1, 1)
