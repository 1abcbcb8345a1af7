"""The port's native voxelizer core against its NumPy twin and the JAX
package's voxelizer, on the CPU.

The core (``native/voxelize.cpp``, built with g++ into ``_build/``) must
give bit-equal materials and PEC masks to the port's NumPy twin
(``native=False``) and to ``fdtd_solver_antennas_tpu``'s ``voxelize`` on
the scene of ``tests/test_native.py`` (a rotated box among them), the
microstrip patch with its MSL port, and the mixed patch+horn scene with
its horn rotated 25° about z; the fused cell→edge average must be
bit-equal in float32 and float64; a changed grid must invalidate the
cached points; a core that does not compile raises with g++'s output.
"""

import numpy as np
import pytest
import torch

from fdtd_solver_antennas_tpu.models.scene import Scene as JScene
from fdtd_solver_antennas_tpu.models.scene import rotation_matrix as jrot
from fdtd_solver_antennas_tpu.ops.mesh import MeshBuilder as JMeshBuilder
from fdtd_solver_antennas_tpu.ops.voxelize import cell_to_edge_average as jedge
from fdtd_solver_antennas_tpu.ops.voxelize import voxelize as jvoxelize

from fdtd_solver_antennas_tpu_torch.models.scene import Scene, rotation_matrix
from fdtd_solver_antennas_tpu_torch.native import build as native_build
from fdtd_solver_antennas_tpu_torch.native import get_voxelize_lib
from fdtd_solver_antennas_tpu_torch.ops import voxelize as vx
from fdtd_solver_antennas_tpu_torch.ops._build import BUILD_DIR
from fdtd_solver_antennas_tpu_torch.ops.mesh import MeshBuilder

FIELDS = ("eps_r", "sigma", "pec_ex", "pec_ey", "pec_ez")
PATCH = dict(frequency_ghz=2.45, er=4.3, h_mm=1.6, loss_tangent=0.02)
MIXED_HORN = dict(frequency_ghz=2.45, throat_a_mm=86.0, throat_b_mm=43.0,
                  aperture_A_mm=150.0, aperture_B_mm=110.0, length_mm=60.0)
THREADS = 2  # PyTorch intra-op threads while this file runs


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Test workers share the cores (pytest-xdist); PyTorch's default of
    one intra-op thread per core would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(n)


def _native_scene(scene_cls, rot, mesh_builder):
    """``tests/test_native.py``'s scene: two materials, a sheet and a box
    rotated 30° about z and translated."""
    s = scene_cls()
    s.add_material_box("sub", 4.3, 0.02, [-20, -20, 0], [20, 20, 2], priority=0)
    s.add_material_box("insert", 2.1, 0.0, [-5, -5, 0], [5, 5, 2], priority=5)
    s.add_metal_box("sheet", [-10, -8, 2], [10, 8, 2], priority=10)
    s.add_metal_box(
        "rot", [-6, -4, -10], [6, 4, -6], priority=10,
        rotation=rot(0, 0, 30), translation=(3.0, -2.0, 0.0),
    )
    mb = mesh_builder()
    for a in "xyz":
        mb.add_line(a, [-25, 25])
    mb.add_line("z", [0.0, 2.0])
    return s, mb.build(2.5)


class _Captured(Exception):
    """Stops a prepare once its scene and grid are known."""


def _scene_of(module, prepare, monkeypatch):
    """The (scene, grid) that ``prepare()`` hands ``module.build_simulation``."""
    seen = {}

    def spy(scene, grid, **kw):
        seen["scene"], seen["grid"] = scene, grid
        raise _Captured

    monkeypatch.setattr(module, "build_simulation", spy)
    prep = prepare()
    assert not prep.ok and "scene" in seen, prep.message
    return seen["scene"], seen["grid"]


def _microstrip(monkeypatch):
    import fdtd_solver_antennas_tpu.solvers.microstrip as jm
    from fdtd_solver_antennas_tpu.models.params import PatchAntennaParams as JP

    import fdtd_solver_antennas_tpu_torch.solvers.microstrip as tm
    from fdtd_solver_antennas_tpu_torch.models.params import PatchAntennaParams

    kw = dict(port_mode="msl", boundary="PML_8")
    port = _scene_of(tm, lambda: tm.prepare_microstrip_patch(
        PatchAntennaParams.from_user_units(**PATCH), device="cpu", **kw),
        monkeypatch)
    jax = _scene_of(jm, lambda: jm.prepare_microstrip_patch(
        JP.from_user_units(**PATCH), **kw), monkeypatch)
    assert port[0].msl_ports and jax[0].msl_ports
    return port, jax


def _mixed(monkeypatch):
    import fdtd_solver_antennas_tpu.solvers.multi_patch_3d as jmulti
    from fdtd_solver_antennas_tpu.models.params import HornAntennaParams as JH
    from fdtd_solver_antennas_tpu.models.params import PatchAntennaParams as JP

    import fdtd_solver_antennas_tpu_torch.solvers.multi_patch_3d as multi
    from fdtd_solver_antennas_tpu_torch.models.params import (
        HornAntennaParams,
        PatchAntennaParams,
    )

    kw = dict(mesh_quality=1, phi_step_deg=30.0, theta_step_deg=15.0)
    horn = dict(center_x_m=0.18, rot_z_deg=25.0)
    port = _scene_of(multi, lambda: multi.prepare_multi_patch_3d(
        [multi.PatchLike("p", PatchAntennaParams.from_user_units(**PATCH))],
        horns=[multi.HornLike("h", HornAntennaParams.from_user_units(
            **MIXED_HORN), **horn)], device="cpu", **kw), monkeypatch)
    jax = _scene_of(jmulti, lambda: jmulti.prepare_multi_patch_3d(
        [jmulti.PatchLike("p", JP.from_user_units(**PATCH))],
        horns=[jmulti.HornLike("h", JH.from_user_units(**MIXED_HORN),
                               **horn)], **kw), monkeypatch)
    assert any(b.rotation is not None for b in port[0].boxes)
    return port, jax


def test_core_builds_with_gxx_into_the_build_dir():
    lib = get_voxelize_lib()
    path = native_build.build()
    assert path.parent == BUILD_DIR
    assert path.name == f"libvoxelize_{native_build.tag()}.so"
    for name in ("box_contains_or", "paint_materials", "cell_edge_avg_f32",
                 "cell_edge_avg_f64"):
        assert hasattr(lib, name)


def test_a_core_that_does_not_compile_raises(monkeypatch, tmp_path):
    bad = tmp_path / "voxelize.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native_build, "SRC", bad)
    monkeypatch.setattr(native_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native_build.build()
    assert not list((tmp_path / "build").glob("*.tmp"))


@pytest.mark.parametrize("which", ["test_native", "microstrip_msl",
                                   "mixed_rotated_horn"])
def test_voxelize_native_equals_twin_and_jax(which, monkeypatch):
    if which == "test_native":
        port = _native_scene(Scene, rotation_matrix, MeshBuilder)
        jax = _native_scene(JScene, jrot, JMeshBuilder)
    elif which == "microstrip_msl":
        port, jax = _microstrip(monkeypatch)
    else:
        port, jax = _mixed(monkeypatch)
    for ax in "xyz":
        np.testing.assert_array_equal(port[1].lines[ax], jax[1].lines[ax])
    native = vx.voxelize(*port)
    twin = vx.voxelize(*port, native=False)
    ref = jvoxelize(*jax)
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(native, name),
                                      getattr(twin, name), err_msg=name)
        np.testing.assert_array_equal(getattr(native, name),
                                      getattr(ref, name), err_msg=name)
    assert native.pec_ex.any() and native.pec_ey.any()
    assert (native.eps_r > 1.0).any()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("component", ["ex", "ey", "ez"])
def test_cell_to_edge_average_is_bit_equal(component, dtype):
    cell = np.random.default_rng(5).uniform(1.0, 9.0, (7, 5, 6)).astype(dtype)
    native = vx.cell_to_edge_average(cell, component)
    twin = vx.cell_to_edge_average(cell, component, native=False)
    assert native.dtype == twin.dtype == dtype
    assert native.shape == (8, 6, 7)
    np.testing.assert_array_equal(native, twin)
    np.testing.assert_array_equal(native, jedge(cell, component))


def test_grid_change_invalidates_the_point_cache():
    """Voxelizing, shifting the grid lines in place and voxelizing again
    must rasterize against the new coordinates."""
    mb = MeshBuilder()
    for a in "xyz":
        mb.add_line(a, [-25, 25])
    mb.add_line("z", [0.0, 2.0])
    grid = mb.build(2.5)
    scene = Scene()
    scene.add_metal_box("m", [-8, -8, 0], [8, 8, 0], priority=10)
    first = vx.voxelize(scene, grid)
    assert first.pec_ex.any()
    assert "ex" in grid._vox_cache[1]
    grid.z += 100.0  # in place: the sheet's plane is no longer a grid plane
    second = vx.voxelize(scene, grid)
    assert not second.pec_ex.any(), "stale cached coordinates were reused"
    np.testing.assert_array_equal(
        second.pec_ex, vx.voxelize(scene, grid, native=False).pec_ex)
