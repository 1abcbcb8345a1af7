"""The port's host layer against the JAX package, on the canonical patch.

Mesh lines, voxelized materials and PEC masks, ca/cb coefficients, the
waveform, the CPML profiles, the probe gather tables and the Huygens-face
geometry are NumPy in both packages and must be *exactly* equal; the
parameter models must round-trip. The port runs on the CPU here.
"""

import numpy as np
import pytest

import fdtd_solver_antennas_tpu.ops.fdtd as jfdtd
import fdtd_solver_antennas_tpu.physics as jphys
from fdtd_solver_antennas_tpu.models.params import PatchAntennaParams as JParams
from fdtd_solver_antennas_tpu.ops.voxelize import voxelize as jvoxelize
from fdtd_solver_antennas_tpu.solvers.patch_fixed import (
    prepare_patch_fixed as jprepare,
)

import fdtd_solver_antennas_tpu_torch.ops.fdtd as tfdtd
import fdtd_solver_antennas_tpu_torch.physics as tphys
from fdtd_solver_antennas_tpu_torch.models.params import (
    MetalProperties,
    PatchAntennaParams,
)
from fdtd_solver_antennas_tpu_torch.ops.voxelize import voxelize as tvoxelize
from fdtd_solver_antennas_tpu_torch.solvers.patch_fixed import (
    build_patch_scene,
    prepare_patch_fixed,
)

CANON = dict(frequency_ghz=2.45, er=4.3, h_mm=1.6, loss_tangent=0.02)


@pytest.fixture(scope="module", params=["MUR", "PML_8"])
def sims(request):
    """(JAX sim on its XLA path, port sim on the CPU), canonical patch."""
    jp = jprepare(JParams.from_user_units(**CANON), boundary=request.param)
    tp = prepare_patch_fixed(PatchAntennaParams.from_user_units(**CANON),
                             boundary=request.param, device="cpu")
    assert jp.ok, jp.message
    assert tp.ok, tp.message
    assert not jp.sim.use_pallas
    return jp.sim, tp.sim


def test_mesh_lines_equal(sims):
    js, ts = sims
    assert ts.grid.shape == js.grid.shape == (56, 55, 50)
    for a in "xyz":
        np.testing.assert_array_equal(ts.grid.lines[a], js.grid.lines[a])
    assert ts.dt == js.dt


def _as_jax_scene(scene, grid):
    """The same boxes and lines as JAX-package objects."""
    from fdtd_solver_antennas_tpu.models.scene import Scene as JScene
    from fdtd_solver_antennas_tpu.ops.mesh import YeeGrid as JGrid
    from fdtd_solver_antennas_tpu_torch.models.scene import PEC, Material

    js = JScene()
    for b in scene.boxes:
        if isinstance(b.prop, Material):
            js.add_material_box(b.prop.name, b.prop.epsilon, b.prop.kappa,
                                b.start, b.stop, b.priority)
        else:
            assert isinstance(b.prop, PEC)
            js.add_metal_box(b.prop.name, b.start, b.stop, b.priority)
    return js, JGrid(x=grid.x, y=grid.y, z=grid.z, unit=grid.unit)


def test_voxelized_materials_equal():
    scene, grid, _, _ = build_patch_scene(
        PatchAntennaParams.from_user_units(**CANON))
    jv = jvoxelize(*_as_jax_scene(scene, grid))
    tv = tvoxelize(scene, grid)
    for name in ("eps_r", "sigma", "pec_ex", "pec_ey", "pec_ez"):
        np.testing.assert_array_equal(getattr(tv, name), getattr(jv, name))
    assert (tv.eps_r == 4.3).any()
    assert tv.pec_ex.any() and tv.pec_ey.any()


def test_coefficients_equal(sims):
    js, ts = sims
    assert set(ts._coeffs_np) == set(js._coeffs_np)
    for k, v in js._coeffs_np.items():
        np.testing.assert_array_equal(ts._coeffs_np[k], v, err_msg=k)
        np.testing.assert_array_equal(ts.coeffs[k].numpy(), v, err_msg=k)


def test_lossy_metal_coefficients_equal():
    """Finite-conductivity sheets (``lossy_metal=True``) fold into the same
    edge conductivities in both packages."""
    jp = jprepare(JParams.from_user_units(**CANON), lossy_metal=True)
    tp = prepare_patch_fixed(PatchAntennaParams.from_user_units(**CANON),
                             lossy_metal=True, device="cpu")
    assert jp.ok and tp.ok, (jp.message, tp.message)
    for k, v in jp.sim._coeffs_np.items():
        np.testing.assert_array_equal(tp.sim._coeffs_np[k], v, err_msg=k)
    plain = prepare_patch_fixed(PatchAntennaParams.from_user_units(**CANON),
                                device="cpu").sim
    assert not np.array_equal(plain._coeffs_np["ca_ex"],
                              tp.sim._coeffs_np["ca_ex"])


def test_spacings_and_boundary_coefficients_equal(sims):
    js, ts = sims
    inv_p, inv_d, mur_coef, pml = js._aux
    ops = ts.operands
    for a in range(3):
        np.testing.assert_array_equal(ops.inv_p[a].numpy(), inv_p[a])
        np.testing.assert_array_equal(ops.inv_d[a].numpy(), inv_d[a])
    assert ops.dtmu == float(np.float32(js.dt / jphys.MU0))
    if ts.cfg.boundary == "MUR":
        for a in range(3):
            for side in range(2):
                assert ops.mur[a][side] == float(np.float32(mur_coef[(a, side)]))
        assert ops.pml is None
    else:
        assert ops.mur is None
        for a in range(3):
            for key, kind, w in (("bh", "half", 0), ("ch", "half", 1),
                                 ("be", "node", 0), ("ce", "node", 1)):
                np.testing.assert_array_equal(
                    ops.pml[key][a].numpy(), pml[a][kind][w])


def test_source_and_decimation_equal(sims):
    js, ts = sims
    np.testing.assert_array_equal(ts.waveform, js.waveform)
    assert ts.n_source_steps == js.n_source_steps
    assert ts.probe_decim == js.probe_decim
    np.testing.assert_array_equal(ts.port_freqs_hz, js.port_freqs_hz)
    np.testing.assert_array_equal(ts.nf_freqs_hz, js.nf_freqs_hz)
    (jp,), (tp,) = js.ports, ts.ports
    assert tp.sl == jp.sl and tp.i_gather == jp.i_gather
    assert tp.i_lengths == jp.i_lengths
    np.testing.assert_array_equal(tp.src_col, jp.src_col)
    np.testing.assert_array_equal(tp.dl_m, jp.dl_m)
    from fdtd_solver_antennas_tpu.ops.fdtd_pallas import build_src_mats

    jm = build_src_mats(js, *js.padded_shape, int_keys=True)
    tm = tfdtd.build_src_mats(ts, *ts.padded_shape)
    assert set(jm) == set(tm) == {2}
    np.testing.assert_array_equal(tm[2], jm[2])
    np.testing.assert_array_equal(ts.operands.src[2].numpy(), jm[2])


def test_probe_gather_tables_equal(sims):
    js, ts = sims
    jg = jfdtd.build_probe_gathers(js, *js.padded_shape)
    tg = tfdtd.build_probe_gathers(ts)
    assert len(jg) == len(tg) == 10
    for i, (a, b) in enumerate(zip(tg, jg)):
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f"item {i}")
        else:
            assert a == b, i


def test_face_geometry_equal(sims):
    js, ts = sims
    assert len(ts.faces) == len(js.faces) == 6
    for tf, jf in zip(ts.faces, js.faces):
        for f in ("name", "axis", "m", "u_axis", "v_axis", "u0", "u1", "v0", "v1"):
            assert getattr(tf, f) == getattr(jf, f), f
        for f in ("normal", "centers_m", "areas_m2"):
            np.testing.assert_array_equal(getattr(tf, f), getattr(jf, f))


def test_probe_table_rows_address_the_six_field_stack(sims):
    """The kernels' single table is the four JAX gathers stacked: port V,
    port I (+3N into the H stack), face E, face H (+3N)."""
    _, ts = sims
    n = int(np.prod(ts.padded_shape))
    idx = ts.operands.probe_idx.numpy()
    w = ts.operands.probe_w.numpy()
    T = ts.n_face_slots
    assert idx.shape == (2 + 2 * T, 4)
    assert idx.min() >= 0 and idx.max() < 6 * n
    assert (idx[0][w[0] != 0] < 3 * n).all()  # V reads E
    assert (idx[1] >= 3 * n).all()  # I reads H
    assert (idx[2:2 + T][w[2:2 + T] != 0] < 3 * n).all()
    assert (idx[2 + T:] >= 3 * n).all()


def test_params_round_trip_from_jax_model_dump():
    for kw in (CANON, dict(frequency_ghz=2.0, er=3.38, h_mm=1.524,
                           loss_tangent=1e-3, W_mm=32.0, L_mm=40.0,
                           metal="gold", metal_thickness_um=3.0)):
        jp = JParams.from_user_units(**kw)
        tp = PatchAntennaParams.from_dict(jp.model_dump())
        assert tp == PatchAntennaParams.from_user_units(**kw)
        assert tp.to_dict() == jp.model_dump()
        assert tp.L_mm == jp.L_mm and tp.W_mm == jp.W_mm


@pytest.mark.parametrize("bad", [
    dict(frequency_hz=0.0, eps_r=4.3, h_m=1e-3),
    dict(frequency_hz=2e9, eps_r=1.0, h_m=1e-3),
    dict(frequency_hz=2e9, eps_r=4.3, h_m=-1e-3),
    dict(frequency_hz=2e9, eps_r=4.3, h_m=1e-3, loss_tangent=-0.1),
    dict(frequency_hz=2e9, eps_r=4.3, h_m=1e-3, patch_width_m=0.0),
])
def test_params_range_checks_raise(bad):
    with pytest.raises(ValueError):
        PatchAntennaParams(**bad)
    with pytest.raises(ValueError):  # pydantic's ValidationError too
        JParams(**bad)


def test_metal_range_checks_raise():
    with pytest.raises(ValueError):
        MetalProperties("x", conductivity_s_per_m=0.0)
    with pytest.raises(ValueError):
        MetalProperties("x", conductivity_s_per_m=1e7, thickness_m=0.0)


def test_design_equations_equal():
    for f, er, h in ((2.45e9, 4.3, 1.6e-3), (5.8e9, 2.2, 0.787e-3)):
        assert tphys.design_patch_for_frequency(f, er, h) == \
            jphys.design_patch_for_frequency(f, er, h)
        assert tphys.substrate_conductivity(f, er, 0.02) == \
            jphys.substrate_conductivity(f, er, 0.02)
    th = np.linspace(0, np.pi, 19)[:, None]
    ph = np.linspace(0, 2 * np.pi, 13)[None, :]
    np.testing.assert_allclose(
        tphys.rect_patch_power_pattern(0.03, 0.037, 51.3, th, ph),
        np.asarray(jphys.rect_patch_power_pattern(0.03, 0.037, 51.3, th, ph)),
        rtol=1e-5, atol=1e-7)
