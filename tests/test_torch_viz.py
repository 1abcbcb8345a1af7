"""The port's ``viz`` package against the JAX package's, on the CPU.

Every case of ``tests/test_patterns.py`` and ``tests/test_scene3d.py`` runs
on the port's modules; one designer scene built in both packages gives
the same meshes (vertices, faces, colours at atol 1e-9) and the same
``scene_html`` payload; each plotting function, the overlay renderer and
``MultiPatchScene.render_preview`` draw the same artists in both packages
from the same seeded inputs under Agg (lines' data, 3D polygons, face
colours, texts, axis limits and titles at rtol 1e-6).
"""

import json
import re

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from fdtd_solver_antennas_tpu.frontends import designer as jdesigner  # noqa: E402
from fdtd_solver_antennas_tpu.models import params as jparams  # noqa: E402
from fdtd_solver_antennas_tpu.viz import plotting as jplotting  # noqa: E402
from fdtd_solver_antennas_tpu.viz import plotting_overlay as joverlay  # noqa: E402
from fdtd_solver_antennas_tpu.viz import scene3d as jscene3d  # noqa: E402

from fdtd_solver_antennas_tpu_torch.frontends.designer import (  # noqa: E402
    MultiPatchScene,
    _patch_dims_mm,
)
from fdtd_solver_antennas_tpu_torch.frontends.gui_app import (  # noqa: E402
    default_horn_params_for,
)
from fdtd_solver_antennas_tpu_torch.models import params as tparams  # noqa: E402
from fdtd_solver_antennas_tpu_torch.models.scene import rotation_matrix  # noqa: E402
from fdtd_solver_antennas_tpu_torch.solvers.analytical import (  # noqa: E402
    AnalyticalPatchSolver,
)
from fdtd_solver_antennas_tpu_torch.viz import plotting, plotting_overlay  # noqa: E402
from fdtd_solver_antennas_tpu_torch.viz import scene3d  # noqa: E402
from fdtd_solver_antennas_tpu_torch.viz.patterns import (  # noqa: E402
    classify_pattern,
    interpolate_cuts_to_sphere,
    mirror_half_cut,
)
from fdtd_solver_antennas_tpu_torch.viz.scene3d import (  # noqa: E402
    box_mesh,
    marker_mesh,
    patch_scene_meshes,
    quad_mesh,
    scene_html,
    scene_meshes,
)

THREADS = 2  # PyTorch intra-op threads while this file runs
RTOL = 1e-6
CANON = dict(frequency_ghz=2.45, er=4.3, h_mm=1.6)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Test workers share the cores (pytest-xdist); PyTorch's default of
    one intra-op thread per core would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _close_figures():
    yield
    plt.close("all")


# ---------------------------------------------------------------------------
# tests/test_patterns.py on the port
# ---------------------------------------------------------------------------

def test_classify_thresholds():
    assert classify_pattern(np.array([0.0, -2.0]))[0].startswith("Too isotropic")
    assert classify_pattern(np.array([0.0, -25.0]))[0] == "Highly directional"
    assert classify_pattern(np.array([0.0, -10.0]))[0] == "Moderately directional"
    label, dr = classify_pattern(np.array([]))
    assert label == "No data" and dr == 0.0


def test_interpolation_endpoints():
    e = np.array([0.0, -3.0, -10.0])
    h = np.array([-1.0, -5.0, -20.0])
    phi, grid = interpolate_cuts_to_sphere(e, h, num_phi=73)
    assert grid.shape == (3, 73)
    i90 = np.argmin(np.abs(phi - np.pi / 2))
    i180 = np.argmin(np.abs(phi - np.pi))
    np.testing.assert_allclose(grid[:, 0], e)
    np.testing.assert_allclose(grid[:, i90], h, atol=1e-9)
    np.testing.assert_allclose(grid[:, i180], e, atol=1e-9)


def test_interpolation_bounds():
    e = np.array([0.0, -3.0])
    h = np.array([-6.0, -9.0])
    _, grid = interpolate_cuts_to_sphere(e, h)
    assert grid.max() <= max(e.max(), h.max()) + 1e-12
    assert grid.min() >= min(e.min(), h.min()) - 1e-12


def test_interpolation_validates():
    with pytest.raises(ValueError):
        interpolate_cuts_to_sphere(np.zeros(3), np.zeros(4))


def test_mirror_half_cut():
    theta = np.linspace(0, np.pi, 5)
    vals = np.array([0.0, -1.0, -2.0, -3.0, -4.0])
    th_full, v_full = mirror_half_cut(theta, vals)
    assert len(th_full) == 10
    assert th_full.max() == pytest.approx(2 * np.pi)
    np.testing.assert_allclose(v_full[:5], vals)
    np.testing.assert_allclose(v_full[5:], vals[::-1])


def test_webapp_gated_import():
    """Without streamlit installed, main() raises a clear ImportError that
    points at the port's CLI."""
    from fdtd_solver_antennas_tpu_torch.frontends import webapp

    try:
        import streamlit  # noqa: F401

        pytest.skip("streamlit installed; gate not exercised")
    except ImportError:
        pass
    with pytest.raises(ImportError, match="streamlit is not installed") as e:
        webapp.main(device="cpu")
    assert "python -m fdtd_solver_antennas_tpu_torch" in str(e.value)


def test_pattern_helpers_match_jax():
    from fdtd_solver_antennas_tpu.viz import patterns as jpatterns

    rng = np.random.default_rng(7)
    e, h = rng.normal(-10, 5, 37), rng.normal(-10, 5, 37)
    for n in (5, 73):
        for a, b in zip(interpolate_cuts_to_sphere(e, h, n),
                        jpatterns.interpolate_cuts_to_sphere(e, h, n)):
            np.testing.assert_array_equal(a, b)
    theta = np.linspace(0, np.pi, 37)
    for a, b in zip(mirror_half_cut(theta, e),
                    jpatterns.mirror_half_cut(theta, e)):
        np.testing.assert_array_equal(a, b)
    assert classify_pattern(e) == jpatterns.classify_pattern(e)


# ---------------------------------------------------------------------------
# tests/test_scene3d.py on the port
# ---------------------------------------------------------------------------

def _params():
    return tparams.PatchAntennaParams.from_user_units(**CANON)


def _mesh_volume(m):
    """Signed volume via the divergence theorem (needs outward faces)."""
    v = m.verts
    a, b, c = v[m.faces[:, 0]], v[m.faces[:, 1]], v[m.faces[:, 2]]
    return float(np.sum(np.einsum("ij,ij->i", a, np.cross(b, c))) / 6.0)


def test_box_mesh_geometry():
    m = box_mesh((0, 0, 0), (2, 3, 4))
    assert m.verts.shape == (8, 3)
    assert m.faces.shape == (12, 3)
    assert _mesh_volume(m) == pytest.approx(24.0)


def test_box_mesh_puffs_thin_sheets():
    m = box_mesh((0, 0, 1.6), (10, 10, 1.6))
    dz = m.verts[:, 2].max() - m.verts[:, 2].min()
    assert dz > 0


def test_quad_and_marker():
    q = quad_mesh(np.array([(0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0)]))
    assert q.faces.shape == (2, 3)
    mk = marker_mesh((5, 6, 7), size=2.0)
    assert mk.faces.shape == (8, 3)
    np.testing.assert_allclose(mk.verts.mean(axis=0), [5, 6, 7])
    assert _mesh_volume(mk) > 0


def test_patch_scene_meshes_layout():
    ms = patch_scene_meshes(29.1, 37.6, 1.6)
    assert [m.name for m in ms] == ["substrate", "ground", "patch", "port"]
    patch = ms[2]
    assert patch.verts[:, 0].max() - patch.verts[:, 0].min() == pytest.approx(37.6)
    assert patch.verts[:, 1].max() - patch.verts[:, 1].min() == pytest.approx(29.1)


def test_scene_meshes_true_oriented_geometry():
    scene = MultiPatchScene(device="cpu")
    inst = scene.add_patch(_params(), rot_z_deg=45.0)
    ms = scene_meshes(scene)
    patch = next(m for m in ms if m.name.endswith("patch"))
    W, L, _h = _patch_dims_mm(inst.params)
    span_x = patch.verts[:, 0].max() - patch.verts[:, 0].min()
    assert span_x == pytest.approx((W + L) / np.sqrt(2), rel=1e-6)
    expect = np.array([W / 2, L / 2, 0]) @ rotation_matrix(0, 0, 45.0).T
    d = np.linalg.norm(patch.verts[:, :2] - expect[:2], axis=1)
    assert d.min() < 0.3


def test_scene_meshes_horn_and_port_markers():
    scene = MultiPatchScene(device="cpu")
    scene.add_patch(_params())
    scene.add_horn(
        default_horn_params_for(2.45e9), center_x_m=0.2, rot_y_deg=90.0
    )
    ms = scene_meshes(scene)
    kinds = {m.name.split(": ")[-1] for m in ms}
    assert {"substrate", "ground", "patch", "port", "waveguide",
            "flare"} <= kinds
    ports = [m for m in ms if m.name.endswith("port")]
    assert len(ports) == 2
    assert ports[1].verts[:, 0].mean() > 100.0


def _payload(html):
    return json.loads(
        re.search(r"const MESHES = (\[.*?\]);\n", html, re.S).group(1))


def test_scene_html_payload():
    ms = patch_scene_meshes(29.1, 37.6, 1.6)
    html = scene_html(ms)
    assert "http://" not in html and "https://" not in html
    assert "<script src" not in html
    payload = _payload(html)
    assert len(payload) == len(ms)
    assert payload[0]["name"] == "substrate"
    assert len(payload[2]["faces"]) == 12
    for evt in ("mousedown", "mousemove", "wheel"):
        assert evt in html


def test_scene_plotly_figure_needs_plotly():
    """plotly is imported inside the function only, as in the JAX package."""
    try:
        import plotly  # noqa: F401

        pytest.skip("plotly installed; gate not exercised")
    except ImportError:
        pass
    with pytest.raises(ImportError):
        scene3d.scene_plotly_figure(patch_scene_meshes(29.1, 37.6, 1.6))


# ---------------------------------------------------------------------------
# one designer scene in both packages
# ---------------------------------------------------------------------------

def _both_scenes():
    """The same mixed scene (a rotated patch, a second patch fed from +Y, a
    rotated horn) built through each package's designer."""
    scenes = []
    for des, par in ((jdesigner, jparams), (None, tparams)):
        if des is None:
            sc = MultiPatchScene(device="cpu")
            from fdtd_solver_antennas_tpu_torch.solvers.microstrip import (
                FeedDirection)
        else:
            sc = des.MultiPatchScene()
            from fdtd_solver_antennas_tpu.solvers.microstrip import (
                FeedDirection)
        p = par.PatchAntennaParams.from_user_units(**CANON)
        sc.add_patch(p, rot_z_deg=30.0, center_y_m=-0.01)
        sc.add_patch(p, center_x_m=0.12, rot_x_deg=15.0,
                     feed_direction=FeedDirection.POS_Y)
        hp = par.HornAntennaParams.from_user_units(
            frequency_ghz=10.0, throat_a_mm=22.9, throat_b_mm=10.2,
            aperture_A_mm=80.0, aperture_B_mm=60.0, length_mm=100.0)
        sc.add_horn(hp, center_x_m=0.18, rot_z_deg=25.0, rot_y_deg=10.0)
        scenes.append(sc)
    return scenes


def test_scene_meshes_match_jax():
    jsc, tsc = _both_scenes()
    jm, tm = jscene3d.scene_meshes(jsc), scene_meshes(tsc)
    assert len(jm) == len(tm) > 0
    for a, b in zip(jm, tm):
        assert a.name == b.name and a.color == b.color
        assert a.opacity == b.opacity
        np.testing.assert_array_equal(a.faces, b.faces)
        np.testing.assert_allclose(b.verts, a.verts, rtol=0, atol=1e-9)
    assert _payload(scene_html(tm)) == _payload(jscene3d.scene_html(jm))
    assert jscene3d.patch_scene_meshes(29.1, 37.6, 1.6)[2].verts.tolist() \
        == patch_scene_meshes(29.1, 37.6, 1.6)[2].verts.tolist()


def test_save_scene_html(tmp_path):
    _jsc, tsc = _both_scenes()
    path = scene3d.save_scene_html(scene_meshes(tsc), str(tmp_path / "s.html"))
    html = open(path, encoding="utf-8").read()
    assert html == scene_html(scene_meshes(tsc))


# ---------------------------------------------------------------------------
# the plots in both packages
# ---------------------------------------------------------------------------

def _artists(fig):
    """Comparable data of every axes of ``fig``: title, labels, limits,
    lines' data, collections' 3-D polygons and face colours, patches'
    extents, texts."""
    out = []
    for ax in fig.axes:
        d = {"title": ax.get_title(), "xlabel": ax.get_xlabel(),
             "ylabel": ax.get_ylabel(), "xlim": ax.get_xlim(),
             "ylim": ax.get_ylim()}
        if hasattr(ax, "get_zlim"):
            d["zlim"] = ax.get_zlim()
            d["zlabel"] = ax.get_zlabel()
        d["lines"] = [np.asarray(ln.get_xydata()) for ln in ax.get_lines()]
        d["polys"] = [np.asarray(c._vec) if hasattr(c, "_vec") else None
                      for c in ax.collections]
        d["faces"] = [np.asarray(c.get_facecolor()) for c in ax.collections]
        d["patches"] = [np.asarray(p.get_extents().bounds)
                        for p in ax.patches if hasattr(p, "get_width")]
        d["texts"] = [(t.get_text(), tuple(np.ravel(t.get_position())))
                      for t in ax.texts]
        out.append(d)
    return out


def _assert_same_figure(fj, ft):
    aj, at = _artists(fj), _artists(ft)
    assert len(aj) == len(at) > 0
    for dj, dt in zip(aj, at):
        assert set(dj) == set(dt)
        for key in dj:
            a, b = dj[key], dt[key]
            if key in ("lines", "polys", "faces", "patches"):
                assert len(a) == len(b), key
                for x, y in zip(a, b):
                    if x is None:
                        assert y is None
                    else:
                        np.testing.assert_allclose(y, x, rtol=RTOL,
                                                   atol=1e-12, err_msg=key)
            elif key == "texts":
                assert [t for t, _ in a] == [t for t, _ in b]
                for (_, p), (_, q) in zip(a, b):
                    np.testing.assert_allclose(q, p, rtol=RTOL, atol=1e-12)
            elif isinstance(a, str):
                assert a == b, key
            else:
                np.testing.assert_allclose(b, a, rtol=RTOL, err_msg=key)


def _solver():
    return AnalyticalPatchSolver(_params())


def _grid(seed=3, n_th=19, n_ph=37):
    rng = np.random.default_rng(seed)
    theta = np.linspace(0, np.pi, n_th)
    phi = np.linspace(0, 2 * np.pi, n_ph)
    db = rng.normal(0.0, 6.0, (n_th, n_ph))
    return theta, phi, db


PLOTS = {
    "cross_sections": lambda m: m.plot_cross_sections(_solver()),
    "pattern_3d": lambda m: m.plot_3d_pattern(_solver()),
    "pattern_3d_no_iso": lambda m: m.plot_3d_pattern(
        _solver(), show_isotropic=False),
    "grid_db": lambda m: m.plot_3d_pattern_from_grid(
        *_grid()[:2], 10 ** (_grid()[2] / 10), colors_db=_grid()[2],
        L_m=0.0291, W_m=0.0376, h_m=0.0016),
    "grid_linear_clip": lambda m: m.plot_3d_pattern_from_grid(
        *_grid(5)[:2], 10 ** (_grid(5)[2] / 10), clip_db=-12.0,
        dB_min=-30.0, dB_max=0.0),
    "grid_1d": lambda m: m.plot_3d_pattern_from_grid(
        _grid()[0], _grid()[1], np.cos(_grid()[0]) ** 2 + 1e-3),
    "patch_3d": lambda m: m.draw_patch_3d_geometry(0.0291, 0.0376, 0.0016),
    "patch_3d_unlabelled": lambda m: m.draw_patch_3d_geometry(
        0.0291, 0.0376, 0.0016, show_labels=False),
    "top_view": lambda m: m.draw_patch_top_view(
        plt.figure().add_subplot(111), 0.0291, 0.0376, 0.0016).figure,
}


@pytest.mark.parametrize("name", sorted(PLOTS))
def test_plotting_matches_jax(name):
    _assert_same_figure(PLOTS[name](jplotting), PLOTS[name](plotting))


@pytest.mark.parametrize("feed", ["-X", "+X", "-Y", "+Y"])
def test_microstrip_geometry_matches_jax(feed):
    args = (0.0291, 0.0376, 0.0016, feed, 2.45e9, 4.3)
    _assert_same_figure(jplotting.draw_microstrip_patch_3d_geometry(*args),
                        plotting.draw_microstrip_patch_3d_geometry(*args))


def test_overlay_matches_jax():
    figs = []
    for mod in (joverlay, plotting_overlay):
        fig = mod.draw_patch_3d_geometry(0.0291, 0.0376, 0.0016)
        mod.add_overlay_copper(fig, (-20, -1.5, 0), (-18.8, 1.5, 0))
        assert fig._overlay_ax in fig.axes
        figs.append(fig)
    _assert_same_figure(*figs)
    with pytest.raises(ValueError, match="_overlay_ax"):
        plotting_overlay.add_overlay_copper(plt.figure(), (0, 0, 0), (1, 1, 0))


def test_render_preview_matches_jax():
    jsc, tsc = _both_scenes()
    _assert_same_figure(jsc.render_preview(), tsc.render_preview())
    fj, ft = plt.Figure(), plt.Figure()
    assert jsc.render_preview(fig=fj) is fj
    assert tsc.render_preview(fig=ft) is ft
    _assert_same_figure(fj, ft)


def test_plotting_selects_agg_without_forcing():
    """``viz.plotting`` asks for Agg with force=False when imported, as the
    JAX module does; it does not switch the backend on each draw."""
    src = open(plotting.__file__, encoding="utf-8").read()
    assert src.count("matplotlib.use(") == 1
    assert 'matplotlib.use("Agg", force=False)' in src
