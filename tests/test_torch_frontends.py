"""The port's frontends (the GUI's and the web app's headless parts, the
designer's preview) and the run loop's callbacks, against the JAX package
on the CPU.

Every case of ``tests/test_gui_helpers.py`` and ``tests/test_abort_progress.py``
and ``tests/test_designer.py``'s preview test runs on the port;
``dispatch_prepare`` prepares each of the five solver kinds as the JAX
package does (grid shape, boundary, step budget, NF2FF angles); a capped
canonical run through ``BackgroundRun`` on a worker thread, with the
callbacks wired, matches the JAX package's ``run_prepared_fixed`` (raw
port and NF2FF DFTs at rtol 2e-4, atol 1e-5·max|ref|) and the same run on
the main thread bit for bit; and a raising ``progress_cb`` ends neither
``run_simulation`` nor the sharded run, as in the JAX package.
"""

import threading
import time
import types

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from fdtd_solver_antennas_tpu.frontends import gui_app as jgui  # noqa: E402
from fdtd_solver_antennas_tpu.models.params import (  # noqa: E402
    PatchAntennaParams as JParams,
)
from fdtd_solver_antennas_tpu.solvers.patch_fixed import (  # noqa: E402
    prepare_patch_fixed as jprepare_fixed,
    run_prepared_fixed as jrun_fixed,
)

from fdtd_solver_antennas_tpu_torch.frontends.designer import (  # noqa: E402
    MultiPatchScene,
)
from fdtd_solver_antennas_tpu_torch.frontends.gui_app import (  # noqa: E402
    SOLVER_CHOICES,
    LogCoalescer,
    apply_instance_fields,
    apply_norm_mode,
    apply_sim_controls,
    default_horn_params_for,
    dispatch_prepare,
    format_port_diagnostics,
    format_progress,
    is_full_sphere,
    open_scene_3d_view,
    pattern_grid_for_plot,
    polar_cut,
    principal_cut_indices,
    runner_kwargs,
)
from fdtd_solver_antennas_tpu_torch.frontends.webapp import (  # noqa: E402
    LEGACY_MODES,
    BackgroundRun,
    normalize_and_bounds,
    plane_cuts_dbi,
    prepare_legacy_mode,
    touchstone_bytes,
)
from fdtd_solver_antennas_tpu_torch.models.params import (  # noqa: E402
    HornAntennaParams,
    PatchAntennaParams,
)
from fdtd_solver_antennas_tpu_torch.models.scene import Scene  # noqa: E402
from fdtd_solver_antennas_tpu_torch.ops.fdtd import (  # noqa: E402
    FDTDConfig,
    build_simulation,
)
from fdtd_solver_antennas_tpu_torch.ops.mesh import MeshBuilder  # noqa: E402
from fdtd_solver_antennas_tpu_torch.physics import C0  # noqa: E402
from fdtd_solver_antennas_tpu_torch.solvers.microstrip import (  # noqa: E402
    FeedDirection,
)
from fdtd_solver_antennas_tpu_torch.solvers.patch_2d import Prepared2D  # noqa: E402
from fdtd_solver_antennas_tpu_torch.solvers.patch_fixed import (  # noqa: E402
    run_prepared_fixed,
)

THREADS = 2  # PyTorch intra-op threads while this file runs
CANON = dict(frequency_ghz=2.45, er=4.3, h_mm=1.6, loss_tangent=0.02)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Test workers share the cores (pytest-xdist); PyTorch's default of
    one intra-op thread per core would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(n)


def _params():
    return PatchAntennaParams.from_user_units(**CANON)


def _wait(run, seconds):
    deadline = time.time() + seconds
    while run.running and time.time() < deadline:
        time.sleep(0.01)
    assert not run.running, "background run did not finish in time"


# ---------------------------------------------------------------------------
# tests/test_gui_helpers.py on the port
# ---------------------------------------------------------------------------

def test_is_full_sphere():
    assert not is_full_sphere(np.deg2rad([0.0, 90.0]))
    assert is_full_sphere(np.deg2rad(np.arange(0.0, 361.0, 15.0)))


def test_principal_cut_indices_two_cut():
    assert principal_cut_indices(np.deg2rad([0.0, 90.0])) == (0, 1)


def test_principal_cut_indices_full_sphere():
    phi = np.deg2rad(np.arange(0.0, 361.0, 15.0))
    e_idx, h_idx = principal_cut_indices(phi)
    assert phi[e_idx] == 0.0
    assert np.isclose(phi[h_idx], np.pi / 2)


def _fake_res(theta, phi, intensity):
    return types.SimpleNamespace(
        theta=theta, phi=phi, intensity=np.asarray(intensity))


def test_pattern_grid_full_sphere_passthrough():
    theta = np.deg2rad(np.arange(0.0, 181.0, 15.0))
    phi = np.deg2rad(np.arange(0.0, 361.0, 30.0))
    grid = np.random.default_rng(0).normal(size=(len(theta), len(phi)))
    _th, _ph, out = pattern_grid_for_plot(_fake_res(theta, phi, grid))
    np.testing.assert_array_equal(out, grid)


def test_pattern_grid_two_cut_interpolates():
    theta = np.deg2rad(np.arange(0.0, 181.0, 10.0))
    phi = np.deg2rad([0.0, 90.0])
    cuts = np.stack(
        [np.cos(theta) ** 2 * 10 - 20, np.cos(theta) ** 2 * 8 - 20], axis=1)
    _th, ph, out = pattern_grid_for_plot(_fake_res(theta, phi, cuts))
    assert out.shape == (len(theta), len(ph))
    assert is_full_sphere(ph)
    assert np.isfinite(out).all()
    for a, b in zip(pattern_grid_for_plot(_fake_res(theta, phi, cuts)),
                    jgui.pattern_grid_for_plot(_fake_res(theta, phi, cuts))):
        np.testing.assert_array_equal(a, b)


def test_default_horn_params_above_cutoff():
    p = default_horn_params_for(2.45e9)
    assert C0 / (2.0 * p.throat_a_m) < 2.45e9
    assert p.aperture_A_m > p.throat_a_m
    assert p.aperture_B_m > p.throat_b_m
    j = jgui.default_horn_params_for(2.45e9)
    for k in ("throat_a_m", "throat_b_m", "aperture_A_m", "aperture_B_m",
              "length_m", "frequency_hz"):
        assert getattr(p, k) == pytest.approx(getattr(j, k), rel=1e-12)


def test_log_coalescer_replaces_step_lines():
    log = LogCoalescer(max_lines=10)
    log.append("prepare: …")
    log.append("step 100")
    log.append("step 200")
    assert log.lines == ["prepare: …", "step 200"]
    for i in range(20):
        log.append(f"msg {i}")
    assert len(log.lines) == 10


def test_scene_preview_into_existing_figure():
    scene = MultiPatchScene(device="cpu")
    scene.add_patch(_params())
    scene.add_horn(default_horn_params_for(2.45e9), center_x_m=0.2)
    fig = plt.Figure()
    assert scene.render_preview(fig=fig) is fig
    assert len(fig.axes) == 1


def test_preview_renders():
    """``tests/test_designer.py::test_preview_renders`` on the port."""
    scene = MultiPatchScene(device="cpu")
    scene.add_patch(_params())
    scene.add_patch(_params(), center_x_m=0.12, rot_z_deg=90.0)
    scene.add_horn(HornAntennaParams.from_user_units(
        frequency_ghz=10.0, throat_a_mm=22.9, throat_b_mm=10.2,
        aperture_A_mm=80.0, aperture_B_mm=60.0, length_mm=100.0),
        center_y_m=0.15)
    fig = scene.render_preview()
    assert fig is not None
    plt.close(fig)


def test_apply_norm_mode():
    g = np.array([[1.0, 5.0], [-3.0, 2.0]])
    np.testing.assert_array_equal(apply_norm_mode(g, "dBi"), g)
    out = apply_norm_mode(g, "Normalized")
    assert out.max() == 0.0
    np.testing.assert_allclose(out, g - 5.0)


def test_dispatch_prepare_theta_step_changes_grid():
    p = _params()
    prep2, _ = dispatch_prepare(p, "microstrip", theta_step_deg=2.0,
                                n_steps_max=64, device="cpu")
    prep5, _ = dispatch_prepare(p, "microstrip", theta_step_deg=5.0,
                                n_steps_max=64, device="cpu")
    assert len(prep2.theta) > len(prep5.theta)


def test_dispatch_prepare_boundary_changes_config():
    p = _params()
    prep_mur, _ = dispatch_prepare(p, "fixed", boundary="MUR", n_steps_max=64,
                                   device="cpu")
    prep_pml, _ = dispatch_prepare(p, "fixed", boundary="PML_8",
                                   n_steps_max=64, device="cpu")
    assert prep_mur.sim.cfg.boundary == "MUR"
    assert prep_pml.sim.cfg.boundary == "PML_8"


def test_apply_sim_controls_round_trip():
    scene = MultiPatchScene(device="cpu")
    err = apply_sim_controls(scene, dict(
        theta_step_deg="4", phi_step_deg="10", mesh_quality="5",
        end_criteria_db="-40", nf_center_mode="centroid", boundary="PML_8",
        simbox_mode="manual", manual_size_mm=("300", "300", "200"),
    ))
    assert err is None
    c = scene.controls
    assert c.theta_step_deg == 4.0 and c.phi_step_deg == 10.0
    assert c.mesh_quality == 5 and c.end_criteria_db == -40.0
    assert c.nf_center_mode == "centroid" and c.boundary == "PML_8"
    assert c.simbox_mode == "manual" and c.manual_size_mm == (300.0, 300.0, 200.0)
    assert apply_sim_controls(scene, dict(end_criteria_db="-200")) is None
    assert scene.controls.end_criteria_db == -80.0
    assert apply_sim_controls(scene, dict(boundary="BAD")) is not None
    assert apply_sim_controls(scene, dict(manual_size_mm=("1", "-2", "3")))


def test_apply_instance_fields():
    scene = MultiPatchScene(device="cpu")
    patch = scene.add_patch(_params())
    horn = scene.add_horn(default_horn_params_for(2.45e9))
    err = apply_instance_fields(scene, patch, dict(
        x_mm="25", y_mm="-10", z_mm="5",
        rot_x_deg="15", rot_y_deg="30", rot_z_deg="45",
        feed_direction="+Y",
    ))
    assert err is None
    assert patch.center_x_m == 0.025 and patch.center_y_m == -0.010
    assert patch.rot_x_deg == 15.0 and patch.rot_y_deg == 30.0
    assert patch.feed_direction == FeedDirection.POS_Y
    assert apply_instance_fields(scene, horn, dict(feed_direction="+X"))
    assert apply_instance_fields(scene, horn, dict(rot_y_deg="90")) is None
    assert horn.rot_y_deg == 90.0


def test_format_port_diagnostics():
    freq = np.linspace(2.0e9, 3.0e9, 11)
    res = types.SimpleNamespace(
        f_res_hz=2.5e9, freq=freq, z_in=np.full(11, 48.0 + 3.0j),
        radiation_efficiency=0.62, steps_run=1000, wall_time_s=2.0,
        mcells_per_s=500.0,
        diagnostics={"s11_db_at_res": -17.3, "rad_eff_converged": False,
                     "energy_ratio": 3.2e-5},
    )
    lines = format_port_diagnostics(res)
    text = "\n".join(lines)
    assert "2.5000 GHz" in text
    assert "-17.30 dB" in text
    assert "48.0 +3.0j" in text
    assert "NOT CONVERGED" in text
    assert "3.20e-05" in text
    assert lines == jgui.format_port_diagnostics(res)


def test_open_scene_3d_view(tmp_path):
    scene = MultiPatchScene(device="cpu")
    scene.add_patch(_params(), rot_z_deg=30.0)
    scene.add_horn(default_horn_params_for(2.45e9), center_x_m=0.1)
    path = open_scene_3d_view(scene, str(tmp_path / "scene.html"))
    html = open(path, encoding="utf-8").read()
    assert "getContext" in html and '"verts"' in html
    assert "flare" in html and "substrate" in html


def test_webapp_normalize_and_bounds():
    cur, rmin, rmax = normalize_and_bounds(np.array([-3.0, 7.0, -12.0]))
    assert cur.max() == 0.0 and rmax == 0.0
    assert rmin == -20.0
    _cur, rmin, _ = normalize_and_bounds(np.array([0.0, -90.0]))
    assert rmin == -40.0


def test_webapp_plane_cuts():
    theta = np.deg2rad(np.arange(0, 181, 10))
    phi = np.deg2rad(np.arange(0, 360, 15))
    grid = np.arange(len(theta) * len(phi), dtype=float).reshape(
        len(theta), len(phi))
    zx, zy = plane_cuts_dbi(types.SimpleNamespace(
        intensity=grid, phi=phi, theta=theta))
    np.testing.assert_array_equal(zx, grid[:, 0])
    np.testing.assert_array_equal(zy, grid[:, 6])


def test_webapp_legacy_mode_dispatch():
    p = _params()
    prep_2d = prepare_legacy_mode(p, LEGACY_MODES[0], n_steps_max=64,
                                  device="cpu")
    prep_3d = prepare_legacy_mode(p, LEGACY_MODES[1], n_steps_max=64,
                                  device="cpu")
    assert prep_2d.ok and prep_3d.ok
    assert isinstance(prep_2d, Prepared2D)
    assert not isinstance(prep_3d, Prepared2D)
    y2, y3 = prep_2d.sim.grid.y, prep_3d.sim.grid.y
    assert (y2.max() - y2.min()) < 0.7 * (y3.max() - y3.min())


def test_webapp_touchstone_bytes():
    from fdtd_solver_antennas_tpu.frontends.webapp import (
        touchstone_bytes as jtouchstone_bytes)

    f = np.linspace(2e9, 3e9, 5)
    s = np.exp(1j * np.linspace(0, 1, 5)) * 0.3
    ours, theirs = touchstone_bytes(f, s), jtouchstone_bytes(f, s)
    assert ours.startswith(b"! 1-port S-parameters")
    # the first comment names the package that wrote the file
    assert ours.split(b"\n")[1:] == theirs.split(b"\n")[1:]


def test_polar_cut_full_sphere_uses_real_back_half():
    theta = np.linspace(0, np.pi, 7)
    phi = np.linspace(0, 2 * np.pi, 13)[:-1]
    grid = np.zeros((7, 12))
    grid[:, 0] = 10.0
    grid[:, 6] = -5.0
    ang, val = polar_cut(types.SimpleNamespace(
        theta=theta, phi=phi, intensity=grid), 0.0)
    assert ang.shape == val.shape == (14,)
    assert np.all(val[:7] == 10.0)
    assert np.all(val[7:] == -5.0)
    res2 = types.SimpleNamespace(
        theta=theta, phi=np.array([0.0, np.pi / 2]),
        intensity=np.stack([np.full(7, 3.0), np.full(7, 1.0)], axis=1))
    _ang2, val2 = polar_cut(res2, 0.0)
    assert np.all(np.asarray(val2) == 3.0)


def test_update_fields_notifies_once():
    sc = MultiPatchScene(device="cpu")
    inst = sc.add_patch(_params())
    calls = []
    sc.set_change_callback(lambda: calls.append(1))
    sc.update_fields(inst, {"center_x_m": 0.05, "rot_z_deg": 30.0,
                            "center_y_m": 0.01})
    assert len(calls) == 1
    assert inst.center_x_m == 0.05 and inst.rot_z_deg == 30.0


# ---------------------------------------------------------------------------
# dispatch_prepare: the five kinds against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", [k for k, _ in SOLVER_CHOICES])
def test_dispatch_prepare_matches_jax(kind):
    """Every sidebar solver choice prepares the JAX package's simulation:
    grid, boundary, step budget and NF2FF angles."""
    kw = dict(feed="+Y", boundary="PML_8" if kind != "fixed" else "MUR",
              theta_step_deg=10.0, phi_step_deg=30.0, n_steps_max=64)
    if kind == "microstrip_3d":
        kw["mesh_quality"] = 1
    jprep, jrunner = jgui.dispatch_prepare(JParams.from_user_units(**CANON),
                                           kind, **kw)
    tprep, trunner = dispatch_prepare(_params(), kind, device="cpu", **kw)
    assert jprep.ok and tprep.ok, (jprep.message, tprep.message)
    assert trunner.__name__ == jrunner.__name__
    assert type(tprep).__name__ == type(jprep).__name__
    js, ts = jprep.sim, tprep.sim
    assert ts.grid.shape == js.grid.shape
    for ax in ("x", "y", "z"):
        np.testing.assert_array_equal(getattr(ts.grid, ax),
                                      np.asarray(getattr(js.grid, ax)))
    assert ts.cfg.boundary == js.cfg.boundary
    assert ts.cfg.n_steps_max == js.cfg.n_steps_max == 64
    np.testing.assert_array_equal(tprep.theta, jprep.theta)
    np.testing.assert_array_equal(tprep.phi, jprep.phi)
    assert str(ts.device) == "cpu"


def test_dispatch_prepare_defaults_to_the_card():
    import inspect

    for fn in (dispatch_prepare, prepare_legacy_mode,
               MultiPatchScene.__init__):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


# ---------------------------------------------------------------------------
# tests/test_abort_progress.py on the port
# ---------------------------------------------------------------------------

def _build(n_steps, check_every=48):
    """Tiny patch scene; the port's run loop on the CPU (plain twins)."""
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
    cfg = FDTDConfig(n_steps_max=n_steps, check_every=check_every,
                     end_criteria=1e-30, probe_decimation=4)
    return build_simulation(
        scene, grid, f0=2.45e9, fc=1.225e9, cfg=cfg, device="cpu",
        port_freqs_hz=np.linspace(2e9, 3e9, 5),
        nf_freqs_hz=np.array([2.45e9]))


CHUNK = 48  # check_every 48 at decimation 4: 12 intervals of 4 steps
BUDGET = 960  # 20 chunks


def test_progress_ticks_monotone_and_complete():
    sim = _build(BUDGET)
    ticks = []
    out = sim.run(progress_cb=lambda n, total, r: ticks.append((n, total, r)))
    assert int(out["steps"]) == BUDGET
    assert out["aborted"] is False
    assert len(ticks) >= 3
    steps_seen = [t[0] for t in ticks]
    assert steps_seen == sorted(steps_seen)
    assert steps_seen[-1] == BUDGET
    for _, _, r in ticks:
        assert np.isfinite(r) and 0.0 < r <= 1.0
    n, total, _ = ticks[-1]
    assert n == total


def test_broken_progress_cb_does_not_kill_run():
    """A raising callback is ignored, after every chunk and at the final
    tick, as in the JAX package."""
    sim = _build(384)
    calls = []

    def bad_cb(*a):
        calls.append(a)
        raise RuntimeError("UI went away")

    out = sim.run(progress_cb=bad_cb)
    assert int(out["steps"]) == 384
    assert out["aborted"] is False
    assert len(calls) == 384 // CHUNK + 1  # one a chunk and the final one
    assert calls[-1][0] == calls[-1][1] == 384


def test_broken_progress_cb_does_not_kill_sharded_run():
    """The sharded run's final tick ignores a raising callback too; the
    output equals the unsharded run's."""
    from fdtd_solver_antennas_tpu_torch.parallel.sharding import (
        make_device_mesh, shard_simulation)

    ref = _build(384).run()
    sim = shard_simulation(_build(384), make_device_mesh())
    calls = []

    def bad_cb(*a):
        calls.append(a)
        raise RuntimeError("UI went away")

    out = sim.run(progress_cb=bad_cb)
    assert int(out["steps"]) == int(ref["steps"]) == 384
    assert len(calls) == 1
    np.testing.assert_allclose(np.asarray(out["uf"]), np.asarray(ref["uf"]),
                               rtol=1e-5, atol=1e-12)


def test_abort_stops_within_one_chunk():
    sim = _build(BUDGET)
    out = sim.run(abort_cb=lambda: True)
    assert out["aborted"] is True
    assert int(out["steps"]) == CHUNK


def test_aborted_state_is_a_valid_resume_checkpoint():
    ref = _build(BUDGET).run()
    ticks = []
    out_a = _build(BUDGET).run(
        progress_cb=lambda n, t, r: ticks.append(n),
        abort_cb=lambda: len(ticks) >= 1,
    )
    assert out_a["aborted"] is True
    assert int(out_a["steps"]) == CHUNK
    out_b = _build(BUDGET).run(resume_state=out_a["state"])
    assert int(out_b["steps"]) == BUDGET
    assert out_b["aborted"] is False
    np.testing.assert_allclose(
        np.asarray(out_b["uf"]), np.asarray(ref["uf"]), rtol=1e-5, atol=1e-12)


def test_format_progress():
    pct, text = format_progress(500, 2000, 3.2e-3)
    assert pct == 25.0
    assert "500/2000" in text and "25%" in text and "3.2e-03" in text
    assert format_progress(10, 0, 1.0)[0] == 100.0
    assert format_progress(0, 100, 1.0)[0] == 0.0
    assert text == jgui.format_progress(500, 2000, 3.2e-3)[1]


def test_background_run_progress_and_result():
    def fake_solver(x, *, progress_cb=None, abort_cb=None):
        for i in range(5):
            progress_cb(i + 1, 5, 1.0 / (i + 1))
            time.sleep(0.01)
        return x * 2

    run = BackgroundRun().start(fake_solver, 21)
    _wait(run, 5.0)
    assert run.error is None
    assert run.result == 42
    assert run.progress == (5, 5, pytest.approx(0.2))


def test_background_run_abort_and_error():
    def slow_solver(*, progress_cb=None, abort_cb=None):
        for _ in range(200):
            if abort_cb():
                return "aborted"
            time.sleep(0.01)
        return "finished"

    run = BackgroundRun().start(slow_solver)
    run.abort()
    assert run.aborting
    _wait(run, 5.0)
    assert run.result == "aborted"

    def broken(*, progress_cb=None, abort_cb=None):
        raise ValueError("boom")

    run2 = BackgroundRun().start(broken)
    _wait(run2, 5.0)
    assert run2.error == "boom"
    assert run2.result is None


def test_background_run_drives_design_array():
    """The web app's Array tab call path: BackgroundRun passes progress_cb
    and abort_cb to design_array (the tight-pitch guard: no FDTD runs)."""
    from fdtd_solver_antennas_tpu_torch.solvers.array_synth import design_array

    p = PatchAntennaParams.from_user_units(
        frequency_ghz=10.0, er=2.2, h_mm=0.787, loss_tangent=0.0009)
    run = BackgroundRun().start(design_array, p, 2, 1, device="cpu")
    _wait(run, 30.0)
    assert run.error is None
    assert not run.result.ok and "increase the pitch" in run.result.message


# ---------------------------------------------------------------------------
# a capped run on a worker thread, against the JAX package and the main thread
# ---------------------------------------------------------------------------

def _capturing(prep):
    """Keep the engine's raw output of ``prep.sim.run``."""
    captured = {}
    run = prep.sim.run

    def capture(**kw):
        captured["out"] = run(**kw)
        return captured["out"]

    prep.sim.run = capture
    return captured


def _close(a, b, rtol=2e-4):
    a, b = np.asarray(a), np.asarray(b)
    atol = 1e-5 * max(float(np.abs(b).max()), 1e-20)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def capped():
    """The canonical patch capped at 445 steps (one chunk of 5 × 89): the
    JAX package's run, the port's through BackgroundRun on a worker thread
    and the port's on the main thread."""
    jprep = jprepare_fixed(JParams.from_user_units(**CANON), n_steps_max=445)
    jcap = _capturing(jprep)
    jres = jrun_fixed(jprep, frequency_hz=2.45e9, verbose=0)

    tprep, runner = dispatch_prepare(_params(), "fixed", n_steps_max=445,
                                     device="cpu")
    assert runner is run_prepared_fixed
    tcap = _capturing(tprep)
    bg = BackgroundRun().start(runner, tprep, frequency_hz=2.45e9, verbose=0)
    _wait(bg, 120.0)
    assert bg.error is None, bg.error
    bg_out = tcap["out"]
    main_res = runner(tprep, frequency_hz=2.45e9, verbose=0)
    return (jres, jcap["out"]), (bg.result, bg_out, bg), (main_res, tcap["out"])


def test_background_run_matches_jax(capped):
    (jres, jout), (tres, tout, bg), _main = capped
    assert jres.ok and tres.ok, (jres.message, tres.message)
    assert tres.steps_run == jres.steps_run == 445
    assert bg.progress == (445, 445, pytest.approx(float(tout["e_ratio"])))
    _close(tout["uf"], jout["uf"])
    _close(tout["if_"], jout["if_"])
    for key in ("nf_e", "nf_h"):
        for a, b in zip(tout[key], jout[key], strict=True):
            _close(a, b)
    np.testing.assert_allclose(tres.s11, jres.s11, rtol=1e-3)


def test_background_run_equals_main_thread(capped):
    _jax, (tres, tout, _bg), (mres, mout) = capped
    np.testing.assert_array_equal(np.asarray(tout["uf"]), np.asarray(mout["uf"]))
    np.testing.assert_array_equal(np.asarray(tout["if_"]),
                                  np.asarray(mout["if_"]))
    for a, b in zip(tout["fields"], mout["fields"], strict=True):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(tres.s11, mres.s11)


def test_worker_thread_wiring_as_the_gui_does():
    """The GUI worker's wiring: callbacks passed by the runner's signature,
    the run on a thread, progress ticks monotone, an abort after the first
    tick stopping at one chunk."""
    from fdtd_solver_antennas_tpu_torch.solvers.microstrip import (
        run_prepared_microstrip)

    assert set(runner_kwargs(run_prepared_fixed, print, bool)) == {
        "progress_cb", "abort_cb"}
    assert runner_kwargs(run_prepared_microstrip, print, bool) == {}
    prep, runner = dispatch_prepare(_params(), "fixed", n_steps_max=445 * 3,
                                    device="cpu")
    ticks, box = [], {}
    abort = threading.Event()

    def progress(n, total, r):
        ticks.append(n)
        abort.set()

    def worker():
        box["res"] = runner(prep, frequency_hz=2.45e9, verbose=0,
                            **runner_kwargs(runner, progress, abort.is_set))

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    t.join(120.0)
    assert not t.is_alive()
    res = box["res"]
    assert not res.ok and res.diagnostics["aborted"]
    assert res.diagnostics["steps_done"] == 445 and ticks == [445]


# ---------------------------------------------------------------------------
# launches run on their tensors' device, whatever the thread's current one
# ---------------------------------------------------------------------------

def test_device_guard_switches_only_to_another_card(monkeypatch):
    """The guard is ``torch.cuda.device(i)`` for ``cuda:i`` when the
    calling thread's current device is another, and the no-op context
    otherwise: the CPU, or the current device (no device query then sets
    anything)."""
    from fdtd_solver_antennas_tpu_torch.ops import fdtd_cuda

    def no_set(*a):
        raise AssertionError("device set")

    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "set_device", no_set)
    assert fdtd_cuda.device_guard(torch.device("cpu")) is fdtd_cuda._NO_GUARD
    same = fdtd_cuda.device_guard(torch.device("cuda", 0))
    assert same is fdtd_cuda._NO_GUARD
    with same:
        pass
    other = fdtd_cuda.device_guard(torch.device("cuda", 1))
    assert isinstance(other, torch.cuda.device) and other.idx == 1
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    assert fdtd_cuda.device_guard(torch.device("cuda", 1)) is fdtd_cuda._NO_GUARD
    other = fdtd_cuda.device_guard(torch.device("cuda", 0))
    assert isinstance(other, torch.cuda.device) and other.idx == 0


def test_launch_sets_the_device_only_for_another_card(monkeypatch):
    """``launch(dev, fn, *args)`` calls ``fn(*args, stream)`` with ``dev``'s
    current stream: directly where ``dev`` is the thread's current device,
    inside ``torch.cuda.device(dev)`` where it is not."""
    from fdtd_solver_antennas_tpu_torch.ops import fdtd_cuda

    entered = []

    class Guard:
        def __init__(self, dev):
            self.dev = dev

        def __enter__(self):
            entered.append(self.dev)

        def __exit__(self, *exc):
            return False

    current = {"index": 0}
    monkeypatch.setattr(torch._C, "_cuda_getDevice", lambda: current["index"],
                        raising=False)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda index: 1000 + index, raising=False)
    monkeypatch.setattr(torch.cuda, "device", Guard)
    calls = []

    def fn(*args):
        calls.append(args)
        return 0

    assert fdtd_cuda.launch(torch.device("cuda", 0), fn, "a", 7) == 0
    assert calls == [("a", 7, 1000)] and entered == []
    fdtd_cuda.launch(torch.device("cuda", 1), fn, "b")
    assert calls[-1] == ("b", 1001) and entered == [torch.device("cuda", 1)]
    current["index"] = 1
    fdtd_cuda.launch(torch.device("cuda", 1), fn)
    assert calls[-1] == (1001,) and len(entered) == 1


def test_every_launch_and_query_sits_in_a_device_guard():
    """Every library call that takes a stream goes through
    ``fdtd_cuda.launch`` (``_stream`` is called nowhere else but in
    ``fdtd_steps.grid_barriers``, which launches on the thread's current
    device by its own definition), and every plan or occupancy query on a
    tensor's card sits inside ``with device_guard(...)``."""
    import ast
    from pathlib import Path

    ops = Path(__file__).resolve().parents[1] / (
        "fdtd_solver_antennas_tpu_torch/ops")
    queries = {"_query", "fdtd_march_blocks_per_sm"}
    launches = queried = 0
    for path in sorted(ops.glob("*.py")):
        tree = ast.parse(path.read_text())

        def walk(node, guarded, fn):
            nonlocal launches, queried
            if isinstance(node, ast.FunctionDef):
                fn = node.name
            if isinstance(node, ast.With) and any(
                    isinstance(i.context_expr, ast.Call)
                    and getattr(i.context_expr.func, "id", None) == "device_guard"
                    for i in node.items):
                guarded = True
            if isinstance(node, ast.Call):
                f = node.func
                name = f.id if isinstance(f, ast.Name) else getattr(f, "attr", None)
                where = f"{path.name}:{node.lineno} {name}"
                if name == "_stream":
                    assert fn in ("launch", "grid_barriers"), where
                elif name == "launch":
                    launches += 1
                elif name in queries:
                    assert guarded, where + " unguarded"
                    queried += 1
            for child in ast.iter_child_nodes(node):
                walk(child, guarded, fn)

        walk(tree, False, None)
    assert launches >= 11 and queried >= 2, (launches, queried)
