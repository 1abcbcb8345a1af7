"""The port's designer-scene scripts and ``stream_tune`` against the JAX
package on the CPU.

- ``multi_patch_array`` and ``mixed_patch_horn``: the script's scene at
  its controls (mesh quality 2, steps of 10° in φ and 5° in θ) prepares
  the JAX package's grid lines, NF2FF angles and ports; through
  ``main(argv)`` on ``--device cpu`` the two-patch run is cut to one
  chunk and the mixed scene's run is stubbed (its 4.2M cells are the
  card's work);
- ``stream_tune`` on a small grid forced to stream: its JSON keys, a
  refused T's ``skip`` line, and every T's ``uf`` against the chunk route
  and the JAX package's XLA run at the same probe decimation (rtol 2e-4,
  atol 1e-5·max|ref|, the north-star tolerance).
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from fdtd_solver_antennas_tpu import FeedDirection as JFeed
from fdtd_solver_antennas_tpu.frontends.designer import MultiPatchScene as JScene
from fdtd_solver_antennas_tpu.models.params import (
    HornAntennaParams as JHorn,
    PatchAntennaParams as JParams,
)
from fdtd_solver_antennas_tpu.models.scene import Scene as JSceneModel
from fdtd_solver_antennas_tpu.ops.fdtd import FDTDConfig as JConfig
from fdtd_solver_antennas_tpu.ops.fdtd import build_simulation as jbuild
from fdtd_solver_antennas_tpu.ops.mesh import MeshBuilder as JMeshBuilder

from fdtd_solver_antennas_tpu_torch.examples import (
    mixed_patch_horn,
    multi_patch_array,
    stream_tune,
)
from fdtd_solver_antennas_tpu_torch.frontends import designer
from fdtd_solver_antennas_tpu_torch.models.scene import Scene
from fdtd_solver_antennas_tpu_torch.ops.mesh import MeshBuilder
from fdtd_solver_antennas_tpu_torch.solvers.base import FDTDSolverResult

RTOL, ATOL_REL = 2e-4, 1e-5
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


def _np(a):
    return a.numpy() if torch.is_tensor(a) else np.asarray(a)


def _close(a, b, what=""):
    a, b = _np(a), _np(b)
    atol = ATOL_REL * max(float(np.abs(b).max()), 1e-20)
    np.testing.assert_allclose(a, b, rtol=RTOL, atol=atol, err_msg=what)


# ---------------------------------------------------------------------------
# the designer scenes
# ---------------------------------------------------------------------------

def _jax_array_scene():
    params = JParams.from_user_units(**CANON)
    scene = JScene()
    scene.add_patch(params, center_x_m=-0.06)
    scene.add_patch(params, center_x_m=0.06, feed_direction=JFeed.POS_X)
    return scene


def _jax_mixed_scene():
    scene = JScene()
    scene.add_patch(JParams.from_user_units(**CANON))
    scene.add_horn(
        JHorn.from_user_units(
            frequency_ghz=2.45, throat_a_mm=86.0, throat_b_mm=43.0,
            aperture_A_mm=150.0, aperture_B_mm=110.0, length_mm=60.0),
        center_x_m=0.18, rot_z_deg=25.0)
    return scene


def _assert_prepared_as_jax(prep, jprep):
    """Grid lines, NF2FF angles and every port: position, axis, cells,
    edge lengths and source column."""
    assert prep.ok and jprep.ok, (prep.message, jprep.message)
    sim, jsim = prep.sim, jprep.sim
    assert sim.grid.shape == jsim.grid.shape
    for a in "xyz":
        np.testing.assert_array_equal(sim.grid.lines[a], jsim.grid.lines[a])
    np.testing.assert_array_equal(prep.theta, jprep.theta)
    np.testing.assert_array_equal(prep.phi, jprep.phi)
    assert len(sim.ports) == len(jsim.ports) > 0
    for p, jp in zip(sim.ports, jsim.ports):
        assert dataclasses.asdict(p.spec) == dataclasses.asdict(jp.spec)
        assert p.axis == jp.axis and p.sl == jp.sl
        np.testing.assert_array_equal(p.dl_m, np.asarray(jp.dl_m))
        np.testing.assert_allclose(p.src_col, np.asarray(jp.src_col),
                                   rtol=1e-6)


@pytest.mark.parametrize("name", ["multi_patch_array", "mixed_patch_horn"])
def test_designer_scene_prepares_as_jax(name):
    """The script's scene at its controls (mesh quality 2, steps of 10°
    in φ and 5° in θ) prepares the JAX package's grid and ports."""
    mod = {"multi_patch_array": multi_patch_array,
           "mixed_patch_horn": mixed_patch_horn}[name]
    scene = mod.build_scene(device="cpu")
    jscene = (_jax_array_scene if name == "multi_patch_array"
              else _jax_mixed_scene)()
    for k in ("mesh_quality", "phi_step_deg", "theta_step_deg"):
        setattr(jscene.controls, k, getattr(scene.controls, k))
    assert (scene.controls.mesh_quality, scene.controls.phi_step_deg,
            scene.controls.theta_step_deg) == (2, 10.0, 5.0)
    _assert_prepared_as_jax(scene.prepare(), jscene.prepare())


def test_multi_patch_array_main_runs_cut(tmp_path, monkeypatch, capsys):
    """``main`` on the CPU, the run cut to one chunk: the summary line
    and both figures (matplotlib is installed here)."""
    real = designer.run_prepared_multi_patch_3d

    def cut(prep, **kw):
        prep.sim.cfg = dataclasses.replace(prep.sim.cfg, n_steps_max=1)
        return real(prep, **kw)

    monkeypatch.setattr(designer, "run_prepared_multi_patch_3d", cut)
    multi_patch_array.main(["--device", "cpu", "--outdir", str(tmp_path)])
    lines = capsys.readouterr().out.splitlines()
    assert any(ln.startswith("f_res ") and ln.endswith(" Mcells/s")
               for ln in lines)
    for png in ("array_scene.png", "array_pattern.png"):
        assert f"Saved: {tmp_path / png}" in lines
        assert (tmp_path / png).read_bytes()[:4] == b"\x89PNG"


def test_mixed_patch_horn_main_runs_stubbed(tmp_path, monkeypatch, capsys):
    """``main`` on the CPU with the run stubbed (the prepare is real): the
    JAX script's line with its port count, one dip line a port, both
    figures."""
    freq = np.linspace(2e9, 3e9, 11)
    s11 = [np.linspace(0.9, 0.1, 11) + 0j, np.linspace(0.1, 0.9, 11) + 0j]

    def fake(prep, *, frequency_hz, **kw):
        assert len(prep.sim.ports) == 2 and prep.sim.grid.shape == (141, 201, 152)
        th, ph = np.arange(0, 181, 5.0), np.arange(0, 360, 10.0)
        return FDTDSolverResult(
            True, "stub", theta=np.deg2rad(th), phi=np.deg2rad(ph),
            intensity=np.zeros((th.size, ph.size)), freq=freq, s11=s11[0],
            f_res_hz=3e9, Dmax=10.0, mcells_per_s=1234.0,
            diagnostics={"s11_all_ports": s11})

    monkeypatch.setattr(designer, "run_prepared_multi_patch_3d", fake)
    mixed_patch_horn.main(["--device", "cpu", "--outdir", str(tmp_path)])
    lines = capsys.readouterr().out.splitlines()
    assert "f_res 3.000 GHz, Dmax 10.0 dBi, 1234 Mcells/s, 2 ports" in lines
    assert "port 1: |S11|min -20.00 dB at 3.000 GHz" in lines
    assert "port 2: |S11|min -20.00 dB at 2.000 GHz" in lines
    for png in ("mixed_scene.png", "mixed_pattern.png"):
        assert f"Saved: {tmp_path / png}" in lines


# ---------------------------------------------------------------------------
# stream_tune
# ---------------------------------------------------------------------------

def _small_scene(jax=False):
    """``tests/test_pallas_kernel.py``'s small patch (19×17×19 lines)."""
    mb = (JMeshBuilder if jax else MeshBuilder)()
    mb.add_line("x", [-40, 40, 0.0, -6.0])
    mb.add_line("y", [-40, 40, 0.0])
    mb.add_line("z", [-20, 30])
    mb.add_line("z", np.linspace(0, 1.6, 3))
    grid = mb.build(5.0)
    scene = (JSceneModel if jax else Scene)()
    scene.add_material_box("sub", 4.3, 0.005, [-20, -20, 0], [20, 20, 1.6], 0)
    scene.add_metal_box("patch", [-15, -12, 1.6], [15, 12, 1.6], priority=10)
    scene.add_metal_box("gnd", [-20, -20, 0], [20, 20, 0], priority=10)
    scene.add_lumped_port(1, 50.0, [-6, 0, 0], [-6, 0, 1.6], direction="z")
    return scene, grid, 2.45e9, 1.225e9


def test_stream_tune_on_a_small_grid(monkeypatch, capsys):
    """``main(["--T", "1,2,4,9"])`` on the small patch, 600 steps asked:
    T = 9 is past the march's region (8 on this grid) and prints a skip
    line; 1, 2 and 4 run at one probe decimation (the automatic 44, a
    multiple of 4) for the same 968 steps; each T's ``uf`` equals the
    first's, the chunk route's and the JAX package's XLA run's."""
    monkeypatch.setattr(stream_tune, "tall_scene", _small_scene)
    monkeypatch.setattr(stream_tune, "N_STEPS", 600)
    assert stream_tune.common_decimation((1, 2, 4, 9), make_scene=_small_scene,
                                         n_steps=600, device="cpu") == 44
    with pytest.raises(ValueError, match="no probe decimation"):
        stream_tune.common_decimation((5, 7, 8), make_scene=_small_scene,
                                      n_steps=600, device="cpu")
    outs = {}
    real = stream_tune.build

    def build(T, decim=None, **kw):
        sim = real(T, decim, **kw)
        run = sim.run
        sim.run = lambda: outs.__setitem__(T, run()) or outs[T]
        return sim

    monkeypatch.setattr(stream_tune, "build", build)
    stream_tune.main(["--T", "1,2,4,9", "--device", "cpu"])
    recs = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert recs[3]["T"] == 9 and "cannot be honored" in recs[3]["skip"]
    for rec, T in zip(recs[:3], (1, 2, 4)):
        assert set(rec) == {"T", "gcells_per_s", "wall_s", "steps", "uf_gap"}
        assert rec["T"] == T and rec["steps"] == 968 and rec["uf_gap"] == 0.0
        assert rec["wall_s"] > 0
    assert recs[4]["best"] in recs[:3]
    chunk = real(None, 44, make_scene=_small_scene, n_steps=600,
                 device="cpu", pallas_mode="chunk")
    assert chunk.pallas_mode == "chunk"
    ref = chunk.run()
    scene, grid, f0, fc = _small_scene(jax=True)
    jsim = jbuild(scene, grid, f0=f0, fc=fc, cfg=JConfig(
        n_steps_max=600, end_criteria=1e-30, check_every=500,
        probe_decimation=44, use_pallas=False),
        port_freqs_hz=np.linspace(2e9, 3e9, 51), nf_freqs_hz=np.array([2.45e9]))
    jref = jsim.run()
    assert int(jref["steps"]) == int(ref["steps"]) == 968
    for T in (1, 2, 4):
        _close(outs[T]["uf"], ref["uf"], f"T={T} vs chunk")
        _close(outs[T]["uf"], jref["uf"], f"T={T} vs JAX")
        _close(outs[T]["if_"], jref["if_"], f"T={T} if_ vs JAX")
