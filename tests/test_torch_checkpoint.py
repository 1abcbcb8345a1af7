"""The port's checkpoints against the JAX package's, on the CPU.

The small patch of ``tests/test_checkpoint.py`` runs in both packages
from the same inputs (the JAX package on its XLA path, the port on its
plain PyTorch twins). ``save_state`` writes the JAX package's ``.npz``
keys; a file either package writes loads in the other and resumes there
to the straight run's fields, DFT sums and steps (rtol 2e-4, atol
1e-5·max|ref|, the north-star tolerance; bit for bit within the port).
A checkpoint written at one probe decimation resumes at another
(``tests/test_checkpoint.py``'s cross-decimation case).
"""

import numpy as np
import pytest
import torch

from fdtd_solver_antennas_tpu.models.scene import Scene as JScene
from fdtd_solver_antennas_tpu.ops.fdtd import FDTDConfig as JConfig
from fdtd_solver_antennas_tpu.ops.fdtd import build_simulation as jbuild
from fdtd_solver_antennas_tpu.ops.mesh import MeshBuilder as JMeshBuilder
from fdtd_solver_antennas_tpu.post import checkpoint as jckpt

from fdtd_solver_antennas_tpu_torch.models.scene import Scene
from fdtd_solver_antennas_tpu_torch.ops.fdtd import FDTDConfig, build_simulation
from fdtd_solver_antennas_tpu_torch.ops.mesh import MeshBuilder
from fdtd_solver_antennas_tpu_torch.post import load_state, save_state

RTOL = 2e-4
THREADS = 2  # PyTorch intra-op threads while this file runs


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Test workers share the cores (pytest-xdist); PyTorch's default of
    one intra-op thread per core would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(n)


def _build(jax, n_steps, decim=4, check_every=100, boundary="MUR"):
    """``tests/test_checkpoint.py``'s patch through either package."""
    mb = (JMeshBuilder if jax else MeshBuilder)()
    mb.add_line("x", [-40, 40, 0.0, -6.0])
    mb.add_line("y", [-40, 40, 0.0])
    mb.add_line("z", [-20, 30])
    mb.add_line("z", np.linspace(0, 1.6, 3))
    grid = mb.build(5.0)
    scene = (JScene if jax else Scene)()
    scene.add_material_box("sub", 4.3, 0.005, [-20, -20, 0], [20, 20, 1.6], 0)
    scene.add_metal_box("patch", [-15, -12, 1.6], [15, 12, 1.6], priority=10)
    scene.add_metal_box("gnd", [-20, -20, 0], [20, 20, 0], priority=10)
    scene.add_lumped_port(1, 50.0, [-6, 0, 0], [-6, 0, 1.6], direction="z")
    cfg = (JConfig if jax else FDTDConfig)(
        n_steps_max=n_steps, check_every=check_every, end_criteria=1e-30,
        probe_decimation=decim, boundary=boundary)
    return (jbuild if jax else build_simulation)(
        scene, grid, f0=2.45e9, fc=1.225e9, cfg=cfg,
        port_freqs_hz=np.linspace(2e9, 3e9, 11),
        nf_freqs_hz=np.array([2.45e9]), **({} if jax else dict(device="cpu")))


def _np(a):
    return a.numpy() if torch.is_tensor(a) else np.asarray(a)


def _close(a, b, rtol=RTOL):
    a, b = _np(a), _np(b)
    atol = 1e-5 * max(float(np.abs(b).max()), 1e-20)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


def _assert_same_run(out, ref, exact=False):
    check = ((lambda a, b: np.testing.assert_array_equal(_np(a), _np(b)))
             if exact else _close)
    assert int(out["steps"]) == int(ref["steps"])
    for fa, fb in zip(out["fields"], ref["fields"], strict=True):
        check(fa, fb)
    for key in ("uf", "if_"):
        check(out[key], ref[key])
    for key in ("nf_e", "nf_h"):
        for a, b in zip(out[key], ref[key], strict=True):
            check(a, b)


@pytest.fixture(scope="module")
def straight():
    """The 400-step straight runs of both packages."""
    return _build(False, 400).run(), _build(True, 400).run()


def test_round_trip_is_identity(tmp_path):
    out = _build(False, 100).run()
    save_state(tmp_path / "s", out)  # '.npz' appended, as the JAX package does
    state = load_state(tmp_path / "s")
    for i, f in enumerate(out["state"]["fields"]):
        np.testing.assert_array_equal(state["fields"][i], f.numpy())
    for key in ("uf", "if_", "nf_e", "nf_h"):
        np.testing.assert_array_equal(state[key], out["state"][key].numpy())
    assert int(state["n"]) == 100 and int(state["decim"]) == 4
    assert state["e_max"] == np.float32(out["state"]["e_max"])
    assert state["e_ratio"] == np.float32(out["state"]["e_ratio"])


@pytest.mark.parametrize("boundary", ["MUR", "PML_4"])
def test_files_carry_the_jax_keys(tmp_path, boundary):
    """Both packages write the same keys, shapes and dtypes; each loads
    the other's file into the same layout."""
    tout = _build(False, 40, check_every=40, boundary=boundary).run()
    jout = _build(True, 40, check_every=40, boundary=boundary).run()
    save_state(tmp_path / "t.npz", tout)
    jckpt.save_state(tmp_path / "j.npz", jout)
    with np.load(tmp_path / "t.npz") as t, np.load(tmp_path / "j.npz") as j:
        assert sorted(t.files) == sorted(j.files)
        if boundary.startswith("PML"):
            assert "psi_e_xy" in t.files and "psi_h_zy" in t.files
        for k in j.files:
            assert t[k].dtype == j[k].dtype, k
            assert t[k].shape == j[k].shape, k
    for load in (load_state, jckpt.load_state):
        a, b = load(tmp_path / "t.npz"), load(tmp_path / "j.npz")
        assert a.keys() == b.keys()
        assert a["psi_e"].keys() == b["psi_e"].keys()


def test_resume_matches_straight_run(tmp_path, straight):
    out_a = _build(False, 200).run()
    assert int(out_a["steps"]) == 200
    save_state(tmp_path / "state.npz", out_a)
    out_b = _build(False, 400).run(resume_state=load_state(tmp_path / "state.npz"))
    _assert_same_run(out_b, straight[0], exact=True)


def test_jax_checkpoint_resumes_in_the_port(tmp_path, straight):
    jckpt.save_state(tmp_path / "jax.npz", _build(True, 200).run())
    out = _build(False, 400).run(resume_state=load_state(tmp_path / "jax.npz"))
    _assert_same_run(out, straight[0])
    _assert_same_run(out, straight[1])


def test_port_checkpoint_resumes_in_jax(tmp_path, straight):
    save_state(tmp_path / "port.npz", _build(False, 200).run())
    out = _build(True, 400).run(
        resume_state=jckpt.load_state(tmp_path / "port.npz"))
    _assert_same_run(out, straight[1])


def test_resume_across_probe_decimation(tmp_path):
    """A checkpoint written at decimation 6 resumes at decimation 4: the
    resumed DFT sums are rescaled by old/new cadence. The split run's
    integral stays within 2% of the uninterrupted one (the band-limited
    signal is oversampled at both cadences), and the port's split run
    equals the JAX package's (its checkpoint loaded by the JAX package)."""
    ref = _build(False, 720, decim=4, check_every=120).run()
    out_a = _build(False, 600, decim=6, check_every=120).run()
    assert int(out_a["state"]["decim"]) == 6
    save_state(tmp_path / "xdec.npz", out_a)
    out_b = _build(False, 720, decim=4, check_every=120).run(
        resume_state=load_state(tmp_path / "xdec.npz"))
    assert int(out_b["steps"]) == int(ref["steps"])
    uf_b, uf_r = out_b["uf"], ref["uf"]
    rel = np.abs(uf_b - uf_r).max() / np.abs(uf_r).max()
    assert rel < 0.02, f"cross-decimation resume uf rel err {rel:.3f}"
    jout = _build(True, 720, decim=4, check_every=120).run(
        resume_state=jckpt.load_state(tmp_path / "xdec.npz"))
    _assert_same_run(out_b, jout)
