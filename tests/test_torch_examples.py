"""The port's usage scripts (``fdtd_solver_antennas_tpu_torch/examples/``)
against the JAX package's calls on the CPU.

Each of the root ``examples/`` scripts has a counterpart in the port that
runs as ``python -m fdtd_solver_antennas_tpu_torch.examples.<name>``. Here
every one imports neither JAX nor the JAX package (its source read), and
each runs through its ``main(argv)`` on ``--device cpu`` at a cut size:

- ``checkpoint_resume`` at a cut step budget (445 steps, then resumed to
  1,335): the resumed run bit-equal to the straight one, and the JAX
  package's own save / load / resume (``uf``, ``if_``, ``steps``,
  ``e_ratio`` at rtol 2e-4, atol 1e-5·max|ref|, the north-star tolerance);
- ``design_sweep`` cut to one chunk: each variant's ``steps``, ``uf`` and
  ``if_`` against the JAX package's vmapped XLA sweep at 2e-4, as
  ``tests/test_torch_sweep.py`` holds them, and the dips it prints.

In a subprocess with JAX, the JAX package and matplotlib blocked, the
seven scripts import and take ``--help``, and the figures of a designer
script and an inverse-design script (their runs stubbed) are named on
``Not drawn:`` lines and not written. The designer scenes and
``stream_tune`` are ``tests/test_torch_examples_scenes.py``; the
inverse-design scripts against the JAX package,
``tests/test_torch_examples_inverse.py``.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from fdtd_solver_antennas_tpu.models.params import PatchAntennaParams as JParams
from fdtd_solver_antennas_tpu.post import checkpoint as jckpt
from fdtd_solver_antennas_tpu.solvers import sweep as jsweep
from fdtd_solver_antennas_tpu.solvers.patch_fixed import (
    prepare_patch_fixed as jprepare_fixed,
)

from fdtd_solver_antennas_tpu_torch.examples import checkpoint_resume, design_sweep

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "fdtd_solver_antennas_tpu_torch" / "examples"
SCRIPTS = ("checkpoint_resume", "design_sweep", "multi_patch_array",
           "mixed_patch_horn", "stream_tune", "inverse_miniaturized_patch",
           "inverse_broadside_gain")
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
# imports
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", SCRIPTS)
def test_script_imports_neither_jax_nor_the_jax_package(name):
    """The script's own imports: relative ones, the standard library,
    NumPy and PyTorch; it defines ``main(argv=None)`` and runs it as a
    module."""
    src = (EXAMPLES / f"{name}.py").read_text()
    tree = ast.parse(src)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods = [node.module]
        else:
            continue
        for mod in mods:
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "fdtd_solver_antennas_tpu"), (
                f"{name} imports {mod}")
    fns = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}
    assert "main" in fns and fns["main"].args.args[0].arg == "argv"
    assert 'if __name__ == "__main__":' in src


_BLOCKED = r"""
import sys, types
for name in ("jax", "jaxlib", "fdtd_solver_antennas_tpu", "matplotlib",
             "mpl_toolkits"):
    sys.modules[name] = None  # any import of them now raises ImportError
import importlib
import numpy as np
from fdtd_solver_antennas_tpu_torch.solvers.base import FDTDSolverResult
from fdtd_solver_antennas_tpu_torch.frontends import designer
mods = {n: importlib.import_module("fdtd_solver_antennas_tpu_torch.examples." + n)
        for n in sys.argv[2].split(",")}
for n, m in mods.items():
    try:
        m.main(["--help"])
    except SystemExit as e:
        print("HELP", n, e.code)
out = sys.argv[1]

def fake_run(prep, *, frequency_hz, **kw):
    theta, phi = np.deg2rad(np.arange(0, 181, 5.0)), np.deg2rad(np.arange(0, 360, 10.0))
    return FDTDSolverResult(
        True, "stub", theta=theta, phi=phi, intensity=np.zeros((37, 36)),
        freq=np.linspace(2e9, 3e9, 5), s11=np.full(5, 0.5 + 0j), f_res_hz=2.45e9,
        Dmax=2.0, mcells_per_s=1.0,
        diagnostics={"s11_all_ports": [np.full(5, 0.5 + 0j)] * len(prep.sim.ports)})

designer.run_prepared_multi_patch_3d = fake_run
mods["multi_patch_array"].main(["--device", "cpu", "--outdir", out])

inv = mods["inverse_miniaturized_patch"]
real = inv.prepare_patch_inverse

def stub(params, **kw):
    kw.update(mesh_divisor=8.0, box_mm=(80.0, 80.0, 40.0), sub_mm=50.0,
              substrate_cells=2)
    prob = real(params, **kw)
    spec = types.SimpleNamespace(freq_hz=np.linspace(2.3e9, 2.6e9, 7),
                                 s11=np.full(7, 0.2 + 0j))
    prob.validate = lambda rho, pattern=False: dict(
        spectra=spec, f_res_hz=2.45e9, s11_db=-14.0)
    prob.optimize = lambda **kw: types.SimpleNamespace(
        rho=np.full(prob.region.shape, 0.6, np.float32), history=[0.2, 0.1])
    return prob

inv.prepare_patch_inverse = stub
inv.main(["--quick", "--device", "cpu", "--outdir", out])
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "fdtd_solver_antennas_tpu",
                                       "matplotlib")
                and sys.modules[m] is not None)
print("LEAKED", leaked)
"""


def test_scripts_run_with_jax_and_matplotlib_blocked(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED, str(tmp_path), ",".join(SCRIPTS)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    for name in SCRIPTS:
        assert f"HELP {name} 0" in lines
    for png in ("array_scene.png", "array_pattern.png",
                "inverse_miniaturized_patch.png"):
        assert (f"Not drawn: {tmp_path / png} (matplotlib is not "
                "installed)") in lines
        assert not (tmp_path / png).exists()
    assert "f_res 2.450 GHz, Dmax 3.0 dBi, 1 Mcells/s" in lines
    assert any(ln.startswith("validated optimized design: resonance 2.450 "
                             "GHz (target miss 0.00%), S11 -14.0 dB")
               for ln in lines)
    assert "LEAKED []" in lines


# ---------------------------------------------------------------------------
# checkpoint_resume
# ---------------------------------------------------------------------------

def test_checkpoint_resume_matches_straight_run_and_jax(tmp_path, monkeypatch,
                                                        capsys):
    """Segments of 445 and 1,335 steps (the energy criterion of 1e-4 is
    not met so early): the resumed run bit-equal to the straight one; the
    JAX package's save, load and resume at the same budgets agree."""
    real = checkpoint_resume.prepare_patch_fixed
    cap = {4000: 445, 12_000: 1335}

    def prepare(params, **kw):
        return real(params, **{**kw, "n_steps_max": cap[kw["n_steps_max"]]})

    seen = {}
    compare = checkpoint_resume.compare_runs

    def kept(resumed, straight):
        seen.update(resumed=resumed, straight=straight)
        return compare(resumed, straight)

    monkeypatch.setattr(checkpoint_resume, "prepare_patch_fixed", prepare)
    monkeypatch.setattr(checkpoint_resume, "compare_runs", kept)
    checkpoint_resume.main(["--device", "cpu", "--outdir", str(tmp_path)])
    text = capsys.readouterr().out
    path = tmp_path / "patch_ckpt.npz"
    assert f"checkpointed at step 445 → {path}" in text
    assert "resumed and finished at step 1335" in text
    assert "bit-equal: True" in text
    # the JAX package's sequence from the same file it would write
    params = JParams.from_user_units(**CANON)
    jout = jprepare_fixed(params, n_steps_max=445,
                          end_criteria=1e-30).sim.run()
    jckpt.save_state(tmp_path / "jax_ckpt.npz", jout)
    jres = jprepare_fixed(params, n_steps_max=1335).sim.run(
        resume_state=jckpt.load_state(tmp_path / "jax_ckpt.npz"))
    ours = seen["resumed"]
    assert int(ours["steps"]) == int(jres["steps"]) == 1335
    for a, b in zip(ours["fields"], seen["straight"]["fields"], strict=True):
        assert torch.equal(a, b)
    for key in ("uf", "if_", "e_ratio"):
        _close(ours[key], jres[key], key)


# ---------------------------------------------------------------------------
# design_sweep
# ---------------------------------------------------------------------------

def test_design_sweep_matches_jax(monkeypatch, capsys):
    """The three variants cut to one chunk: steps, port V and I spectra
    against the JAX package's vmapped XLA run, and one dip line a
    variant at the spectrum's minimum."""
    seen = {}
    prepare = design_sweep.prepare_patch_geometry_sweep
    run = design_sweep.run_patch_geometry_sweep

    def cut(variants, **kw):
        seen["prep"] = prepare(variants, **{**kw, "n_steps_max": 300})
        return seen["prep"]

    def kept(prep, **kw):
        seen["res"] = run(prep, **kw)
        return seen["res"]

    monkeypatch.setattr(design_sweep, "prepare_patch_geometry_sweep", cut)
    monkeypatch.setattr(design_sweep, "run_patch_geometry_sweep", kept)
    design_sweep.main(["--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    prep, res = seen["prep"], seen["res"]
    jvariants = [JParams.from_user_units(frequency_ghz=2.45, er=4.3, h_mm=1.6,
                                         L_mm=L, W_mm=W)
                 for L, W in design_sweep.GEOMETRIES_MM]
    jprep = jsweep.prepare_patch_geometry_sweep(jvariants, n_steps_max=300,
                                                use_pallas=False)
    assert jprep.ok, jprep.message
    jout, _, _ = jsweep._run_batched(jprep)
    assert prep.sim.grid.shape == jprep.sim.grid.shape
    np.testing.assert_array_equal(res.steps, np.asarray(jout["steps"]))
    jspectra = jsweep._batched_port_spectra(jprep, jout)
    dips = [ln for ln in lines if " mm → dip " in ln]
    assert len(dips) == 3
    for b, (sp, jsp) in enumerate(zip(res.spectra, jspectra)):
        _close(sp.uf, jsp.uf, f"variant {b} uf")
        _close(sp.if_, jsp.if_, f"variant {b} if_")
        db = 20 * np.log10(np.abs(jsp.s11) + 1e-30)
        i = int(np.argmin(db))
        L, W = design_sweep.GEOMETRIES_MM[b]
        assert dips[b].startswith(f"L={L:.1f} W={W:.1f} mm → dip ")
        assert dips[b].endswith(f"at {jsp.freq_hz[i] / 1e9:.3f} GHz")
