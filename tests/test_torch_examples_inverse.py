"""The port's inverse-design scripts against the JAX package's calls on
the CPU.

``examples/inverse_miniaturized_patch.py`` and
``examples/inverse_broadside_gain.py`` have counterparts in the port's
``examples/``. Here each runs with its preparation cut to
``tests/test_torch_inverse.py``'s small problem (mesh λ/8, fc = f0, an
80×80×40 mm box, a validate cap of 4,000 steps; the script's own design
region and loss band kept) and one Adam iteration:

- the grid, design pixels and differentiable steps it prints are the JAX
  package's for the same call, and for the broadside script the seed
  density is the JAX formula's on the JAX grid;
- the baseline's validation and the validation of the port's optimized
  density agree with the JAX package's ``validate`` of the same densities
  (steps equal; resonance, dip and, with ``pattern=True``, broadside
  realized gain at rtol 1e-3, the tolerance ``tests/test_torch_inverse.py``
  holds validate's figures to);
- the figure is written (matplotlib is installed here).

Through ``main(argv)`` on ``--device cpu --quick``, with the runs stubbed,
each script prints the JAX script's lines and its figure; a run without
matplotlib is in ``tests/test_torch_examples.py``. Marked ``slow``: the
first Adam iteration's loss against the JAX package's ``optimize``
(optax) for both objectives.
"""

import re
import types

import numpy as np
import pytest
import torch

from fdtd_solver_antennas_tpu.models.params import PatchAntennaParams as JParams
from fdtd_solver_antennas_tpu.solvers import inverse as jinv

from fdtd_solver_antennas_tpu_torch.examples import (
    inverse_broadside_gain,
    inverse_miniaturized_patch,
)

THREADS = 2  # PyTorch intra-op threads while this file runs
QUOTIENT_RTOL = 1e-3  # validate's resonance, dip and gain
USER = dict(frequency_ghz=2.45, er=4.3, h_mm=1.6, loss_tangent=0.02)
SMALL = dict(mesh_divisor=8.0, fc_hz=2.45e9, box_mm=(80.0, 80.0, 40.0),
             sub_mm=50.0, substrate_cells=2, n_steps_max_validate=4000)
SCRIPTS = {"miniaturized": inverse_miniaturized_patch,
           "broadside": inverse_broadside_gain}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Test workers share the cores (pytest-xdist); PyTorch's default of
    one intra-op thread per core would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(n)


def _small(mod, monkeypatch, calls):
    """Cut the script's preparation to the small problem; record each
    call's keywords (as the JAX package would take them)."""
    real = mod.prepare_patch_inverse

    def prepare(params, **kw):
        kw.update(SMALL)
        calls.append({k: v for k, v in kw.items() if k != "device"})
        return real(params, **kw)

    monkeypatch.setattr(mod, "prepare_patch_inverse", prepare)


def _run(name, monkeypatch, tmp_path, capsys):
    mod, calls = SCRIPTS[name], []
    _small(mod, monkeypatch, calls)
    fn = (mod.inverse_miniaturized_patch if name == "miniaturized"
          else mod.inverse_broadside_gain)
    out = fn(iters=1, outdir=tmp_path, device="cpu", check_headline=False)
    jprob = jinv.prepare_patch_inverse(JParams.from_user_units(**USER),
                                       **calls[0])
    return out, jprob, capsys.readouterr().out.splitlines()


def _same_validation(got, want, pattern=False):
    assert got["steps"] == want["steps"]
    np.testing.assert_array_equal(got["rho_binary"], want["rho_binary"])
    assert (got["s11_db"] is None) == (want["s11_db"] is None)
    keys = ["f_res_hz"] + (["s11_db"] if want["s11_db"] is not None else [])
    keys += ["broadside_realized_gain_dbi", "Dmax"] if pattern else []
    for k in keys:
        np.testing.assert_allclose(got[k], want[k], rtol=QUOTIENT_RTOL,
                                   err_msg=k)


def _header(jprob):
    return (f"grid {jprob.sim.grid.shape}, design pixels {jprob.region.shape}, "
            f"{jprob.n_steps} differentiable steps/iter")


def test_miniaturized_patch_matches_jax(monkeypatch, tmp_path, capsys):
    out, jprob, lines = _run("miniaturized", monkeypatch, tmp_path, capsys)
    assert lines[0] == ("closed-form patch: 37.6 × 29.1 mm; design region: "
                        "27.1 × 21.0 mm (52% of the footprint area)")
    assert lines[1] == _header(jprob)
    solid = np.ones(jprob.region.shape, np.float32)
    _same_validation(out["base"], jprob.validate(solid))
    assert lines[2].startswith("baseline (solid 52%-area patch): ")
    assert re.fullmatch(r"optimized 1 iterations in \d+s; loss \S+ → \S+",
                        lines[3])
    assert np.isfinite(out["result"].history).all()
    _same_validation(out["validated"], jprob.validate(out["result"].rho))
    assert lines[4].startswith("validated optimized design: ")
    png = tmp_path / "inverse_miniaturized_patch.png"
    assert lines[5] == f"Saved: {png}" and png.stat().st_size > 0
    assert lines[6].startswith("wall ") and lines[6].endswith("on cpu")


def test_broadside_gain_matches_jax(monkeypatch, tmp_path, capsys):
    out, jprob, lines = _run("broadside", monkeypatch, tmp_path, capsys)
    assert lines[0] == _header(jprob)
    # the seed: the JAX script's formula on the JAX package's grid
    r, g = jprob.region, jprob.sim.grid
    cx = 0.5 * (g.lines["x"][r.i0:r.i1] + g.lines["x"][r.i0 + 1:r.i1 + 1])
    cy = 0.5 * (g.lines["y"][r.j0:r.j1] + g.lines["y"][r.j0 + 1:r.j1 + 1])
    wx, wy = 37.6 / 2 * 0.88, 29.1 / 2 * 0.88
    seed = ((np.abs(cx)[:, None] <= wx)
            & (np.abs(cy)[None, :] <= wy)).astype(np.float32)
    np.testing.assert_array_equal(out["seed"], seed)
    assert lines[1].startswith("perturbed patch: 33.1 × 25.6 mm")
    _same_validation(out["base"], jprob.validate(seed, pattern=True),
                     pattern=True)
    assert lines[2].startswith("baseline (perturbed patch): ")
    assert re.fullmatch(r"optimized 1 iterations in \d+s; soft realized gain "
                        r"\S+ → \S+ \(linear\)", lines[3])
    _same_validation(out["validated"],
                     jprob.validate(out["result"].rho, pattern=True),
                     pattern=True)
    assert lines[4].startswith("validated optimized design: ")
    png = tmp_path / "inverse_broadside_gain.png"
    assert lines[5] == f"Saved: {png}" and png.stat().st_size > 0


def _stubbed(mod, monkeypatch, f_res, s11_db):
    """The small problem with ``validate`` and ``optimize`` stubbed: the
    script's plumbing, lines and figure without a run."""
    real = mod.prepare_patch_inverse

    def prepare(params, **kw):
        prob = real(params, **{**kw, **SMALL})
        spec = types.SimpleNamespace(freq_hz=np.linspace(2.3e9, 2.6e9, 7),
                                     s11=np.full(7, 0.2 + 0j))
        prob.validate = lambda rho, pattern=False: dict(
            spectra=spec, f_res_hz=f_res, s11_db=s11_db,
            broadside_realized_gain_dbi=-3.0 if rho.min() < 0.5 else 5.0)
        prob.optimize = lambda **kw: types.SimpleNamespace(
            rho=np.full(prob.region.shape, 0.6, np.float32),
            history=[-0.5, -1.5])
        return prob

    monkeypatch.setattr(mod, "prepare_patch_inverse", prepare)


@pytest.mark.parametrize("name", list(SCRIPTS))
@pytest.mark.parametrize("dip", [True, False])
def test_main_on_cpu_prints_the_jax_lines(name, dip, monkeypatch, tmp_path,
                                          capsys):
    """``main(["--quick", "--device", "cpu", ...])`` with the runs stubbed:
    a design with a dip below -10 dB and one without (find_resonance then
    reports the target and no dip)."""
    mod = SCRIPTS[name]
    _stubbed(mod, monkeypatch, 2.5e9 if dip else 2.45e9, -12.0 if dip else None)
    mod.main(["--quick", "--device", "cpu", "--outdir", str(tmp_path)])
    text = capsys.readouterr().out
    if name == "miniaturized":
        want = ("validated optimized design: resonance 2.500 GHz (target "
                "miss 2.04%), S11 -12.0 dB, metal fill 100%" if dip else
                "validated optimized design: no in-band resonance (no dip "
                "below -10 dB; f_res reported as the target), metal fill 100%")
        assert "optimized 8 iterations in 0s; loss -0.5000 → -1.5000" in text
    else:
        want = ("validated optimized design: " + (
            "resonance 2.500 GHz, S11(f_res) -12.0 dB" if dip
            else "no in-band resonance")
            + ", broadside realized gain at f0 5.00 dBi  (lift +8.00 dB)")
        assert ("optimized 6 iterations in 0s; soft realized gain 0.50 → "
                "1.50 (linear)") in text
    assert want in text.splitlines()
    png = tmp_path / f"inverse_{'miniaturized_patch' if name == 'miniaturized' else 'broadside_gain'}.png"
    assert f"Saved: {png}" in text
    assert "HEADLINE OK" not in text  # --quick skips the headline check


@pytest.mark.slow
@pytest.mark.parametrize("name", list(SCRIPTS))
def test_first_adam_iteration_matches_jax(name, monkeypatch, tmp_path, capsys):
    """One Adam iteration at the script's learning rate and sharpening:
    the loss it starts from against the JAX package's ``optimize``."""
    out, jprob, _lines = _run(name, monkeypatch, tmp_path, capsys)
    kw = dict(n_iters=1, lr=0.08, beta_sharpen=4.0)
    if name == "broadside":
        kw.update(rho0=np.clip(out["seed"], 0.02, 0.98),
                  objective="broadside_gain")
    jres = jprob.optimize(**kw)
    np.testing.assert_allclose(out["result"].history, jres.history,
                               rtol=QUOTIENT_RTOL)


@pytest.mark.slow
def test_miniaturized_baseline_at_the_script_mesh_matches_jax(capsys):
    """The miniaturized script's solid baseline at its own preparation
    (λ/18, the 0.72× region, a 48×44×36 grid, 12,000-step cap) through
    both packages' ``validate``: the same steps, resonance and dip. Both
    put the dip at f0 itself, so the JAX script's premise of a baseline
    more than 10% off target does not hold in either package at this
    preparation (~40 s)."""
    from fdtd_solver_antennas_tpu.physics import design_patch_for_frequency

    f0 = 2.45e9
    L_m, W_m, _ = design_patch_for_frequency(f0, 4.3, 1.6e-3)
    s = 0.72
    kw = dict(region_mm=(-W_m / 2 * 1e3 * s, W_m / 2 * 1e3 * s,
                         -L_m / 2 * 1e3 * s, L_m / 2 * 1e3 * s),
              freqs_hz=np.linspace(0.96 * f0, 1.04 * f0, 5),
              mesh_divisor=18.0, fc_hz=f0, n_steps_max_validate=12_000)
    prob = inverse_miniaturized_patch.prepare_patch_inverse(
        inverse_miniaturized_patch.PatchAntennaParams.from_user_units(**USER),
        device="cpu", **kw)
    jprob = jinv.prepare_patch_inverse(JParams.from_user_units(**USER), **kw)
    assert prob.sim.grid.shape == jprob.sim.grid.shape == (48, 44, 36)
    solid = np.ones(prob.region.shape, np.float32)
    got, want = prob.validate(solid), jprob.validate(solid)
    _same_validation(got, want)
    with capsys.disabled():
        print(f"\nbaseline: port {got['f_res_hz'] / 1e9:.4f} GHz "
              f"{got['s11_db']:.3f} dB, JAX {want['f_res_hz'] / 1e9:.4f} GHz "
              f"{want['s11_db']:.3f} dB, {want['steps']} steps")
