"""The port's adjoint inverse design against the JAX package's, on the CPU.

Both packages prepare ``tests/test_inverse.py``'s problem (2.45 GHz FR-4,
mesh λ/8, fc = f0, an 80×80×40 mm box: a 27×21×16 grid, a 20×12 px
design region, 1,029 differentiable steps in 21 checkpointed chunks of
50, a validate cap of 4,000 steps) from the same inputs; densities come
from a seeded NumPy generator. The port runs on the CPU.

- ``overlay_coeffs`` is bit-equal to the JAX package's at ρ ≡ 0, ρ ≡ 1
  and a seeded ρ, and ρ ≡ 1 is the voxelizer's metal sheet;
- the exposed step (``ops.fdtd.ExposedStep``) after 200 steps matches the
  JAX package's exposed XLA step under MUR, PEC and PML_4, fields, ψ and
  probes, at the north-star tolerance (rtol 2e-4, atol 1e-5·max|ref|);
- S11 (MUR, and PML_4) and the loss match at rtol 1e-3 (S11 is a
  quotient of two DFT sums, as in ROADMAP's S-matrix item), the gradient
  within 1e-3 of max|g_jax|; the same for the broadside objective, whose
  traced far field matches the JAX twin at 2e-4 and the port's
  ``nf2ff_transform`` at 2e-3;
- ``validate`` on the plain twins stops where the JAX package's does,
  with its resonance, dip and (``pattern=True``) broadside directivity,
  Dmax and realized gain at 1e-3, puts the base coefficients back bit for
  bit, and at ρ ≡ 1 runs the metal-patch scene bit for bit;
- the ``n_steps`` refusal and the CLI's ``inverse`` (``--device cpu``).

Marked ``slow``, as the JAX package marks its own: the finite-difference
checks of both gradients, and two ``optimize`` iterations held to the JAX
package's ``optimize`` (optax) history.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fdtd_solver_antennas_tpu.models.params import PatchAntennaParams as JParams
from fdtd_solver_antennas_tpu.ops.fdtd import _make_run_fn
from fdtd_solver_antennas_tpu.physics import ETA0
from fdtd_solver_antennas_tpu.solvers import inverse as jinv

from fdtd_solver_antennas_tpu_torch.models.params import PatchAntennaParams
from fdtd_solver_antennas_tpu_torch.models.scene import Scene
from fdtd_solver_antennas_tpu_torch.ops.fdtd import (
    ExposedStep,
    build_simulation,
    make_single_step,
)
from fdtd_solver_antennas_tpu_torch.physics import substrate_conductivity
from fdtd_solver_antennas_tpu_torch.post.nf2ff import nf2ff_transform
from fdtd_solver_antennas_tpu_torch.post.ports import port_spectra
from fdtd_solver_antennas_tpu_torch.solvers import inverse

RTOL = 2e-4
QUOTIENT_RTOL = 1e-3  # S11, the loss and validate's figures
GRAD_TOL = 1e-3  # max|g − g_jax| ≤ GRAD_TOL · max|g_jax|
THREADS = 2  # PyTorch intra-op threads while this file runs
USER = dict(frequency_ghz=2.45, er=4.3, h_mm=1.6, loss_tangent=0.02)
PROBLEM = dict(mesh_divisor=8.0, fc_hz=2.45e9, box_mm=(80.0, 80.0, 40.0),
               sub_mm=50.0, substrate_cells=2, n_steps_max_validate=4000)
SHORT_CAP = 1000  # two chunks: the bit-for-bit checks of a validate run


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Test workers share the cores (pytest-xdist); PyTorch's default of
    one intra-op thread per core would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(n)


def _close(a, b, rtol=RTOL):
    a = a.detach().numpy() if torch.is_tensor(a) else np.asarray(a)
    b = np.asarray(b)
    atol = 1e-5 * max(float(np.abs(b).max()), 1e-20)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


def _grad_close(g, g_jax):
    g, g_jax = np.asarray(g), np.asarray(g_jax)
    assert np.isfinite(g).all()
    err = float(np.abs(g - g_jax).max())
    assert err <= GRAD_TOL * float(np.abs(g_jax).max()), err


def _prepare(**kw):
    """The problem through both packages: ``(port, jax)``."""
    port = inverse.prepare_patch_inverse(
        PatchAntennaParams.from_user_units(**USER), device="cpu",
        **{**PROBLEM, **kw})
    return port, jinv.prepare_patch_inverse(
        JParams.from_user_units(**USER), **{**PROBLEM, **kw})


def _seeded_rho(shape, seed=7):
    """``tests/test_inverse.py``'s density: 0.5 + 0.1·N(0, 1), clipped."""
    rng = np.random.default_rng(seed)
    return np.clip(0.5 + 0.1 * rng.standard_normal(shape), 0, 1).astype(
        np.float32)


@pytest.fixture(scope="module")
def problems():
    return _prepare()


@pytest.fixture(scope="module")
def band(problems):
    """S11, the loss and its gradient at the seeded density, both packages."""
    tp, jp = problems
    rho = _seeded_rho(tp.region.shape)
    r = torch.tensor(rho, requires_grad=True)
    ri = tp.s11_fn(r)
    loss = torch.mean(ri[0] ** 2 + ri[1] ** 2)
    loss.backward()

    def jloss(x):
        s = jp.s11_fn(x)
        return jnp.mean(s[0] ** 2 + s[1] ** 2), s

    (jl, jri), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jnp.asarray(rho))
    return dict(rho=rho, s11=ri.detach(), loss=loss.item(), grad=r.grad,
                jax_s11=np.asarray(jri), jax_loss=float(jl),
                jax_grad=np.asarray(jg))


def test_prepare_matches_jax(problems):
    tp, jp = problems
    assert dataclasses.astuple(tp.region) == dataclasses.astuple(jp.region)
    assert tp.n_steps == jp.n_steps == 1029 and tp.remat_chunk == 50
    assert tp.region.shape == (20, 12)
    np.testing.assert_array_equal(tp.freqs_hz, jp.freqs_hz)
    ts, js = tp.sim, jp.sim
    assert ts.grid.shape == js.grid.shape == (27, 21, 16)
    for ax in "xyz":
        np.testing.assert_array_equal(ts.grid.lines[ax], js.grid.lines[ax])
    assert ts.dt == js.dt and ts.probe_decim == js.probe_decim == 1
    assert ts.n_source_steps == js.n_source_steps
    np.testing.assert_array_equal(ts.waveform, np.asarray(js.waveform))
    for k, v in js._coeffs_np.items():
        np.testing.assert_array_equal(ts.coeffs[k].numpy(), v, err_msg=k)


@pytest.mark.parametrize("kind", ["zeros", "ones", "seeded"])
def test_overlay_matches_jax_bit_for_bit(problems, kind):
    tp, jp = problems
    shape = tp.region.shape
    rho = {"zeros": np.zeros(shape, np.float32),
           "ones": np.ones(shape, np.float32),
           "seeded": _seeded_rho(shape, seed=3)}[kind]
    got = tp.overlay_coeffs(torch.from_numpy(rho))
    want = jp.overlay_coeffs(jnp.asarray(rho))
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]),
                                      err_msg=name)
    if kind == "zeros":  # the identity, on the base's own values
        for name, base in tp.sim.coeffs.items():
            assert torch.equal(got[name], base), name


def _metal_patch_sim(prob, cfg=None):
    """``tests/test_inverse.py``'s scene with the region stamped as a
    metal sheet, on the problem's grid and controls."""
    r, sim = prob.region, prob.sim
    P = PatchAntennaParams.from_user_units(**USER)
    f0, h, half = P.frequency_hz, P.h_m * 1e3, PROBLEM["sub_mm"] / 2
    kappa = substrate_conductivity(f0, P.eps_r, P.loss_tangent)
    scene = Scene()
    scene.add_material_box("substrate", P.eps_r, kappa, [-half, -half, 0.0],
                           [half, half, h], priority=0)
    scene.add_metal_box("gnd", [-half, -half, 0.0], [half, half, 0.0],
                        priority=10)
    scene.add_metal_box("patch", [r.x_mm[0], r.y_mm[0], h],
                        [r.x_mm[1], r.y_mm[1], h], priority=10)
    scene.add_lumped_port(1, 50.0, [-6.0, 0.0, 0.0], [-6.0, 0.0, h],
                          direction="z", excite=1.0)
    return build_simulation(
        scene, sim.grid, f0=f0, fc=sim.fc, cfg=cfg or sim.cfg, device="cpu",
        port_freqs_hz=sim.port_freqs_hz, nf_freqs_hz=sim.nf_freqs_hz)


def test_full_density_is_the_metal_stamp(problems):
    """ρ ≡ 1 equals the voxelizer stamping a metal sheet over the region:
    the same staggered cells zeroed, nothing else touched."""
    tp, _ = problems
    ref = _metal_patch_sim(tp)
    got = tp.overlay_coeffs(torch.ones(tp.region.shape))
    for name in ("ca_ex", "cb_ex", "ca_ey", "cb_ey", "ca_ez", "cb_ez"):
        np.testing.assert_array_equal(got[name].numpy(),
                                      ref.coeffs[name].numpy(), err_msg=name)


@pytest.mark.parametrize("boundary", ["MUR", "PEC", "PML_4"])
def test_exposed_step_matches_jax(problems, boundary):
    """200 steps of the exposed step on the seeded overlay, against the
    JAX package's exposed XLA step under ``lax.scan``: the fields, ψ, and
    every step's port V and I; the face samples of the last step."""
    tp, jp = problems if boundary == "MUR" else _prepare(boundary=boundary)
    rho = _seeded_rho(tp.region.shape, seed=5)
    n_steps = 200

    j_step, j_init = _make_run_fn(jp.sim, *jp.sim._aux, _expose_step=True)
    j_coeffs = jp.overlay_coeffs(jnp.asarray(rho))
    j_wf = jnp.asarray(jp.sim.waveform)

    @jax.jit
    def j_run(coeffs):
        def body(carry, n):
            carry, pr = j_step(carry, n, coeffs, j_wf)
            return carry, (pr["v"], pr["i"])

        carry0 = j_init(coeffs, len(jp.sim.nf_freqs_hz),
                        len(jp.sim.port_freqs_hz))
        carry, vi = jax.lax.scan(body, carry0, jnp.arange(n_steps - 1))
        carry, last = j_step(carry, jnp.int32(n_steps - 1), coeffs, j_wf)
        return carry, vi, last

    j_carry, (j_v, j_i), j_last = j_run(j_coeffs)

    step = ExposedStep(tp.sim)
    coeffs = tp.overlay_coeffs(torch.from_numpy(rho))
    wf = torch.from_numpy(np.asarray(tp.sim.waveform, np.float32))
    carry = step.init_carry(coeffs, 1, len(tp.sim.port_freqs_hz))
    vs, is_ = [], []
    with torch.no_grad():
        for n in range(n_steps):
            carry, probes = step.field_step(carry, n, coeffs, wf)
            vs.append(probes["v"])
            is_.append(probes["i"])
    for i, (a, b) in enumerate(zip(carry["fields"], j_carry["fields"],
                                   strict=True)):
        assert float(np.abs(np.asarray(b)).max()) > 0, i
        _close(a, b)
    assert set(carry["psi_e"]) == set(j_carry["psi_e"])
    for grp in ("psi_e", "psi_h"):
        for k, v in j_carry[grp].items():
            _close(carry[grp][k], v)
    _close(torch.stack(vs[:-1]), j_v)
    _close(torch.stack(is_[:-1]), j_i)
    _close(probes["v"], j_last["v"])
    _close(probes["i"], j_last["i"])
    for key in ("faces_e", "faces_h"):
        assert len(probes[key]) == len(j_last[key]) == 6
        for a, b in zip(probes[key], j_last[key], strict=True):
            assert a.shape == b.shape
            _close(a, b)


def test_make_single_step_contract(problems):
    """``make_single_step`` gives the step and its arguments, as the JAX
    package's does; the step leaves its inputs as they were."""
    tp, _ = problems
    step_fn, (carry, n, coeffs, wf) = make_single_step(tp.sim)
    assert n == 0 and coeffs is tp.sim.coeffs
    assert set(carry) == {"fields", "uf", "if_", "nf_e", "nf_h", "psi_e",
                          "psi_h", "n", "e_max", "e_ratio", "done"}
    new, probes = step_fn(carry, 0, coeffs, wf)
    assert all(float(f.abs().max()) == 0.0 for f in carry["fields"])
    assert float(new["fields"][2].abs().max()) > 0.0  # the z-directed feed
    assert probes["v"].shape == probes["i"].shape == (1,)


def test_s11_and_loss_match_jax(band):
    _close(band["s11"], band["jax_s11"], rtol=QUOTIENT_RTOL)
    assert band["loss"] == pytest.approx(band["jax_loss"], rel=QUOTIENT_RTOL)


def test_s11_under_pml_matches_jax():
    """The forward under PML_4: the twelve ψ through the checkpointed
    chunks."""
    tp, jp = _prepare(boundary="PML_4")
    rho = _seeded_rho(tp.region.shape, seed=13)
    got = tp.s11(rho)
    want = jp.s11(rho)
    _close(np.stack([got.real, got.imag]), np.stack([want.real, want.imag]),
           rtol=QUOTIENT_RTOL)


def test_weighted_loss_matches_jax(problems, band):
    """The weighted band loss on the same S11 values (the forward
    replaced by the fixture's, so no second FDTD run)."""
    tp, jp = problems
    w = np.array([0.5, 1.0, 2.0, 1.0, 0.5], np.float32)
    tstub = dataclasses.replace(tp, _s11_fn=lambda _r: band["s11"])
    jstub = dataclasses.replace(jp, _s11_fn=lambda _r: jnp.asarray(band["s11"]))
    got = float(tstub.loss(band["rho"], weights=w))
    want = float(jstub.loss(band["rho"], weights=jnp.asarray(w)))
    assert got == pytest.approx(want, rel=1e-6)
    assert got != pytest.approx(band["loss"], rel=1e-3)


def test_gradient_matches_jax(band):
    _grad_close(band["grad"].numpy(), band["jax_grad"])


def _random_faces(faces, seed):
    """Face DFT sums of an outward plane wave per face (H = n̂ × E / η0,
    so the Poynting flux is positive), as ``tests/test_inverse.py`` makes
    them: per face the (2, 2, nu, nv) real pair and (1, 2, nu, nv)
    complex."""
    rng = np.random.default_rng(seed)
    face_e, face_h, nf_e, nf_h = [], [], [], []
    for f in faces:
        nu, nv = f.u1 - f.u0, f.v1 - f.v0
        ae = rng.standard_normal((2, 2, nu, nv)).astype(np.float32)
        uh, vh = np.zeros(3), np.zeros(3)
        uh[f.u_axis], vh[f.v_axis] = 1.0, 1.0
        s = float(np.dot(np.cross(uh, vh), f.normal))
        ah = np.stack([-s * ae[:, 1] / ETA0, s * ae[:, 0] / ETA0],
                      axis=1).astype(np.float32)
        face_e.append(ae)
        face_h.append(ah)
        nf_e.append((ae[0] + 1j * ae[1])[None])
        nf_h.append((ah[0] + 1j * ah[1])[None])
    return face_e, face_h, nf_e, nf_h


def test_directivity_ri_matches_jax_and_nf2ff(problems):
    tp, _ = problems
    sim = tp.sim
    theta, phi = np.arange(0.0, 91.0, 15.0), np.array([0.0, 90.0])
    face_e, face_h, nf_e, nf_h = _random_faces(sim.faces, seed=3)
    consts = inverse._pattern_consts(sim.faces, theta, phi, tp.f0, "cpu")
    D, p_rad = inverse._directivity_ri(
        consts, [torch.from_numpy(a) for a in face_e],
        [torch.from_numpy(a) for a in face_h])
    jD, jp_rad = jinv._directivity_ri(
        jinv._pattern_consts(sim.faces, theta, phi, tp.f0),
        [jnp.asarray(a) for a in face_e], [jnp.asarray(a) for a in face_h])
    assert float(p_rad) > 0.0
    _close(D, jD)
    _close(p_rad, jp_rad)
    ff = nf2ff_transform(sim.faces, nf_e, nf_h, sim.dft_dt,
                         np.array([tp.f0]), theta, phi, device="cpu")
    np.testing.assert_allclose(D.numpy().reshape(len(theta), len(phi)),
                               ff.directivity[0], rtol=2e-3)


def test_broadside_gain_loss_and_gradient_match_jax(problems):
    tp, jp = problems
    rho = _seeded_rho(tp.region.shape, seed=11)
    r = torch.tensor(rho, requires_grad=True)
    loss = tp.broadside_gain_loss(r)
    loss.backward()
    jl, jg = jax.jit(jax.value_and_grad(jp.broadside_gain_loss))(
        jnp.asarray(rho))
    assert loss.item() < 0.0
    assert loss.item() == pytest.approx(float(jl), rel=QUOTIENT_RTOL)
    _grad_close(r.grad.numpy(), jg)


def test_validate_matches_jax_and_restores_the_base(problems, band):
    """The thresholded seeded density through the standard run loop to
    its stop (the plain twins here, K1 on the card)."""
    tp, jp = problems
    base = {k: v.clone() for k, v in tp.sim.coeffs.items()}
    got = tp.validate(band["rho"], pattern=True)
    want = jp.validate(band["rho"], pattern=True)
    np.testing.assert_array_equal(got["rho_binary"], want["rho_binary"])
    assert 0 < got["rho_binary"].sum() < got["rho_binary"].size
    assert got["steps"] == want["steps"]
    assert got["f_res_hz"] == pytest.approx(want["f_res_hz"], rel=QUOTIENT_RTOL)
    assert want["s11_db"] is not None
    assert got["s11_db"] == pytest.approx(want["s11_db"], rel=QUOTIENT_RTOL)
    for key in ("broadside_directivity", "Dmax", "broadside_realized_gain_dbi"):
        assert got[key] == pytest.approx(want[key], rel=QUOTIENT_RTOL), key
    assert got["Dmax"] >= got["broadside_directivity"] > 0.0
    for k, v in base.items():
        assert torch.equal(tp.sim.coeffs[k], v), k
    # the tensors the kernels hold by address are still the dict's
    ops = tp.sim.operands
    for m, c in enumerate(("ex", "ey", "ez")):
        assert ops.ca[m] is tp.sim.coeffs["ca_" + c]
        assert ops.cb[m] is tp.sim.coeffs["cb_" + c]


def test_validate_full_density_runs_the_metal_patch(problems):
    """ρ ≡ 1 through ``validate`` == the metal-patch scene built fresh and
    run, bit for bit (two chunks)."""
    tp, _ = problems
    short = dataclasses.replace(tp.sim.cfg, n_steps_max=SHORT_CAP)
    tp = dataclasses.replace(tp, sim=dataclasses.replace(tp.sim, cfg=short))
    got = tp.validate(np.ones(tp.region.shape, np.float32))
    out = _metal_patch_sim(tp, short).run()
    assert got["steps"] == out["steps"] == SHORT_CAP
    want = port_spectra(tp.sim.port_freqs_hz, out["uf"][0], out["if_"][0],
                        tp.sim.dft_dt, z_ref=50.0)
    np.testing.assert_array_equal(got["spectra"].uf, want.uf)
    np.testing.assert_array_equal(got["spectra"].if_, want.if_)


def test_n_steps_shorter_than_the_source_is_refused():
    P = PatchAntennaParams.from_user_units(**USER)
    with pytest.raises(ValueError, match="shorter than the Gaussian source"):
        inverse.prepare_patch_inverse(P, device="cpu", n_steps=10, **PROBLEM)
    with pytest.raises(ValueError, match="shorter than the Gaussian source"):
        jinv.prepare_patch_inverse(JParams.from_user_units(**USER),
                                   n_steps=10, **PROBLEM)


def test_cli_inverse_on_the_cpu(problems, tmp_path, monkeypatch, capsys):
    """``inverse --iters 1 --device cpu``: the CLI's band and mesh reach
    the preparation (here the test problem, its validate cap cut to two
    chunks), one Adam step runs, the binary design is validated, and the
    summary and ``inverse_design.npz`` carry the JAX CLI's keys."""
    from fdtd_solver_antennas_tpu_torch.__main__ import main

    seen = {}
    real = inverse.prepare_patch_inverse

    def small(params, **kw):
        seen.update(kw)
        return real(params, freqs_hz=kw["freqs_hz"], device=kw["device"],
                    **{**PROBLEM, "n_steps_max_validate": SHORT_CAP})

    monkeypatch.setattr(inverse, "prepare_patch_inverse", small)
    main(["inverse", "--frequency-ghz", "2.45", "--er", "4.3", "--h-mm", "1.6",
          "--loss-tangent", "0.02", "--iters", "1", "--mesh-divisor", "8",
          "--device", "cpu", "--outdir", str(tmp_path)])
    assert seen["mesh_divisor"] == 8.0 and seen["device"] == "cpu"
    np.testing.assert_allclose(seen["freqs_hz"],
                               np.linspace(0.9, 1.1, 5) * 2.45e9)
    text = capsys.readouterr().out
    assert "Design region 20×12 px" in text and "iter 1/1  loss=" in text
    summary = json.loads(text[text.index("{"):text.rindex("}") + 1])
    assert summary.keys() == {
        "loss_initial", "loss_final", "soft_s11_db_band",
        "validated_f_res_ghz", "validated_s11_min_db", "validated_steps",
        "optimize_wall_s", "device"}
    assert summary["device"] == "cpu" and summary["validated_steps"] == SHORT_CAP
    assert len(summary["soft_s11_db_band"]) == 5
    with np.load(tmp_path / "inverse_design.npz") as z:
        assert sorted(z.files) == sorted([
            "rho", "rho_binary", "loss_history", "freqs_hz", "s11",
            "validated_freq_hz", "validated_s11", "region_x_mm",
            "region_y_mm"])
        assert z["rho"].shape == z["rho_binary"].shape == (20, 12)
        assert z["loss_history"].tolist() == [summary["loss_initial"]]
    png = tmp_path / "inverse_design.png"  # the JAX CLI's figure
    assert png.stat().st_size > 0 and f"Saved: {png}" in text


def _fd_check(loss_fn, rho):
    """``tests/test_inverse.py``'s criterion at the largest-|g| pixel:
    central differences at ε = 5e-2 within 5%."""
    r = torch.tensor(rho, requires_grad=True)
    loss_fn(r).backward()
    g = r.grad.numpy()
    assert np.isfinite(g).all()
    i, j = np.unravel_index(np.argmax(np.abs(g)), g.shape)
    eps = 5e-2
    with torch.no_grad():
        plus, minus = rho.copy(), rho.copy()
        plus[i, j] += eps
        minus[i, j] -= eps
        fd = (float(loss_fn(plus)) - float(loss_fn(minus))) / (2 * eps)
    assert fd != 0.0
    assert abs(fd - g[i, j]) <= 0.05 * abs(fd) + 1e-8, (fd, g[i, j])


@pytest.mark.slow
def test_gradient_matches_finite_difference(problems):
    tp, _ = problems
    _fd_check(tp.loss, _seeded_rho(tp.region.shape, seed=7))


@pytest.mark.slow
def test_broadside_gradient_matches_finite_difference(problems):
    tp, _ = problems
    _fd_check(tp.broadside_gain_loss, _seeded_rho(tp.region.shape, seed=11))


@pytest.mark.slow
def test_optimize_matches_jax(problems):
    """Two Adam iterations (torch.optim.Adam against optax.adam) from the
    default density: the loss history and the final density at 1e-3."""
    tp, jp = problems
    seen = []
    got = tp.optimize(n_iters=2, lr=0.1,
                      callback=lambda it, v, r: seen.append((it, v, r.shape)))
    want = jp.optimize(n_iters=2, lr=0.1)
    assert [s[0] for s in seen] == [0, 1]
    assert all(s[2] == tp.region.shape for s in seen)
    np.testing.assert_allclose(got.history, want.history, rtol=QUOTIENT_RTOL)
    _close(got.rho, want.rho, rtol=QUOTIENT_RTOL)
    _close(np.stack([got.s11.real, got.s11.imag]),
           np.stack([want.s11.real, want.s11.imag]), rtol=QUOTIENT_RTOL)
    assert got.history[-1] < got.history[0]
