"""Two-element patch array through the headless designer: build the scene,
render a preview, run the multi-patch FDTD, save the 3D pattern.

Counterpart of ``examples/multi_patch_array.py``, with its scene, controls
and lines. On the card the run steps in chunk mode (K1's
``chunk_steps``). The figures need matplotlib; without it each is named
on a ``Not drawn:`` line and the run goes on.

Usage:
    python -m fdtd_solver_antennas_tpu_torch.examples.multi_patch_array [--device cuda] [--outdir outputs]
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from ..frontends.designer import MultiPatchScene
from ..models.params import PatchAntennaParams
from ..solvers.microstrip import FeedDirection
from ..utils.backend import ensure_backend
from ..viz import save_figure


def build_scene(*, device="cuda", mesh_quality: int = 2,
                phi_step_deg: float = 10.0,
                theta_step_deg: float = 5.0) -> MultiPatchScene:
    """Two canonical FR-4 patches at x = ∓60 mm, the second fed from +X."""
    params = PatchAntennaParams.from_user_units(
        frequency_ghz=2.45, er=4.3, h_mm=1.6, loss_tangent=0.02)
    scene = MultiPatchScene(device=device)
    scene.add_patch(params, center_x_m=-0.06)
    scene.add_patch(params, center_x_m=0.06,
                    feed_direction=FeedDirection.POS_X)
    scene.controls.mesh_quality = mesh_quality
    scene.controls.phi_step_deg = phi_step_deg
    scene.controls.theta_step_deg = theta_step_deg
    return scene


def simulate_scene(scene: MultiPatchScene, outdir, preview: str):
    """The preview into ``outdir``, then ``simulate(verbose=1,
    log_cb=print)``, as the designer scripts run it; the solver result."""
    outdir = Path(outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    save_figure(outdir / preview, scene.render_preview, dpi=140)
    res = scene.simulate(verbose=1, log_cb=print)
    assert res.ok, res.message
    return res


def summary(res) -> str:
    """The designer scripts' result line (without the port count)."""
    return (f"f_res {res.f_res_hz / 1e9:.3f} GHz, Dmax "
            f"{10 * np.log10(res.Dmax):.1f} dBi, "
            f"{res.mcells_per_s:.0f} Mcells/s")


def save_pattern(res, path) -> None:
    """The run's full-sphere pattern as a 3D surface (dBi colours)."""

    def draw():
        from ..viz.plotting import plot_3d_pattern_from_grid

        return plot_3d_pattern_from_grid(
            res.theta, res.phi, 10 ** (np.asarray(res.intensity) / 10.0),
            colors_db=res.intensity,
        )

    save_figure(path, draw, dpi=140)


def multi_patch_array(*, outdir="outputs", device="cuda", **scene_kw):
    """The JAX script's run of :func:`build_scene`; the solver result."""
    res = simulate_scene(build_scene(device=device, **scene_kw), outdir,
                         "array_scene.png")
    print(summary(res))
    save_pattern(res, Path(outdir) / "array_pattern.png")
    return res


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--outdir", type=str, default="outputs")
    ap.add_argument("--device", type=str, default="cuda",
                    help="'cuda' runs the CUDA kernels, 'cpu' their plain "
                         "PyTorch twins")
    args = ap.parse_args(argv)
    ensure_backend(args.device)
    multi_patch_array(outdir=args.outdir, device=args.device)


if __name__ == "__main__":
    main()
