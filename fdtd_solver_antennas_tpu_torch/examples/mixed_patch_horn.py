"""Mixed patch + horn scene in one FDTD run.

Counterpart of ``examples/mixed_patch_horn.py``, with its scene, controls
and lines. A 2.45 GHz microstrip-fed patch next to a rotated pyramidal
horn, both excited in phase; the full-sphere far field of the combined
scene. At mesh quality 2 the grid is 141×201×152 (4.2M cells), past the
card's L2, so the run steps in stream mode: K2's march, T = 4, with a
``probe_gather`` each probe interval. Beside the JAX script's lines it
prints each port's S11 dip.

Usage:
    python -m fdtd_solver_antennas_tpu_torch.examples.mixed_patch_horn [--device cuda] [--outdir outputs]
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from ..frontends.designer import MultiPatchScene
from ..models.params import HornAntennaParams, PatchAntennaParams
from ..utils.backend import ensure_backend
from .multi_patch_array import save_pattern, simulate_scene, summary


def build_scene(*, device="cuda", mesh_quality: int = 2,
                phi_step_deg: float = 10.0,
                theta_step_deg: float = 5.0) -> MultiPatchScene:
    """The canonical FR-4 patch and a WR-340-like horn flaring to a
    150×110 mm aperture at x = 0.18 m, rotated 25° about z."""
    scene = MultiPatchScene(device=device)
    scene.add_patch(
        PatchAntennaParams.from_user_units(
            frequency_ghz=2.45, er=4.3, h_mm=1.6, loss_tangent=0.02
        )
    )
    scene.add_horn(
        HornAntennaParams.from_user_units(
            frequency_ghz=2.45, throat_a_mm=86.0, throat_b_mm=43.0,
            aperture_A_mm=150.0, aperture_B_mm=110.0, length_mm=60.0,
        ),
        center_x_m=0.18, rot_z_deg=25.0,
    )
    scene.controls.mesh_quality = mesh_quality
    scene.controls.phi_step_deg = phi_step_deg
    scene.controls.theta_step_deg = theta_step_deg
    return scene


def mixed_patch_horn(*, outdir="outputs", device="cuda", **scene_kw):
    """The JAX script's run of :func:`build_scene`, and each port's dip;
    the solver result."""
    res = simulate_scene(build_scene(device=device, **scene_kw), outdir,
                         "mixed_scene.png")
    s11s = res.diagnostics["s11_all_ports"]
    print(f"{summary(res)}, {len(s11s)} ports")
    for i, s11 in enumerate(s11s):
        db = 20 * np.log10(np.maximum(np.abs(s11), 1e-30))
        j = int(np.argmin(db))
        print(f"port {i + 1}: |S11|min {db[j]:.2f} dB at "
              f"{res.freq[j] / 1e9:.3f} GHz")
    save_pattern(res, Path(outdir) / "mixed_pattern.png")
    return res


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--outdir", type=str, default="outputs")
    ap.add_argument("--device", type=str, default="cuda",
                    help="'cuda' runs the CUDA kernels, 'cpu' their plain "
                         "PyTorch twins")
    args = ap.parse_args(argv)
    ensure_backend(args.device)
    mixed_patch_horn(outdir=args.outdir, device=args.device)


if __name__ == "__main__":
    main()
