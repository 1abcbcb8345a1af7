"""The GUI's Microstrip 3D scene, worked out again.

A frozen copy of the port's ``solvers/microstrip.py::build_microstrip_scene``
(lumped port) and of the mesh and run settings its
``solvers/microstrip_3d.py::prepare_microstrip_patch_3d`` gives it: the
TM10 patch, a 50 Ω feed strip of Wheeler's width on the feed side, a
substrate of the patch plus a 30 mm margin each side and the feed line,
a ground plane under it, a lumped port from ground to the patch's feed
edge; a box 50 mm of air around the substrate in x and y and 160 mm tall
(−⅓/+⅔ about the ground); the mesh λ/ppw at f0 + f0/2 graded at ratio
1.4, ppw from the mesh quality (1–5: 12, 16, 20, 25, 32); the pattern
over θ 0–180° and φ 0–360° about the substrate's middle.
"""

from __future__ import annotations

import numpy as np

from .mesh import MeshBuilder
from .physics import C0, substrate_conductivity
from .scene import Scene
from .scenes import RunSpec, _si_mm, microstrip_width, patch_dims_mm

PPW_MAP_5 = {1: 12.0, 2: 16.0, 3: 20.0, 4: 25.0, 5: 32.0}
MARGIN_MM = 30.0
AIR_MM = 50.0
BOX_Z_MM = 160.0


def port_freqs_hz(f0: float) -> np.ndarray:
    """The S11 sweep: 201 points from max(0.1 GHz, 0.7·f0), at most
    0.9·f0, to 1.3·f0."""
    return np.linspace(min(max(1e8, 0.7 * f0), 0.9 * f0), f0 * 1.3, 201)


def microstrip_scene(config: dict, boundary: str,
                     loss_tangent: float) -> RunSpec:
    """The configuration's microstrip patch with its substrate at
    ``loss_tangent``, its mesh and run settings."""
    f0 = config["frequency_ghz"] * 1e9
    er = config["er"]
    patch_W, patch_L, h = patch_dims_mm(
        {"frequency_ghz": config["frequency_ghz"], "er": er,
         "h_mm": config["h_mm"]})
    h = _si_mm(config["h_mm"])
    fw = microstrip_width(f0, er, h * 1e-3) * 1e3
    fl = float(config["feed_line_length_mm"])
    fd = config["feed_direction"].upper()
    q = max(1, min(5, int(config["mesh_quality"])))
    mesh_res = C0 / (f0 + f0 / 2.0) / 1e-3 / PPW_MAP_5[q]

    if fd in ("+X", "-X"):
        sub_W, sub_L = patch_W + 2 * MARGIN_MM + fl, patch_L + 2 * MARGIN_MM
    else:
        sub_W, sub_L = patch_W + 2 * MARGIN_MM, patch_L + 2 * MARGIN_MM + fl
    box_x, box_y = sub_W + 2 * AIR_MM, sub_L + 2 * AIR_MM

    scene = Scene()
    scene.add_material_box(
        "substrate", er, substrate_conductivity(f0, er, loss_tangent),
        [-sub_W / 2, -sub_L / 2, 0.0], [sub_W / 2, sub_L / 2, h], priority=0)
    scene.add_metal_box("ground", [-sub_W / 2, -sub_L / 2, 0.0],
                        [sub_W / 2, sub_L / 2, 0.0], priority=10)
    scene.add_metal_box("patch", [-patch_W / 2, -patch_L / 2, h],
                        [patch_W / 2, patch_L / 2, h], priority=10)
    if fd == "-X":
        feed_lo, feed_hi = [-sub_W / 2, -fw / 2, h], [-patch_W / 2, fw / 2, h]
        px, py = -patch_W / 2, 0.0
    elif fd == "+X":
        feed_lo, feed_hi = [patch_W / 2, -fw / 2, h], [sub_W / 2, fw / 2, h]
        px, py = patch_W / 2, 0.0
    elif fd == "-Y":
        feed_lo, feed_hi = [-fw / 2, -sub_L / 2, h], [fw / 2, -patch_L / 2, h]
        px, py = 0.0, -patch_L / 2
    else:
        feed_lo, feed_hi = [-fw / 2, patch_L / 2, h], [fw / 2, sub_L / 2, h]
        px, py = 0.0, patch_L / 2
    scene.add_metal_box("feed_line", feed_lo, feed_hi, priority=10)
    scene.add_lumped_port(1, 50.0, [px, py, 0.0], [px, py, h],
                          direction="z", excite=1.0)

    mb = MeshBuilder()
    mb.add_line("x", [-box_x / 2, box_x / 2])
    mb.add_line("y", [-box_y / 2, box_y / 2])
    mb.add_line("z", [-BOX_Z_MM / 3, BOX_Z_MM * 2 / 3])
    mb.add_line("z", np.linspace(0.0, h, 5))
    mb.add_metal_edges([-sub_W / 2, -sub_L / 2, 0.0],
                       [sub_W / 2, sub_L / 2, 0.0], dirs="xy")
    mb.add_metal_edges([-patch_W / 2, -patch_L / 2, h],
                       [patch_W / 2, patch_L / 2, h], dirs="xy",
                       metal_edge_res=mesh_res / 2)
    mb.add_metal_edges(feed_lo, feed_hi, dirs="xy",
                       metal_edge_res=mesh_res / 2)
    mb.add_line("x", [float(px)])
    mb.add_line("y", [float(py)])
    if fd in ("+X", "-X"):
        mb.add_line("y", [-fw / 2, 0.0, fw / 2])
    else:
        mb.add_line("x", [-fw / 2, 0.0, fw / 2])
    grid = mb.build(mesh_res, ratio=1.4)

    t_step = max(0.5, float(config["theta_step_deg"]))
    p_step = max(1.0, float(config["phi_step_deg"]))
    return RunSpec(
        scene=scene, grid=grid, f0=f0, fc=f0 / 2.0, boundary=boundary,
        n_steps_max=int(config["n_steps_max"]),
        end_criteria=float(config["end_criteria"]),
        port_freqs_hz=port_freqs_hz(f0),
        nf_freqs_hz=np.linspace(f0 * 0.85, f0 * 1.15, 11),
        theta=np.arange(0.0, 181.0, t_step),
        phi=np.arange(0.0, 360.0 + p_step, p_step),
        nf_center=np.array([0.0, 0.0, h / 2000.0]),
    )
