"""The multi-port scenes of ``tests/test_sparams.py``, built by either
package from the same inputs: two small patches over one ground plane
with a lumped z-port at each centre (mirror-symmetric in x), and one
patch alone; 3,000 steps asked. The port builds them on the CPU."""

import numpy as np

from fdtd_solver_antennas_tpu.models.scene import Scene as JScene
from fdtd_solver_antennas_tpu.ops.fdtd import FDTDConfig as JConfig
from fdtd_solver_antennas_tpu.ops.fdtd import build_simulation as jbuild
from fdtd_solver_antennas_tpu.ops.mesh import MeshBuilder as JMeshBuilder

from fdtd_solver_antennas_tpu_torch.models.scene import Scene
from fdtd_solver_antennas_tpu_torch.ops.fdtd import FDTDConfig, build_simulation
from fdtd_solver_antennas_tpu_torch.ops.mesh import MeshBuilder

FREQS = np.linspace(2.0e9, 3.0e9, 11)
PORT = dict(device="cpu")
JAX = dict(scene=JScene, mesh=JMeshBuilder, config=JConfig, build=jbuild)
TORCH = dict(scene=Scene, mesh=MeshBuilder, config=FDTDConfig,
             build=build_simulation)


def two_patches(pkg, pol2=1.0, n_steps=3000, **kw):
    """``tests/test_sparams.py``'s two-patch scene through ``pkg`` (JAX or
    TORCH); ``pol2`` is port 2's prepared excitation."""
    scene = pkg["scene"]()
    scene.add_material_box("sub", 2.2, 0.0, [-30, -15, 0], [30, 15, 1.6], 0)
    scene.add_metal_box("gnd", [-30, -15, 0], [30, 15, 0], priority=10)
    for sgn, name in ((-1, "pa"), (+1, "pb")):
        cx = sgn * 13.0
        scene.add_metal_box(
            name, [cx - 6, -5, 1.6], [cx + 6, 5, 1.6], priority=10)
    scene.add_lumped_port(1, 50.0, [-13, 0, 0], [-13, 0, 1.6],
                          direction="z", excite=1.0)
    scene.add_lumped_port(2, 50.0, [13, 0, 0], [13, 0, 1.6],
                          direction="z", excite=pol2)
    mb = pkg["mesh"]()
    mb.add_line("x", np.linspace(-34, 34, 35))
    mb.add_line("x", [-19.0, -13.0, -7.0, 7.0, 13.0, 19.0])
    mb.add_line("y", np.linspace(-19, 19, 20))
    mb.add_line("z", list(np.linspace(-8, 12, 11)) + [0.0, 0.8, 1.6])
    grid = mb.build(3.0)
    cfg = pkg["config"](n_steps_max=n_steps, end_criteria=1e-5,
                        check_every=500, **kw)
    extra = PORT if pkg is TORCH else {}
    return pkg["build"](
        scene, grid, f0=2.45e9, fc=1.225e9, cfg=cfg,
        port_freqs_hz=FREQS, nf_freqs_hz=np.array([2.45e9]), **extra)


def one_patch(pkg):
    scene = pkg["scene"]()
    scene.add_material_box("sub", 2.2, 0.0, [-15, -15, 0], [15, 15, 1.6], 0)
    scene.add_metal_box("gnd", [-15, -15, 0], [15, 15, 0], priority=10)
    scene.add_metal_box("p", [-6, -5, 1.6], [6, 5, 1.6], priority=10)
    scene.add_lumped_port(1, 50.0, [0, 0, 0], [0, 0, 1.6], direction="z")
    mb = pkg["mesh"]()
    mb.add_line("x", np.linspace(-19, 19, 20))
    mb.add_line("y", np.linspace(-19, 19, 20))
    mb.add_line("z", list(np.linspace(-8, 12, 11)) + [0.0, 0.8, 1.6])
    grid = mb.build(3.0)
    cfg = pkg["config"](n_steps_max=3000, end_criteria=1e-5, check_every=500)
    extra = PORT if pkg is TORCH else {}
    return pkg["build"](
        scene, grid, f0=2.45e9, fc=1.225e9, cfg=cfg,
        port_freqs_hz=FREQS, nf_freqs_hz=np.array([2.45e9]), **extra)
