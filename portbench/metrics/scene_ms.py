"""Mean milliseconds a job spends assembling the scene and its mesh
(``MeshBuilder.build``; the sweep's union mesh), from the port's
``fdtd.prepare.scene`` spans."""

from .. import program_spans

NAME = "scene_ms"
UNIT = "ms"
LAYER = "solver prepare"
MOVES = "cell_rate"


def read(w):
    return program_spans.self_ms_per_job(w, "fdtd.prepare.scene")
