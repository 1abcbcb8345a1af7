"""Mean milliseconds a job spends in ``build_simulation``'s voxelizer
(the native core), from the port's ``fdtd.prepare.voxelize`` spans."""

from .. import program_spans

NAME = "voxelize_ms"
UNIT = "ms"
LAYER = "solver prepare"
MOVES = "cell_rate"


def read(w):
    return program_spans.self_ms_per_job(w, "fdtd.prepare.voxelize")
