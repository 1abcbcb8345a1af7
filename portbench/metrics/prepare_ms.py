"""Mean milliseconds a job spends in the solver's prepare (mesh,
voxelizer, coefficient build, uploads), from the benchmark's span around
the prepare call."""

NAME = "prepare_ms"
UNIT = "ms"
LAYER = "solver prepare"
MOVES = "cell_rate"


def read(w):
    if not w.jobs:
        return None
    return 1e3 * sum(j.prepare_s for j in w.jobs) / len(w.jobs)
