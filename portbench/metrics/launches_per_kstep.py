"""Launches of the port's hand-written kernels per 1,000 leapfrog steps of
the jobs' loops, from the port's own counters (``fdtd_cuda``,
``fdtd_stream``, ``fdtd_shard``, ``fdtd_steps``), reset when the window
opens."""

NAME = "launches_per_kstep"
UNIT = "launches/kstep"
LAYER = "run loop"
MOVES = "cell_rate"


def read(w):
    steps = sum(j.steps for j in w.jobs)
    if steps <= 0:
        return None
    return w.launches / (steps / 1000.0)
