"""Yee cell-updates a second of the run loop alone: the window's
cell-updates over the summed walls of the run calls, each ending in the
loop's own host read of its results."""

NAME = "run_gcells"
UNIT = "Gcell/s"
LAYER = "run loop"
MOVES = "cell_rate"


def read(w):
    run_s = sum(j.run_s for j in w.jobs)
    if run_s <= 0:
        return None
    return sum(j.cell_updates for j in w.jobs) / run_s / 1e9
