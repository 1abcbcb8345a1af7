"""Yee cell-updates a second over the closed loop's whole wall: every
whole job of the window, prepare, run and post, over the window's length
(from the first job's start to the end of the job in flight at its
close)."""

NAME = "cell_rate"
UNIT = "Gcell/s"
LAYER = None
MOVES = None


def read(w):
    if not w.jobs:
        return None
    return sum(j.cell_updates for j in w.jobs) / w.window_s / 1e9
