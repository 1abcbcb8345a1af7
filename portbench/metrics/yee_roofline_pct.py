"""The least time the window's Yee work needs on an H100 (the larger of
its operations over the float32 peak and its bytes over the HBM
bandwidth, ``portbench/yardstick.py``) over the device's busy time in the
trace, in percent."""

from .. import yardstick

NAME = "yee_roofline_pct"
UNIT = "%"
LAYER = "kernels"
MOVES = "cell_rate"


def read(w):
    if not w.busy_s or not w.jobs:
        return None
    t = 0.0
    for j in w.jobs:
        t += yardstick.least_time(
            yardstick.job_ops(j.cell_updates, j.psi_updates),
            yardstick.job_bytes(w.kind.cells, j.byte_sets, w.kind.n_stamps,
                                w.cpml))[0]
    return 100.0 * t / w.busy_s
