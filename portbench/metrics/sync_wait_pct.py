"""The share of the run loop that the host spends waiting on the card, in
percent: the port's ``fdtd.run.sync`` spans (each chunk's read of the
energy ratio, and the output's reads) over its ``fdtd.run`` spans. Near
100, the card sets the pace; lower, the host's enqueue and its work
between chunks do. It falls when the kernels get faster while the host's
own time a chunk stays the same, so it reads the host's share of the run
loop, not the loop's speed."""

from .. import program_spans

NAME = "sync_wait_pct"
UNIT = "%"
LAYER = "run loop"
MOVES = "cell_rate"


def read(w):
    t = program_spans.totals(w)
    if not t or "fdtd.run" not in t or "fdtd.run.sync" not in t:
        return None
    run_s = t["fdtd.run"]["s"]
    return 100.0 * t["fdtd.run.sync"]["s"] / run_s if run_s > 0 else None
