"""The share of a batched run's variant-chunks spent on variants already
frozen at their stop, in percent: the counts ``frozen_variant_chunks``
over ``live_variant_chunks`` + ``frozen_variant_chunks`` on the port's
``fdtd.run`` spans. A frozen variant is not stepped, but its share of the
launch is not given to the others."""

from .. import program_spans

NAME = "frozen_variant_pct"
UNIT = "%"
LAYER = "run loop"
MOVES = "cell_rate"


def read(w):
    t = program_spans.totals(w)
    if not t or "fdtd.run" not in t:
        return None
    c = t["fdtd.run"]["counts"]
    frozen = c.get("frozen_variant_chunks")
    if frozen is None:
        return None
    total = frozen + c.get("live_variant_chunks", 0)
    return 100.0 * frozen / total if total else None
