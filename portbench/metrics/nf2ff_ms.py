"""Mean milliseconds a job spends in the near-to-far-field transform,
ending in its host read, from the port's ``fdtd.post.nf2ff`` spans."""

from .. import program_spans

NAME = "nf2ff_ms"
UNIT = "ms"
LAYER = "post"
MOVES = "cell_rate"


def read(w):
    return program_spans.self_ms_per_job(w, "fdtd.post.nf2ff")
