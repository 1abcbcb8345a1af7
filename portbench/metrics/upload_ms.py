"""Mean milliseconds a job spends copying the prepare's arrays from the
host to the device, summed over the port's ``fdtd.prepare.upload``
spans."""

from .. import program_spans

NAME = "upload_ms"
UNIT = "ms"
LAYER = "solver prepare"
MOVES = "cell_rate"


def read(w):
    return program_spans.self_ms_per_job(w, "fdtd.prepare.upload")
