"""Mean milliseconds a job spends in the prepare's host build of
coefficients, ports, walls, faces, waveform and probe tables (the sweep:
its variants' masks), from the port's ``fdtd.prepare.coeffs`` spans less
the uploads nested in them."""

from .. import program_spans

NAME = "coeffs_ms"
UNIT = "ms"
LAYER = "solver prepare"
MOVES = "cell_rate"


def read(w):
    return program_spans.self_ms_per_job(w, "fdtd.prepare.coeffs")
