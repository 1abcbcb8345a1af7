"""Seconds from the process's start, before torch is imported, to the
window's start: libraries, the CUDA context and one warm job."""

NAME = "setup_s"
UNIT = "s"
LAYER = None
MOVES = None


def read(w):
    return w.setup_s
