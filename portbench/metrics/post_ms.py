"""Mean milliseconds from the run's return to the job's answer (port
spectra, resonances, the far-field grid), from the benchmark's spans."""

NAME = "post_ms"
UNIT = "ms"
LAYER = "post"
MOVES = "cell_rate"


def read(w):
    if not w.jobs:
        return None
    return 1e3 * sum(j.post_s for j in w.jobs) / len(w.jobs)
