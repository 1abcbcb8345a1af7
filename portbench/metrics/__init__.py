"""Metrics, one module each, found by the name ``BENCHMARK.json`` gives.

A module ``metrics/<name>.py`` holds ``NAME``, ``UNIT``, ``LAYER`` (None
for an end-to-end metric), ``MOVES`` (the end-to-end metric it should
move; None for an end-to-end one) and ``read(w)``, which takes the
window's record (``portbench/run.py::Window``: the jobs with their stamps
and work, the job kind, the port's launch counters, the peak memory and,
in a traced run, the whole trace reduction) and returns the number, or
None where it finds nothing to read (the harness then leaves the metric
out of the line).
"""
