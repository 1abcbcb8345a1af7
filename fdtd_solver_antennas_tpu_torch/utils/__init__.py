"""Profiling, tracing and backend helpers (counterpart of
``fdtd_solver_antennas_tpu/utils``)."""

from .profiling import CellRateReport, cell_rate, timed
from .tracing import TraceSummary, records, span, summarize_trace, trace

__all__ = [
    "CellRateReport",
    "cell_rate",
    "timed",
    "trace",
    "summarize_trace",
    "TraceSummary",
    "span",
    "records",
]
