"""Performance reporting: cell-update rate and wall-clock accounting.

Counterpart of ``fdtd_solver_antennas_tpu/utils/profiling.py``.

The reference's only perf visibility is scraping openEMS "Timestep: …
Speed: …" console lines (``gui_app.py:493-503``); here the Mcells/s figure
is computed first-class from grid size × steps / wall time — the
BASELINE.json headline metric.
"""

from __future__ import annotations

import dataclasses
import time
from contextlib import contextmanager
from typing import Iterator


@dataclasses.dataclass
class CellRateReport:
    num_cells: int
    steps: int
    wall_time_s: float

    @property
    def cell_updates(self) -> int:
        return self.num_cells * self.steps

    @property
    def mcells_per_s(self) -> float:
        return self.cell_updates / max(self.wall_time_s, 1e-12) / 1e6

    @property
    def gcells_per_s(self) -> float:
        return self.mcells_per_s / 1e3

    def __str__(self) -> str:
        return (
            f"{self.steps} steps × {self.num_cells} cells in "
            f"{self.wall_time_s:.3f}s → {self.mcells_per_s:.1f} Mcells/s"
        )


def cell_rate(num_cells: int, steps: int, wall_time_s: float) -> CellRateReport:
    return CellRateReport(num_cells, steps, wall_time_s)


@contextmanager
def timed() -> Iterator[dict]:
    """Context manager collecting wall time into the yielded dict."""
    box: dict = {}
    t0 = time.perf_counter()
    try:
        yield box
    finally:
        box["wall_time_s"] = time.perf_counter() - t0
