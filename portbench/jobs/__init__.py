"""Job kinds, one module each, found by the traffic file's ``job`` name.

A module ``jobs/<kind>.py`` holds a class ``Kind(config, traffic,
device)`` with ``cells`` (Yee cells of the job's grid), ``n_stamps``
(source stamps a step reads), ``run(draw, spans) -> JobRecord`` (one whole
job of the program, each stage inside ``spans(name)``), ``reference(rec,
device, dtype)`` (the plain reference's answer to that job) and
``control(draw, decim, device, dtype)`` (the reference in the program's
place, stopping on its own).
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class JobRecord:
    """One job of the window: its draw, host-clock stamps, work and answer."""

    draw: float
    t0: float = 0.0  # job start
    t_prepared: float = 0.0  # prepare returned
    t_run0: float = 0.0  # the run's span
    t_run1: float = 0.0
    t_end: float = 0.0  # the job's answer is in hand
    steps: int = 0  # leapfrog steps of the job's loop
    cell_updates: int = 0  # Yee cells stepped, summed over variants
    psi_updates: int = 0  # CPML ψ cells stepped where the profile is not flat
    byte_sets: int = 0  # variants whose state the job reads and writes once
    failed: Optional[str] = None
    answer: object = None  # reference.solve.Answer

    @property
    def prepare_s(self) -> float:
        return self.t_prepared - self.t0

    @property
    def run_s(self) -> float:
        return self.t_run1 - self.t_run0

    @property
    def post_s(self) -> float:
        return self.t_end - self.t_run1
