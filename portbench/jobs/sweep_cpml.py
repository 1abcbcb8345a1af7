"""Job kind ``sweep_cpml``: the ``sweep`` job under a ``PML_N`` boundary.

The port's job is ``jobs/sweep.py``'s; the reference and the control are
the CPML reference's (``reference/solve_cpml.py``), and the job counts
its ψ work by the yardstick, summed over the variants.
"""

from __future__ import annotations

from .. import yardstick
from ..reference.cpml import npml_of
from ..reference.scenes import sweep_scenes
from ..reference.solve_cpml import solve_sweep_cpml
from . import JobRecord
from .sweep import Kind as SweepKind


class Kind(SweepKind):
    """The configuration's patch, the traffic's variants of it, CPML."""

    def __init__(self, config: dict, traffic: dict, device: str):
        super().__init__(config, traffic, device)
        self.npml = npml_of(traffic["boundary"])
        if self.npml <= 0:
            raise ValueError(f"sweep_cpml needs a PML_N boundary, not "
                             f"{traffic['boundary']}")
        self.lines = sweep_scenes(config, traffic, traffic["boundary"],
                                  0.02)[1].grid.shape

    def run(self, loss_tangent: float, spans) -> JobRecord:
        rec = super().run(loss_tangent, spans)
        if rec.answer is not None:
            rec.psi_updates = sum(
                yardstick.psi_cell_updates(self.lines, self.npml, int(s))
                for s in rec.answer.steps)
        return rec

    def reference(self, rec: JobRecord, device: str, dtype):
        return solve_sweep_cpml(self.config, self.traffic, rec.draw,
                                device=device, dtype=dtype,
                                decim=rec.answer.decim,
                                stop_steps=[int(s) for s in rec.answer.steps])

    def control(self, loss_tangent: float, decim: int, device: str, dtype):
        return solve_sweep_cpml(self.config, self.traffic, loss_tangent,
                                device=device, dtype=dtype, decim=decim)
