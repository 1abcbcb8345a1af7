"""Job kind ``microstrip3d``: one design of the GUI's Microstrip 3D solver.

A job is what a designer waits for: the port's
``solvers/microstrip_3d.py::prepare_microstrip_patch_3d`` of the
configuration's patch, ``run_prepared_microstrip_3d`` to the energy stop,
S11 and the full-sphere pattern at the resonance. The run is passed
through the solver's ``run=`` hook, so the benchmark's span covers
``sim.run`` alone and keeps its raw output for the check. Under
``PML_N`` the reference is the CPML one (``reference/solve_cpml.py``).
"""

from __future__ import annotations

import time

import numpy as np

from .. import yardstick
from ..reference.cpml import npml_of
from ..reference.microstrip import microstrip_scene
from ..reference.solve import Answer
from ..reference.solve_cpml import solve_microstrip
from . import JobRecord
from .design import _complex


class Kind:
    """The configuration's microstrip patch, one job at a time."""

    def __init__(self, config: dict, traffic: dict, device: str):
        self.config, self.traffic, self.device = config, traffic, device
        spec = microstrip_scene(config, traffic["boundary"], 0.02)
        self.lines = spec.grid.shape
        self.cells = int(spec.grid.num_cells)
        self.n_stamps = 1
        self.npml = npml_of(traffic["boundary"])
        self.f_hz = config["frequency_ghz"] * 1e9

    def prepare(self, loss_tangent: float):
        """The port's prepare of the job at ``loss_tangent``."""
        from fdtd_solver_antennas_tpu_torch import PatchAntennaParams
        from fdtd_solver_antennas_tpu_torch.solvers.microstrip_3d import \
            prepare_microstrip_patch_3d

        c = self.config
        params = PatchAntennaParams.from_user_units(
            frequency_ghz=c["frequency_ghz"], er=c["er"], h_mm=c["h_mm"],
            loss_tangent=loss_tangent)
        return prepare_microstrip_patch_3d(
            params, device=self.device, feed_direction=c["feed_direction"],
            feed_line_length_mm=c["feed_line_length_mm"],
            boundary=self.traffic["boundary"],
            theta_step_deg=c["theta_step_deg"],
            phi_step_deg=c["phi_step_deg"], mesh_quality=c["mesh_quality"],
            n_steps_max=c["n_steps_max"], end_criteria=c["end_criteria"])

    def run(self, loss_tangent: float, spans) -> JobRecord:
        """One job; ``spans(name)`` opens a span around each stage."""
        from fdtd_solver_antennas_tpu_torch.solvers.microstrip_3d import \
            run_prepared_microstrip_3d

        rec = JobRecord(draw=loss_tangent)
        rec.t0 = time.perf_counter()
        with spans("prepare"):
            prep = self.prepare(loss_tangent)
        rec.t_prepared = time.perf_counter()
        if not prep.ok:
            rec.failed = prep.message
            rec.t_end = time.perf_counter()
            return rec
        sim = prep.sim
        raw = {}
        post = spans("post")

        def timed_run():
            with spans("run"):
                rec.t_run0 = time.perf_counter()
                out = sim.run()
                rec.t_run1 = time.perf_counter()
            raw.update(out)
            post.__enter__()  # from the run's return to the job's answer
            return out

        try:
            res = run_prepared_microstrip_3d(prep, frequency_hz=self.f_hz,
                                             verbose=0, run=timed_run)
        finally:
            if raw:
                post.__exit__(None, None, None)
        rec.t_end = time.perf_counter()
        if not res.ok or not raw:
            rec.failed = res.message
            return rec
        steps = int(res.steps_run)
        rec.steps = steps
        rec.cell_updates = self.cells * steps
        rec.psi_updates = yardstick.psi_cell_updates(self.lines, self.npml,
                                                     steps)
        rec.byte_sets = 1
        rec.answer = Answer(
            steps=np.array([steps]),
            e_ratio=np.array([float(res.diagnostics["energy_ratio"])]),
            uf=np.asarray(raw["uf"])[None], if_=np.asarray(raw["if_"])[None],
            nf_e=[_complex(np.asarray(a), 0)[None] for a in raw["nf_e"]],
            nf_h=[_complex(np.asarray(a), 0)[None] for a in raw["nf_h"]],
            s11=np.asarray(res.s11)[None, None],
            f_res=np.array([float(res.f_res_hz)]),
            decim=int(sim.probe_decim),
            pattern=10.0 ** (np.asarray(res.intensity, np.float64) / 10.0),
        )
        return rec

    def reference(self, rec: JobRecord, device: str, dtype):
        """The reference's answer to ``rec``'s job, following its stop."""
        return solve_microstrip(self.config, self.traffic, rec.draw,
                                device=device, dtype=dtype,
                                decim=rec.answer.decim,
                                stop_steps=int(rec.answer.steps[0]),
                                pattern_f_hz=float(rec.answer.f_res[0]))

    def control(self, loss_tangent: float, decim: int, device: str, dtype):
        """The reference in the program's place at ``dtype``, stopping on
        its own energy criterion."""
        return solve_microstrip(self.config, self.traffic, loss_tangent,
                                device=device, dtype=dtype, decim=decim)
