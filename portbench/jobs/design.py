"""Job kind ``design``: one design of a multi-antenna scene, closed loop.

A job is what a designer waits for: the port's
``frontends/designer.py::MultiPatchScene.prepare`` of the configuration's
scene, ``solvers/multi_patch_3d.py::run_prepared_multi_patch_3d`` to the
energy stop, and its post-processing (S11 of every port and the
full-sphere dBi grid). The run is passed through the solver's ``run=``
hook, so the benchmark's span covers ``sim.run`` alone and keeps its raw
output for the check.
"""

from __future__ import annotations

import time

import numpy as np

from ..reference.scenes import design_scene
from ..reference.solve import Answer, design_target_hz, solve_design
from . import JobRecord


def _complex(a: np.ndarray, axis: int) -> np.ndarray:
    """The program's stacked (re, −im) float layout as complex."""
    return np.take(a, 0, axis) + 1j * np.take(a, 1, axis)


class Kind:
    """The configuration's designer scene, one job at a time."""

    def __init__(self, config: dict, traffic: dict, device: str):
        self.config, self.traffic, self.device = config, traffic, device
        spec = design_scene(config, traffic["boundary"], 0.02)
        self.cells = int(spec.grid.num_cells)
        self.n_stamps = len({p.direction for p in spec.scene.ports})
        self.f_hz = design_target_hz(config)

    def _scene(self, loss_tangent: float):
        from fdtd_solver_antennas_tpu_torch import (HornAntennaParams,
                                                    PatchAntennaParams)
        from fdtd_solver_antennas_tpu_torch.frontends.designer import \
            MultiPatchScene

        scene = MultiPatchScene(device=self.device)
        for p in self.config.get("patches", []):
            rx, ry, rz = p.get("rot_deg", (0.0, 0.0, 0.0))
            cx, cy, cz = p.get("center_m", (0.0, 0.0, 0.0))
            scene.add_patch(
                PatchAntennaParams.from_user_units(
                    frequency_ghz=p["frequency_ghz"], er=p["er"],
                    h_mm=p["h_mm"], L_mm=p.get("L_mm"), W_mm=p.get("W_mm"),
                    loss_tangent=loss_tangent),
                center_x_m=cx, center_y_m=cy, center_z_m=cz,
                rot_x_deg=rx, rot_y_deg=ry, rot_z_deg=rz,
                feed_direction=p.get("feed_direction", "-X"))
        for h in self.config.get("horns", []):
            rx, ry, rz = h.get("rot_deg", (0.0, 0.0, 0.0))
            cx, cy, cz = h.get("center_m", (0.0, 0.0, 0.0))
            scene.add_horn(
                HornAntennaParams.from_user_units(
                    frequency_ghz=h["frequency_ghz"],
                    throat_a_mm=h["throat_a_mm"], throat_b_mm=h["throat_b_mm"],
                    aperture_A_mm=h["aperture_A_mm"],
                    aperture_B_mm=h["aperture_B_mm"],
                    length_mm=h["length_mm"]),
                center_x_m=cx, center_y_m=cy, center_z_m=cz,
                rot_x_deg=rx, rot_y_deg=ry, rot_z_deg=rz)
        c = self.config["controls"]
        ctl = scene.controls
        ctl.mesh_quality = c["mesh_quality"]
        ctl.end_criteria_db = c["end_criteria_db"]
        ctl.theta_step_deg = c["theta_step_deg"]
        ctl.phi_step_deg = c["phi_step_deg"]
        ctl.nf_center_mode = c["nf_center_mode"]
        ctl.boundary = self.traffic["boundary"]
        ctl.simbox_mode = c["simbox_mode"]
        ctl.manual_size_mm = c["manual_size_mm"]
        ctl.feed_line_length_mm = c["feed_line_length_mm"]
        return scene

    def run(self, loss_tangent: float, spans) -> JobRecord:
        """One job; ``spans(name)`` opens a span around each stage."""
        from fdtd_solver_antennas_tpu_torch.solvers.multi_patch_3d import \
            run_prepared_multi_patch_3d

        rec = JobRecord(draw=loss_tangent)
        rec.t0 = time.perf_counter()
        scene = self._scene(loss_tangent)
        with spans("prepare"):
            prep = scene.prepare()
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
            res = run_prepared_multi_patch_3d(prep, frequency_hz=self.f_hz,
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
        rec.psi_updates = 0  # MUR: no ψ
        rec.byte_sets = 1
        rec.answer = Answer(
            steps=np.array([steps]),
            e_ratio=np.array([float(res.diagnostics["energy_ratio"])]),
            uf=np.asarray(raw["uf"])[None], if_=np.asarray(raw["if_"])[None],
            nf_e=[_complex(np.asarray(a), 0)[None] for a in raw["nf_e"]],
            nf_h=[_complex(np.asarray(a), 0)[None] for a in raw["nf_h"]],
            s11=np.stack(res.diagnostics["s11_all_ports"])[None],
            f_res=np.array([float(res.f_res_hz)]),
            decim=int(sim.probe_decim),
            pattern=10.0 ** (np.asarray(res.intensity, np.float64) / 10.0),
        )
        return rec

    def reference(self, rec: JobRecord, device: str, dtype):
        """The reference's answer to ``rec``'s job, following its stop."""
        return solve_design(self.config, self.traffic, rec.draw,
                            device=device, dtype=dtype, decim=rec.answer.decim,
                            stop_steps=int(rec.answer.steps[0]),
                            pattern_f_hz=float(rec.answer.f_res[0]))

    def control(self, loss_tangent: float, decim: int, device: str, dtype):
        """The reference in the program's place at ``dtype``, stopping on
        its own energy criterion."""
        return solve_design(self.config, self.traffic, loss_tangent,
                            device=device, dtype=dtype, decim=decim)
