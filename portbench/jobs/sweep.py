"""Job kind ``sweep``: one geometry sweep of the canonical patch.

A job is one round of design-space exploration: the port's
``solvers/sweep.py::prepare_patch_geometry_sweep`` of the traffic's
variants, ``run_patch_geometry_sweep`` to each variant's energy stop
(frozen variants skipped) and its resonances. The benchmark's run span
wraps ``solvers/sweep.py::_run_batched`` for the job's duration, which
also keeps the raw batched output for the check.
"""

from __future__ import annotations

import time

import numpy as np

from ..reference.scenes import sweep_scenes, sweep_variants
from ..reference.solve import Answer, solve_sweep
from . import JobRecord


class Kind:
    """The configuration's patch, the traffic's variants of it."""

    def __init__(self, config: dict, traffic: dict, device: str):
        self.config, self.traffic, self.device = config, traffic, device
        scenes, spec = sweep_scenes(config, traffic, traffic["boundary"], 0.02)
        self.cells = int(spec.grid.num_cells)
        self.n_stamps = len({p.direction for p in scenes[0].ports})
        self.n_var = len(scenes)

    def run(self, loss_tangent: float, spans) -> JobRecord:
        from fdtd_solver_antennas_tpu_torch import PatchAntennaParams
        from fdtd_solver_antennas_tpu_torch.solvers import sweep

        c = self.config
        rec = JobRecord(draw=loss_tangent)
        rec.t0 = time.perf_counter()
        variants = [PatchAntennaParams.from_user_units(
            frequency_ghz=c["frequency_ghz"], er=c["er"], h_mm=c["h_mm"],
            loss_tangent=loss_tangent, W_mm=W, L_mm=L)
            for W, L in sweep_variants(c, self.traffic)]
        with spans("prepare"):
            prep = sweep.prepare_patch_geometry_sweep(
                variants, feed_pos_mm=c["feed_pos_mm"],
                n_steps_max=c["n_steps_max"], end_criteria=c["end_criteria"],
                boundary=self.traffic["boundary"], device=self.device)
        rec.t_prepared = time.perf_counter()
        if not prep.ok:
            rec.failed = prep.message
            rec.t_end = time.perf_counter()
            return rec
        raw = {}
        inner = sweep._run_batched
        post = spans("post")

        def timed_run(prepared, impl=None):
            with spans("run"):
                rec.t_run0 = time.perf_counter()
                got = inner(prepared, impl)
                rec.t_run1 = time.perf_counter()
            raw.update(got[0])
            post.__enter__()  # from the run's return to the job's answer
            return got

        sweep._run_batched = timed_run
        try:
            res = sweep.run_patch_geometry_sweep(prep)
        finally:
            sweep._run_batched = inner
            if raw:
                post.__exit__(None, None, None)
        rec.t_end = time.perf_counter()
        if not res.ok or not raw:
            rec.failed = res.message
            return rec
        steps = np.asarray(res.steps, np.int64)
        rec.steps = int(res.steps_run)
        rec.cell_updates = self.cells * int(steps.sum())
        rec.psi_updates = 0  # MUR: no ψ
        rec.byte_sets = self.n_var
        n = self.n_var

        def faces(key):
            return [np.take(a, 0, 1)[:n] + 1j * np.take(a, 1, 1)[:n]
                    for a in raw[key]]

        rec.answer = Answer(
            steps=steps, e_ratio=np.asarray(res.e_ratio, np.float64),
            uf=np.asarray(raw["uf"])[:n], if_=np.asarray(raw["if_"])[:n],
            nf_e=faces("nf_e"), nf_h=faces("nf_h"),
            s11=np.stack([sp.s11 for sp in res.spectra])[:, None],
            f_res=np.asarray(res.f_res_hz, np.float64),
            decim=int(prep.sim.probe_decim),
        )
        return rec

    def reference(self, rec: JobRecord, device: str, dtype):
        return solve_sweep(self.config, self.traffic, rec.draw, device=device,
                           dtype=dtype, decim=rec.answer.decim,
                           stop_steps=[int(s) for s in rec.answer.steps])

    def control(self, loss_tangent: float, decim: int, device: str, dtype):
        return solve_sweep(self.config, self.traffic, loss_tangent,
                           device=device, dtype=dtype, decim=decim)
