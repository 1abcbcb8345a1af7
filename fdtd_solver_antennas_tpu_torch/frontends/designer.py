"""Headless multi-antenna scene designer.

Counterpart of ``fdtd_solver_antennas_tpu/frontends/designer.py``:
``PatchInstance``/``HornInstance``, the simulation controls a designer
panel exposes (``SimControls``) and ``MultiPatchScene``, which owns the
instance list, change callbacks, a ``locked`` flag and a one-call bridge
to the multi-antenna FDTD solver on ``device`` (the card by default). Any
GUI can be a thin view over it. The preview renderer stays in the JAX
package: the port imports no matplotlib.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

import numpy as np

from ..models.params import HornAntennaParams, PatchAntennaParams
from ..models.scene import rotation_matrix
from ..solvers.microstrip import FeedDirection
from ..solvers.multi_patch_3d import (
    _instance_local_geometry,
    prepare_multi_patch_3d,
    run_prepared_multi_patch_3d,
)


@dataclasses.dataclass
class PatchInstance:
    name: str
    params: PatchAntennaParams
    center_x_m: float = 0.0
    center_y_m: float = 0.0
    center_z_m: float = 0.0
    feed_direction: FeedDirection = FeedDirection.NEG_X
    rot_x_deg: float = 0.0
    rot_y_deg: float = 0.0
    rot_z_deg: float = 0.0


@dataclasses.dataclass
class HornInstance:
    name: str
    params: HornAntennaParams
    center_x_m: float = 0.0
    center_y_m: float = 0.0
    center_z_m: float = 0.0
    rot_x_deg: float = 0.0
    rot_y_deg: float = 0.0
    rot_z_deg: float = 0.0


@dataclasses.dataclass
class SimControls:
    """The simulation controls of the designer panel."""

    theta_step_deg: float = 2.0
    phi_step_deg: float = 5.0
    mesh_quality: int = 3  # 1..10
    end_criteria_db: float = -25.0  # clamped to [-80, -10] downstream
    nf_center_mode: str = "origin"  # 'origin' | 'centroid'
    boundary: str = "MUR"  # 'MUR' | 'PML_8'
    simbox_mode: str = "auto"  # 'auto' | 'manual'
    manual_size_mm: Optional[Tuple[float, float, float]] = None
    feed_line_length_mm: float = 20.0  # solver default, kept in sync


class MultiPatchScene:
    """Headless scene model + solver bridge. ``locked`` is set while a
    simulation runs, for frontends to honor."""

    def __init__(self, device="cuda") -> None:
        self.patches: List[PatchInstance] = []
        self.horns: List[HornInstance] = []
        self.controls = SimControls()
        self.device = device
        self.locked = False
        self._change_cb: Optional[Callable[[], None]] = None
        self._counter = 0

    # --- instance management ---------------------------------------------
    def add_patch(self, params: PatchAntennaParams, name: Optional[str] = None,
                  **placement) -> PatchInstance:
        self._counter += 1
        inst = PatchInstance(
            name=name or f"Patch {self._counter}", params=params, **placement
        )
        self.patches.append(inst)
        self._notify()
        return inst

    def add_horn(self, params: HornAntennaParams, name: Optional[str] = None,
                 **placement) -> HornInstance:
        self._counter += 1
        inst = HornInstance(
            name=name or f"Horn {self._counter}", params=params, **placement
        )
        self.horns.append(inst)
        self._notify()
        return inst

    def remove(self, inst) -> None:
        if inst in self.patches:
            self.patches.remove(inst)
        elif inst in self.horns:
            self.horns.remove(inst)
        self._notify()

    def update_field(self, inst, field: str, value) -> None:
        """Set one field of an instance."""
        if not hasattr(inst, field):
            raise AttributeError(f"{type(inst).__name__} has no field {field}")
        setattr(inst, field, value)
        self._notify()

    def update_fields(self, inst, values: dict) -> None:
        """Set several fields with one change notification."""
        for field, value in values.items():
            if not hasattr(inst, field):
                raise AttributeError(
                    f"{type(inst).__name__} has no field {field}")
            setattr(inst, field, value)
        self._notify()

    def set_change_callback(self, cb: Optional[Callable[[], None]]) -> None:
        self._change_cb = cb

    def _notify(self) -> None:
        if self._change_cb is not None:
            try:
                self._change_cb()
            except Exception:
                pass

    # --- geometry helpers -------------------------------------------------
    def instance_bounds_mm(self, inst) -> Tuple[np.ndarray, np.ndarray]:
        """World-frame AABB of one instance (mm)."""
        R = rotation_matrix(inst.rot_x_deg, inst.rot_y_deg, inst.rot_z_deg)
        T = np.array([inst.center_x_m, inst.center_y_m, inst.center_z_m]) * 1e3
        if isinstance(inst, PatchInstance):
            # the solver's own per-instance substrate
            boxes, _port, _dims = _instance_local_geometry(
                inst, self.controls.feed_line_length_mm
            )
            lo = np.asarray(boxes["substrate"][0], float)
            hi = np.asarray(boxes["substrate"][1], float)
        else:
            p = inst.params
            A, B, Lh = p.aperture_A_m * 1e3, p.aperture_B_m * 1e3, p.length_m * 1e3
            lo = np.array([-A / 2, -B / 2, 0.0])
            hi = np.array([A / 2, B / 2, Lh])
        corners = np.array(
            [[x, y, z] for x in (lo[0], hi[0]) for y in (lo[1], hi[1])
             for z in (lo[2], hi[2])]
        )
        world = corners @ R.T + T
        return world.min(axis=0), world.max(axis=0)

    def scene_bounds_mm(self) -> Tuple[np.ndarray, np.ndarray]:
        insts = self.patches + self.horns
        if not insts:
            z = np.zeros(3)
            return z, z
        bounds = [self.instance_bounds_mm(i) for i in insts]
        lo = np.min([b[0] for b in bounds], axis=0)
        hi = np.max([b[1] for b in bounds], axis=0)
        return lo, hi

    # --- solver bridge ----------------------------------------------------
    def prepare(self, verbose: int = 0, log_cb=None):
        """Prepare the multi-antenna FDTD run from the current scene state."""
        c = self.controls
        return prepare_multi_patch_3d(
            self.patches,
            horns=self.horns,
            device=self.device,
            boundary=c.boundary,
            feed_line_length_mm=c.feed_line_length_mm,
            theta_step_deg=c.theta_step_deg,
            phi_step_deg=c.phi_step_deg,
            mesh_quality=c.mesh_quality,
            nf_center_mode=c.nf_center_mode,
            simbox_mode=c.simbox_mode,
            manual_size_mm=c.manual_size_mm,
            end_criteria_db=c.end_criteria_db,
            verbose=verbose,
            log_cb=log_cb,
        )

    def simulate(self, frequency_hz: Optional[float] = None, verbose: int = 0,
                 log_cb=None, progress_cb=None, abort_cb=None):
        """prepare + run, honoring the lock flag.

        ``progress_cb(steps_done, n_steps_max, e_ratio)`` and
        ``abort_cb() -> bool`` give frontends live progress and mid-run
        cancellation (see :meth:`PreparedSimulation.run`).
        """
        if self.locked:
            raise RuntimeError("scene is locked by a running simulation")
        if not self.patches and not self.horns:
            raise ValueError("no antenna instances in the scene")
        f = frequency_hz or max(
            inst.params.frequency_hz for inst in self.patches + self.horns
        )
        self.locked = True
        try:
            prep = self.prepare(verbose=verbose, log_cb=log_cb)
            if not prep.ok:
                return prep
            return run_prepared_multi_patch_3d(
                prep, frequency_hz=f, verbose=verbose,
                progress_cb=progress_cb, abort_cb=abort_cb,
            )
        finally:
            self.locked = False
