"""Desktop GUI (Tkinter) — compact re-scope of the reference's gui_app.py.

Counterpart of ``fdtd_solver_antennas_tpu/frontends/gui_app.py`` on the
port: every prepare and the scene run on ``main(device=...)``, the card by
default. tkinter and matplotlib are imported inside ``main()`` only; the
module-level helpers need neither.

The reference ships a ~3100-line Windows-oriented Tk application
(``gui_app.py:2484-3149`` main class) plus a Win32-reparented PyVista view.
Per SURVEY §7 the platform-specific presentation is re-scoped: this module
provides the same *capabilities* as a portable Tk app over the headless
``MultiPatchScene``/solver APIs:

- dark-themed parameter sidebar with the reference's full control set
  (frequency/εr/h/tanδ/metal/solver type incl. legacy+2D/feed direction/
  boundary/θ·φ steps/normalization mode — gui_app.py:113-327);
- a Port Diagnostics pane fed by structured ``log_cb`` messages and
  per-run port summaries (gui_app.py:330-441);
- Run button executing the solver on a background thread with all UI
  mutations marshaled through ``root.after`` (the reference's thread
  contract, gui_app.py:2678-2705) and control locking during runs;
- scrolling log with openEMS-style step-line coalescing
  (``LogFrame.append_log`` analog, gui_app.py:489-517);
- tabbed matplotlib plots: geometry, S11 sweep, polar cuts (mirrored to
  360°), 3D pattern with dBi/Normalized scale switch
  (gui_app.py:528-961, 1113-1348);
- Scene tab over the headless designer with per-instance placement,
  rot x/y/z, feed direction, and the full simulation-control block
  (θ/φ steps, end criteria, NF2FF center, boundary, sim box auto/manual
  — multi_patch_designer.py:291-465, 1449-1547), plus an "Open 3D view"
  button that renders the interactive scene viewer (viz/scene3d.py) in
  the default browser — the portable PyVista-view replacement.

Requires a display; ``python -m fdtd_solver_antennas_tpu_torch.launch_gui``
checks the environment and launches it. All compute paths are the same
solvers the CLI and web UI use. The module-level helpers below are
headless and unit-tested (tests/test_torch_frontends.py).
"""

from __future__ import annotations

import queue
import threading
from typing import Optional

import numpy as np


class ModernStyle:
    """Dark theme palette (reference: gui_app.py:32-110)."""

    BG = "#1e1e2e"
    PANEL = "#27273a"
    FG = "#cdd6f4"
    ACCENT = "#89b4fa"
    GOOD = "#a6e3a1"
    WARN = "#f9e2af"
    CONSOLE_BG = "#101018"
    CONSOLE_FG = "#a6e3a1"


class LogCoalescer:
    """Coalesce rapid progress lines like the reference's LogFrame
    (gui_app.py:493-517): consecutive 'step ...' lines replace each other
    instead of flooding the console; capped backlog."""

    def __init__(self, max_lines: int = 1000):
        self.lines: list[str] = []
        self.max_lines = max_lines

    def append(self, text: str) -> None:
        is_step = text.lstrip().lower().startswith(("step", "timestep"))
        if (
            is_step
            and self.lines
            and self.lines[-1].lstrip().lower().startswith(("step", "timestep"))
        ):
            self.lines[-1] = text
        else:
            self.lines.append(text)
        if len(self.lines) > self.max_lines:
            del self.lines[: len(self.lines) - self.max_lines]


def is_full_sphere(phi_rad: np.ndarray) -> bool:
    """True when a result covers φ beyond 180° (multi/3D solvers)."""
    return float(np.max(phi_rad)) > np.pi + 1e-6


def principal_cut_indices(phi_rad: np.ndarray) -> tuple:
    """Indices of the φ samples nearest 0° (E-plane) and 90° (H-plane).

    Single-antenna solvers return exactly [0°, 90°]; full-sphere results
    (multi-patch scenes) sample many φ, so pick the nearest cuts
    (reference renders cuts the same way: gui_app.py:1113-1149).
    """
    return (
        int(np.argmin(np.abs(phi_rad - 0.0))),
        int(np.argmin(np.abs(phi_rad - np.pi / 2))),
    )


def polar_cut(res, phi0_rad: float):
    """(angles, values) for a full 0–2π polar cut at azimuth ``phi0``.

    Full-sphere results stitch the REAL φ=phi0 and φ=phi0+180° columns —
    mirroring the half-cut would fabricate a symmetric pattern the data
    contradicts (a microstrip-fed patch's E-plane is genuinely
    asymmetric). Two-cut results mirror the half-cut, the only data
    available.
    """
    from ..viz.patterns import mirror_half_cut

    phi = np.asarray(res.phi, float)
    theta = np.asarray(res.theta, float)
    grid = np.asarray(res.intensity, float)
    if is_full_sphere(phi):
        ph_w = (phi + 2 * np.pi) % (2 * np.pi)
        i0 = int(np.argmin(np.abs(ph_w - (phi0_rad % (2 * np.pi)))))
        i1 = int(np.argmin(np.abs(ph_w - ((phi0_rad + np.pi) % (2 * np.pi)))))
        ang = np.concatenate([theta, (2 * np.pi - theta)[::-1]])
        val = np.concatenate([grid[:, i0], grid[::-1, i1]])
        return ang, val
    idx = principal_cut_indices(phi)
    col = idx[0] if abs(phi0_rad) < 1e-6 else idx[1]
    return mirror_half_cut(theta, grid[:, col])


def pattern_grid_for_plot(res):
    """(theta, phi_full, grid_db) for a 3D surface render.

    Full-sphere results plot directly; two-cut results are interpolated
    around φ the way the reference GUI does (gui_app.py:1151-1348).
    """
    from ..viz.patterns import interpolate_cuts_to_sphere

    if is_full_sphere(res.phi):
        return res.theta, res.phi, np.asarray(res.intensity)
    phi_full, grid_db = interpolate_cuts_to_sphere(
        res.intensity[:, 0], res.intensity[:, 1]
    )
    return res.theta, phi_full, grid_db


def apply_norm_mode(grid_db: np.ndarray, mode: str) -> np.ndarray:
    """Apply the 3D-scale normalization mode (reference '3D scale'
    combobox, gui_app.py:239-256): 'dBi' passes absolute values through,
    'Normalized' shifts the peak to 0 dB."""
    grid_db = np.asarray(grid_db, float)
    if mode.lower().startswith("norm"):
        return grid_db - float(np.max(grid_db))
    return grid_db


def format_progress(steps_done: int, n_steps_max: int,
                    e_ratio: float) -> tuple:
    """(percent, status text) for a run-progress tick.

    Feeds the GUI progress bar and the webapp's ``st.progress`` from the
    engine's ``progress_cb(steps_done, n_steps_max, e_ratio)`` contract
    (PreparedSimulation.run). The energy ratio is the termination
    quantity, so showing it tells the user how close the ring-down is.
    """
    pct = 100.0 * steps_done / max(int(n_steps_max), 1)
    pct = min(100.0, max(0.0, pct))
    text = (
        f"step {steps_done}/{n_steps_max} ({pct:.0f}%) — "
        f"energy {e_ratio:.1e}"
    )
    return pct, text


#: sidebar solver choices → solver keys (reference offers 3 solver types,
#: gui_app.py:174-178; we add the legacy + quasi-2D families the
#: reference only exposes through Streamlit)
SOLVER_CHOICES = (
    ("fixed", "Simple (Lumped Port)"),
    ("microstrip", "Microstrip Fed"),
    ("microstrip_3d", "Microstrip Fed (3D sphere)"),
    ("legacy", "Legacy 3D (PML)"),
    ("2d", "Quasi-2D (fast)"),
)


def dispatch_prepare(
    params,
    solver_kind: str,
    *,
    feed: str = "-X",
    boundary: str = "MUR",
    theta_step_deg: float = 2.0,
    phi_step_deg: float = 5.0,
    device="cuda",
    **kw,
):
    """Prepare the selected solver on ``device``; returns
    ``(prepared, runner_fn)``.

    Maps each GUI control onto the solver it affects (θ step →
    microstrip/3D NF2FF grid, φ step → 3D sphere sampling, boundary →
    fixed/microstrip, feed → microstrip family). Extra ``kw`` (e.g.
    ``n_steps_max``) pass through to the prepare function.
    """
    from ..solvers.microstrip import (
        FeedDirection,
        prepare_microstrip_patch,
        run_prepared_microstrip,
    )
    from ..solvers.microstrip_3d import (
        prepare_microstrip_patch_3d,
        run_prepared_microstrip_3d,
    )
    from ..solvers.patch_2d import prepare_patch_2d, run_prepared_2d
    from ..solvers.patch_fixed import prepare_patch_fixed, run_prepared_fixed
    from ..solvers.patch_legacy import (
        prepare_patch_legacy,
        run_prepared_legacy,
    )

    if solver_kind == "microstrip":
        prep = prepare_microstrip_patch(
            params, feed_direction=FeedDirection(feed), boundary=boundary,
            theta_step_deg=theta_step_deg, device=device, **kw,
        )
        return prep, run_prepared_microstrip
    if solver_kind == "microstrip_3d":
        prep = prepare_microstrip_patch_3d(
            params, feed_direction=FeedDirection(feed), boundary=boundary,
            theta_step_deg=theta_step_deg, phi_step_deg=phi_step_deg,
            device=device, **kw,
        )
        return prep, run_prepared_microstrip_3d
    if solver_kind == "legacy":
        prep = prepare_patch_legacy(params, device=device, **kw)
        return prep, run_prepared_legacy
    if solver_kind == "2d":
        prep = prepare_patch_2d(params, device=device, **kw)
        return prep, run_prepared_2d
    prep = prepare_patch_fixed(params, boundary=boundary, device=device, **kw)
    return prep, run_prepared_fixed


def runner_kwargs(runner, progress_cb=None, abort_cb=None) -> dict:
    """The callbacks ``runner`` accepts, by its signature: live progress
    and mid-flight abort for the runners that take them (the worker
    thread's wiring)."""
    import inspect

    kw = {}
    try:
        sig = inspect.signature(runner)
        if progress_cb is not None and "progress_cb" in sig.parameters:
            kw["progress_cb"] = progress_cb
        if abort_cb is not None and "abort_cb" in sig.parameters:
            kw["abort_cb"] = abort_cb
    except (TypeError, ValueError):
        pass
    return kw


def format_port_diagnostics(res) -> list:
    """Structured lines for the Port Diagnostics pane
    (reference pane: gui_app.py:330-441, fed by multi_3d log_cb
    messages; single runs get a per-port summary)."""
    lines = []
    if res.f_res_hz:
        lines.append(f"resonance: {res.f_res_hz / 1e9:.4f} GHz")
    d = res.diagnostics or {}
    if d.get("s11_db_at_res") is not None:
        lines.append(f"S11 at resonance: {d['s11_db_at_res']:.2f} dB")
    if res.z_in is not None and res.freq is not None and res.f_res_hz:
        i = int(np.argmin(np.abs(np.asarray(res.freq) - res.f_res_hz)))
        z = complex(np.asarray(res.z_in)[i])
        lines.append(f"Z_in at resonance: {z.real:.1f} {z.imag:+.1f}j Ω")
    if res.radiation_efficiency is not None:
        conv = d.get("rad_eff_converged", True)
        flag = "" if conv else "  [NOT CONVERGED — lower bound]"
        lines.append(
            f"radiation efficiency: {res.radiation_efficiency:.1%}{flag}"
        )
    if d.get("energy_ratio") is not None:
        lines.append(f"energy decay ratio: {d['energy_ratio']:.2e}")
    if res.steps_run:
        lines.append(
            f"{res.steps_run} steps, {res.wall_time_s:.2f} s, "
            f"{res.mcells_per_s:.0f} Mcells/s"
        )
    return lines


def apply_sim_controls(scene, values: dict) -> Optional[str]:
    """Apply the Scene tab's simulation-control values onto
    ``scene.controls`` (SimControls). Returns an error string or None.

    Accepted keys: theta_step_deg, phi_step_deg, mesh_quality,
    end_criteria_db, nf_center_mode, boundary, simbox_mode,
    manual_size_mm (3-tuple). Mirrors multi_patch_designer.py:291-465.
    """
    c = scene.controls
    try:
        if "theta_step_deg" in values:
            c.theta_step_deg = max(0.5, float(values["theta_step_deg"]))
        if "phi_step_deg" in values:
            c.phi_step_deg = max(1.0, float(values["phi_step_deg"]))
        if "mesh_quality" in values:
            c.mesh_quality = max(1, min(10, int(values["mesh_quality"])))
        if "end_criteria_db" in values:
            # reference clamp contract: multi_3d.py:275-282
            c.end_criteria_db = max(-80.0, min(-10.0, float(values["end_criteria_db"])))
        if "nf_center_mode" in values:
            mode = str(values["nf_center_mode"])
            if mode not in ("origin", "centroid"):
                return f"bad NF2FF center mode: {mode}"
            c.nf_center_mode = mode
        if "boundary" in values:
            b = str(values["boundary"])
            if b not in ("MUR", "PML_8"):
                return f"bad boundary: {b}"
            c.boundary = b
        if "simbox_mode" in values:
            m = str(values["simbox_mode"])
            if m not in ("auto", "manual"):
                return f"bad sim-box mode: {m}"
            c.simbox_mode = m
        if "manual_size_mm" in values and values["manual_size_mm"] is not None:
            size = tuple(float(v) for v in values["manual_size_mm"])
            if len(size) != 3 or any(v <= 0 for v in size):
                return "manual sim-box size must be 3 positive numbers (mm)"
            c.manual_size_mm = size
    except (TypeError, ValueError) as e:
        return f"bad control value: {e}"
    return None


def apply_instance_fields(scene, inst, values: dict) -> Optional[str]:
    """Apply per-instance placement/orientation/feed edits
    (multi_patch_designer.py:1449-1547 per-field apply). Keys:
    x_mm, y_mm, z_mm, rot_x_deg, rot_y_deg, rot_z_deg, feed_direction."""
    from ..solvers.microstrip import FeedDirection

    try:
        batch = {}
        for key, attr, scale in (
            ("x_mm", "center_x_m", 1e-3),
            ("y_mm", "center_y_m", 1e-3),
            ("z_mm", "center_z_m", 1e-3),
            ("rot_x_deg", "rot_x_deg", 1.0),
            ("rot_y_deg", "rot_y_deg", 1.0),
            ("rot_z_deg", "rot_z_deg", 1.0),
        ):
            if key in values:
                batch[attr] = float(values[key]) * scale
        if "feed_direction" in values:
            if not hasattr(inst, "feed_direction"):
                return "horns have no feed direction"
            batch["feed_direction"] = FeedDirection(
                str(values["feed_direction"]))
        # one notification for the whole apply (one preview re-render)
        scene.update_fields(inst, batch)
    except (TypeError, ValueError) as e:
        return f"bad instance value: {e}"
    return None


def default_horn_params_for(frequency_hz: float):
    """Reasonable pyramidal-horn defaults scaled to the design frequency
    (throat above TE10 cutoff, ~15 dBi aperture)."""
    from ..models.params import HornAntennaParams

    lam_mm = 299792458.0 / frequency_hz * 1e3
    return HornAntennaParams.from_user_units(
        frequency_ghz=frequency_hz / 1e9,
        throat_a_mm=0.7 * lam_mm,
        throat_b_mm=0.35 * lam_mm,
        aperture_A_mm=1.6 * lam_mm,
        aperture_B_mm=1.2 * lam_mm,
        length_mm=1.0 * lam_mm,
    )


def open_scene_3d_view(scene, path: Optional[str] = None) -> str:
    """Write the interactive scene HTML and return its path (the GUI
    opens it in the default browser). Portable replacement for the
    reference's PyVista view (gui_app.py:1352-2480)."""
    import tempfile

    from ..viz.scene3d import save_scene_html, scene_meshes

    if path is None:
        # unique per call: a fixed name in the shared temp dir can be
        # pre-owned (or symlinked) by another user and two GUI windows
        # would clobber each other's view
        with tempfile.NamedTemporaryFile(
            prefix="antenna_scene_3d_", suffix=".html", delete=False
        ) as f:
            path = f.name
    return save_scene_html(scene_meshes(scene), path)


def main(device="cuda") -> None:  # pragma: no cover — needs a display
    import tkinter as tk
    import webbrowser
    from tkinter import ttk

    import matplotlib

    matplotlib.use("TkAgg")
    import matplotlib.pyplot as plt
    from matplotlib.backends.backend_tkagg import FigureCanvasTkAgg

    from ..models.params import PatchAntennaParams
    from ..solvers.analytical import AnalyticalPatchSolver
    from ..viz.patterns import mirror_half_cut
    from .designer import MultiPatchScene

    root = tk.Tk()
    root.title(f"Patch Antenna Simulator — FDTD on {device}")
    root.configure(bg=ModernStyle.BG)
    root.geometry("1380x900")

    style = ttk.Style(root)
    try:
        style.theme_use("clam")
    except Exception:
        pass
    style.configure("TFrame", background=ModernStyle.BG)
    style.configure(
        "TLabel", background=ModernStyle.BG, foreground=ModernStyle.FG
    )
    style.configure("TButton", background=ModernStyle.PANEL)
    style.configure("TNotebook", background=ModernStyle.BG)

    # ---------------- sidebar ------------------------------------------
    side = ttk.Frame(root, padding=10)
    side.pack(side="left", fill="y")

    fields = {}

    def add_field(label, default, parent=None):
        parent = parent or side
        ttk.Label(parent, text=label).pack(anchor="w")
        var = tk.StringVar(value=str(default))
        ttk.Entry(parent, textvariable=var, width=14).pack(anchor="w", pady=2)
        fields[label] = var
        return var

    def add_combo(label, default, values, parent=None):
        parent = parent or side
        ttk.Label(parent, text=label).pack(anchor="w")
        var = tk.StringVar(value=default)
        ttk.Combobox(
            parent, textvariable=var, width=18, values=list(values),
            state="readonly",
        ).pack(anchor="w", pady=2)
        return var

    add_field("Frequency (GHz)", 2.45)
    add_field("Substrate εr", 4.3)
    add_field("Substrate h (mm)", 1.6)
    add_field("Loss tangent", 0.02)
    metal_var = add_combo(
        "Metal", "copper", ["copper", "aluminum", "gold", "silver", "tin"]
    )
    solver_labels = {label: key for key, label in SOLVER_CHOICES}
    solver_var = add_combo(
        "Solver", SOLVER_CHOICES[0][1], [label for _, label in SOLVER_CHOICES]
    )
    feed_var = add_combo("Feed direction", "-X", ["-X", "+X", "-Y", "+Y"])
    bc_var = add_combo("Boundary", "MUR", ["MUR", "PML_8"])
    add_field("θ step (deg)", 2.0)
    add_field("φ step (deg)", 5.0)
    norm_var = add_combo("3D scale", "dBi", ["dBi", "Normalized"])

    run_btn = ttk.Button(side, text="Run FDTD")
    run_btn.pack(fill="x", pady=10)
    status_var = tk.StringVar(value="ready")
    ttk.Label(side, textvariable=status_var, wraplength=150).pack(anchor="w")

    # Port Diagnostics pane (reference: gui_app.py:330-441)
    ttk.Label(side, text="Port Diagnostics").pack(anchor="w", pady=(10, 0))
    diag_text = tk.Text(
        side, height=10, width=26, bg=ModernStyle.CONSOLE_BG,
        fg=ModernStyle.WARN, font=("monospace", 8), state="disabled",
    )
    diag_text.pack(anchor="w", pady=2)

    def set_diagnostics(lines):
        diag_text.configure(state="normal")
        diag_text.delete("1.0", "end")
        diag_text.insert("1.0", "\n".join(lines))
        diag_text.configure(state="disabled")

    diag_lines: list = []

    def diag_cb(msg):  # log_cb bridge — called from worker threads
        diag_lines.append(str(msg))
        root.after(0, lambda: set_diagnostics(diag_lines[-40:]))

    # ---------------- log console --------------------------------------
    log = LogCoalescer()
    log_text = tk.Text(
        root, height=8, bg=ModernStyle.CONSOLE_BG,
        fg=ModernStyle.CONSOLE_FG, font=("monospace", 9),
    )
    log_text.pack(side="bottom", fill="x")

    def refresh_log():
        log_text.delete("1.0", "end")
        log_text.insert("1.0", "\n".join(log.lines[-200:]))
        log_text.see("end")

    # ---------------- plot tabs ----------------------------------------
    tabs = ttk.Notebook(root)
    tabs.pack(side="right", fill="both", expand=True)
    canvases = {}
    for name in ("Geometry", "S11", "Cuts", "3D Pattern"):
        frame = ttk.Frame(tabs)
        tabs.add(frame, text=name)
        fig = plt.Figure(figsize=(7, 6))
        canvas = FigureCanvasTkAgg(fig, master=frame)
        canvas.get_tk_widget().pack(fill="both", expand=True)
        canvases[name] = (fig, canvas)

    def show_fig(name, draw):
        fig, canvas = canvases[name]
        fig.clf()
        draw(fig)
        canvas.draw_idle()

    # ---------------- scene (multi-antenna) tab --------------------------
    # Designer-backed parity with the reference's multi mode
    # (gui_app.py:2752-2848 runs the multi_3d solver; the scene model is
    # our MultiPatchScene instead of a 1600-line Tk widget).
    scene = MultiPatchScene(device=device)
    scene_frame = ttk.Frame(tabs, padding=6)
    tabs.add(scene_frame, text="Scene")
    scene_left = ttk.Frame(scene_frame)
    scene_left.pack(side="left", fill="y", padx=(0, 8))

    inst_list = tk.Listbox(
        scene_left, height=6, width=24, bg=ModernStyle.PANEL,
        fg=ModernStyle.FG,
    )
    inst_list.pack(anchor="w", pady=2)

    def scene_instances():
        return scene.patches + scene.horns

    def refresh_instances():
        # preserve the selection: every scene change rebuilds the list,
        # and losing it forced a re-select after each "Apply placement"
        sel = inst_list.curselection()
        inst_list.delete(0, "end")
        for inst in scene_instances():
            inst_list.insert("end", inst.name)
        if sel and sel[0] < inst_list.size():
            inst_list.selection_set(sel[0])

    scene_fig = plt.Figure(figsize=(6, 6))
    scene_canvas = FigureCanvasTkAgg(scene_fig, master=scene_frame)
    scene_canvas.get_tk_widget().pack(side="right", fill="both", expand=True)

    def refresh_preview():
        scene_fig.clf()
        if scene_instances():
            scene.render_preview(fig=scene_fig)
        scene_canvas.draw_idle()

    scene.set_change_callback(
        lambda: (refresh_instances(), refresh_preview())
    )

    def selected_instance():
        sel = inst_list.curselection()
        if not sel:
            return None
        return scene_instances()[sel[0]]

    def on_add_patch():
        try:
            scene.add_patch(params_from_ui())
        except ValueError as e:
            status_var.set(f"bad input: {e}")

    def on_add_horn():
        try:
            f_ghz = float(fields["Frequency (GHz)"].get())
            scene.add_horn(default_horn_params_for(f_ghz * 1e9))
        except ValueError as e:
            status_var.set(f"bad input: {e}")

    def on_remove():
        inst = selected_instance()
        if inst is not None:
            scene.remove(inst)

    btn_row = ttk.Frame(scene_left)
    btn_row.pack(anchor="w", pady=4)
    ttk.Button(btn_row, text="+ Patch", command=on_add_patch, width=8).pack(
        side="left", padx=2
    )
    ttk.Button(btn_row, text="+ Horn", command=on_add_horn, width=8).pack(
        side="left", padx=2
    )
    ttk.Button(btn_row, text="Remove", command=on_remove, width=8).pack(
        side="left", padx=2
    )

    # per-instance placement + orientation + feed direction
    # (multi_patch_designer.py:1449-1547 per-field apply)
    place_fields = {}
    place_grid = ttk.Frame(scene_left)
    place_grid.pack(anchor="w")
    for i, (lbl, default) in enumerate((
        ("x (mm)", 0.0), ("y (mm)", 0.0), ("z (mm)", 0.0),
        ("rot x (°)", 0.0), ("rot y (°)", 0.0), ("rot z (°)", 0.0),
    )):
        ttk.Label(place_grid, text=lbl).grid(row=i // 2, column=(i % 2) * 2,
                                             sticky="w")
        var = tk.StringVar(value=str(default))
        ttk.Entry(place_grid, textvariable=var, width=7).grid(
            row=i // 2, column=(i % 2) * 2 + 1, padx=2, pady=1
        )
        place_fields[lbl] = var
    inst_feed_var = add_combo(
        "Instance feed dir", "-X", ["-X", "+X", "-Y", "+Y"], parent=scene_left
    )

    def on_apply_placement():
        inst = selected_instance()
        if inst is None:
            status_var.set("select an instance first")
            return
        values = dict(
            x_mm=place_fields["x (mm)"].get(),
            y_mm=place_fields["y (mm)"].get(),
            z_mm=place_fields["z (mm)"].get(),
            rot_x_deg=place_fields["rot x (°)"].get(),
            rot_y_deg=place_fields["rot y (°)"].get(),
            rot_z_deg=place_fields["rot z (°)"].get(),
        )
        if hasattr(inst, "feed_direction"):
            values["feed_direction"] = inst_feed_var.get()
        err = apply_instance_fields(scene, inst, values)
        status_var.set(err or f"applied to {inst.name}")

    ttk.Button(
        scene_left, text="Apply placement", command=on_apply_placement
    ).pack(anchor="w", pady=4)

    # simulation controls block (multi_patch_designer.py:291-465)
    ctrl_grid = ttk.Frame(scene_left)
    ctrl_grid.pack(anchor="w", pady=(6, 0))
    ctrl_fields = {}
    for i, (lbl, default) in enumerate((
        ("θ step", 2.0), ("φ step", 5.0),
        ("mesh q", 3), ("end dB", -25.0),
        ("box x", 0.0), ("box y", 0.0), ("box z", 0.0),
    )):
        ttk.Label(ctrl_grid, text=lbl).grid(row=i // 2, column=(i % 2) * 2,
                                            sticky="w")
        var = tk.StringVar(value=str(default))
        ttk.Entry(ctrl_grid, textvariable=var, width=7).grid(
            row=i // 2, column=(i % 2) * 2 + 1, padx=2, pady=1
        )
        ctrl_fields[lbl] = var
    nf_var = add_combo("NF2FF center", "origin", ["origin", "centroid"],
                       parent=scene_left)
    scene_bc_var = add_combo("Scene boundary", "MUR", ["MUR", "PML_8"],
                             parent=scene_left)
    simbox_var = add_combo("Sim box", "auto", ["auto", "manual"],
                           parent=scene_left)

    def collect_sim_controls():
        values = dict(
            theta_step_deg=ctrl_fields["θ step"].get(),
            phi_step_deg=ctrl_fields["φ step"].get(),
            mesh_quality=ctrl_fields["mesh q"].get(),
            end_criteria_db=ctrl_fields["end dB"].get(),
            nf_center_mode=nf_var.get(),
            boundary=scene_bc_var.get(),
            simbox_mode=simbox_var.get(),
        )
        if simbox_var.get() == "manual":
            values["manual_size_mm"] = (
                ctrl_fields["box x"].get(), ctrl_fields["box y"].get(),
                ctrl_fields["box z"].get(),
            )
        return values

    def on_open_3d():
        if not scene_instances():
            status_var.set("scene is empty — add instances first")
            return
        path = open_scene_3d_view(scene)
        webbrowser.open(f"file://{path}")
        status_var.set(f"3D view: {path}")

    ttk.Button(scene_left, text="Open 3D view", command=on_open_3d).pack(
        fill="x", pady=(6, 2)
    )
    scene_run_btn = ttk.Button(scene_left, text="Run Scene FDTD")
    scene_run_btn.pack(fill="x", pady=4)
    scene_progress = ttk.Progressbar(scene_left, maximum=100.0)
    scene_progress.pack(fill="x", pady=(0, 2))
    cancel_btn = ttk.Button(scene_left, text="Cancel Run", state="disabled")
    cancel_btn.pack(fill="x", pady=(0, 4))
    abort_event = threading.Event()

    def on_cancel():
        abort_event.set()
        status_var.set("cancelling… (finishes the in-flight chunk)")

    cancel_btn.configure(command=on_cancel)

    def post_progress(steps_done, n_steps_max, e_ratio):
        """Engine progress_cb — runs on the sim thread, so marshal the
        UI mutation through root.after (the reference's thread contract,
        gui_app.py:2700-2705)."""
        pct, text = format_progress(steps_done, n_steps_max, e_ratio)

        def apply():
            scene_progress.configure(value=pct)
            status_var.set(f"running scene… {text}")

        root.after(0, apply)

    def params_from_ui():
        return PatchAntennaParams.from_user_units(
            frequency_ghz=float(fields["Frequency (GHz)"].get()),
            er=float(fields["Substrate εr"].get()),
            h_mm=float(fields["Substrate h (mm)"].get()),
            loss_tangent=float(fields["Loss tangent"].get()),
            metal=metal_var.get(),
        )

    def update_geometry():
        params = params_from_ui()
        solver = AnalyticalPatchSolver(params)

        def build(fig):
            ax = fig.add_subplot(111, projection="3d")
            from ..viz.plotting import _add_box

            mm = 1e3
            L, W, h = solver.L_m * mm, solver.W_m * mm, params.h_m * mm
            margin = max(5.0, 0.2 * max(L, W))
            _add_box(ax, (-W / 2 - margin, -L / 2 - margin, -h / 5),
                     (W / 2 + margin, L / 2 + margin, 0), "#c9a227", 0.8)
            _add_box(ax, (-W / 2 - margin, -L / 2 - margin, 0),
                     (W / 2 + margin, L / 2 + margin, h), "#2d6a4f", 0.5)
            _add_box(ax, (-W / 2, -L / 2, h), (W / 2, L / 2, h * 1.2),
                     "#e07a1f", 0.95)
            lim = max(L, W)
            ax.set_xlim(-lim, lim)
            ax.set_ylim(-lim, lim)
            ax.set_zlim(-lim / 4, lim / 2)
            ax.set_title(f"Patch {W:.1f} × {L:.1f} mm on h={h:.2f} mm")

        show_fig("Geometry", build)

    result_q: "queue.Queue" = queue.Queue()

    def worker(params, solver_kind, feed, boundary, theta_step, phi_step):
        try:
            log.append("prepare: building mesh + simulation…")
            prep, runner = dispatch_prepare(
                params, solver_kind, feed=feed, boundary=boundary,
                theta_step_deg=theta_step, phi_step_deg=phi_step,
                device=device,
            )
            if not prep.ok:
                result_q.put(("error", prep.message, "single"))
                return
            log.append("run: time-stepping…")
            # wire live progress + mid-flight abort when the runner
            # supports them
            kw = runner_kwargs(runner, post_progress, abort_event.is_set)
            res = runner(
                prep, frequency_hz=params.frequency_hz, verbose=0, **kw
            )
            result_q.put(("done", res, "single"))
        except Exception as e:  # defensive: never kill the UI thread
            result_q.put(("error", str(e), "single"))

    active_runs: set = set()

    def poll_results():
        try:
            kind, payload, tag = result_q.get_nowait()
        except queue.Empty:
            refresh_log()  # live log during long runs (step coalescing)
            root.after(200, poll_results)
            return
        # reset only the finished run's controls: completing the single
        # run must not re-enable / un-cancel a still-running scene run
        active_runs.discard(tag)
        if tag == "single":
            run_btn.state(["!disabled"])
        else:
            scene_run_btn.state(["!disabled"])
            scene_progress.configure(value=0.0)
        if not active_runs:
            cancel_btn.state(["disabled"])
        if kind == "error":
            status_var.set(f"failed: {payload}")
            log.append(f"ERROR: {payload}")
            refresh_log()
            return
        res = payload
        status_var.set(
            f"done: {res.steps_run} steps, {res.mcells_per_s:.0f} Mcells/s, "
            f"f_res {res.f_res_hz / 1e9:.3f} GHz"
        )
        log.append(
            f"step {res.steps_run}: finished in {res.wall_time_s:.2f}s"
        )
        refresh_log()
        diag_lines.extend(format_port_diagnostics(res))
        set_diagnostics(diag_lines[-40:])

        def build_s11(fig):
            ax = fig.add_subplot(111)
            db = 20 * np.log10(np.maximum(np.abs(res.s11), 1e-12))
            ax.plot(res.freq / 1e9, db)
            ax.axhline(-10, ls="--", c="gray")
            ax.set_xlabel("f (GHz)")
            ax.set_ylabel("|S11| (dB)")
            ax.grid(alpha=0.4)

        show_fig("S11", build_s11)

        def build_cuts(fig):
            for i, (col, title, ph0) in enumerate(
                (("#0b7285", "E-plane φ=0°", 0.0),
                 ("#c2255c", "H-plane φ=90°", np.pi / 2))
            ):
                ax = fig.add_subplot(1, 2, i + 1, projection="polar")
                th, v = polar_cut(res, ph0)
                ax.plot(th, v, color=col, lw=2)
                ax.set_title(title)
                ax.set_theta_zero_location("N")

        show_fig("Cuts", build_cuts)

        def build_3d(fig):
            theta, phi_full, grid_db = pattern_grid_for_plot(res)
            grid_db = apply_norm_mode(grid_db, norm_var.get())
            ax = fig.add_subplot(111, projection="3d")
            thg, phg = np.meshgrid(theta, phi_full, indexing="ij")
            lin = 10 ** ((grid_db - grid_db.max()) / 20.0)
            x = lin * np.sin(thg) * np.cos(phg)
            y = lin * np.sin(thg) * np.sin(phg)
            z = lin * np.cos(thg)
            norm = (grid_db - grid_db.min()) / max(
                1e-9, grid_db.max() - grid_db.min()
            )
            ax.plot_surface(
                x, y, z, facecolors=plt.cm.turbo(norm), rstride=1,
                cstride=1, linewidth=0, shade=False,
            )
            ax.set_box_aspect([1, 1, 1])
            unit = "dBi" if norm_var.get() == "dBi" else "dB (normalized)"
            ax.set_title(
                f"3D pattern, peak {grid_db.max():.1f} {unit} "
                f"(Dmax {10 * np.log10(res.Dmax):.1f} dBi)"
            )

        show_fig("3D Pattern", build_3d)

    def on_run():
        try:
            params = params_from_ui()
            theta_step = float(fields["θ step (deg)"].get())
            phi_step = float(fields["φ step (deg)"].get())
        except ValueError as e:
            status_var.set(f"bad input: {e}")
            return
        update_geometry()  # the Geometry tab must match what is run
        run_btn.state(["disabled"])
        if not active_runs:
            abort_event.clear()
        active_runs.add("single")
        cancel_btn.state(["!disabled"])
        status_var.set("running…")
        threading.Thread(
            target=worker,
            args=(params, solver_labels[solver_var.get()], feed_var.get(),
                  bc_var.get(), theta_step, phi_step),
            daemon=True,
        ).start()
        root.after(200, poll_results)

    def scene_worker():
        try:
            log.append("scene prepare: voxelizing + building…")
            res = scene.simulate(
                log_cb=diag_cb,
                progress_cb=post_progress,
                abort_cb=abort_event.is_set,
            )
            if not res.ok:  # failed prepare, failed run, or user abort
                result_q.put(("error", res.message, "scene"))
            else:
                result_q.put(("done", res, "scene"))
        except Exception as e:  # defensive: never kill the UI thread
            result_q.put(("error", str(e), "scene"))

    def on_run_scene():
        if not scene_instances():
            status_var.set("scene is empty — add instances first")
            return
        err = apply_sim_controls(scene, collect_sim_controls())
        if err:
            status_var.set(err)
            return
        scene_run_btn.state(["disabled"])
        if not active_runs:
            abort_event.clear()
        active_runs.add("scene")
        cancel_btn.state(["!disabled"])
        scene_progress.configure(value=0.0)
        status_var.set("running scene…")
        threading.Thread(target=scene_worker, daemon=True).start()
        root.after(200, poll_results)

    run_btn.configure(command=on_run)
    scene_run_btn.configure(command=on_run_scene)
    update_geometry()
    root.mainloop()


if __name__ == "__main__":
    main()
