"""Streamlit web UI (reference parity: ``streamlit_app.py:1-469``).

Counterpart of ``fdtd_solver_antennas_tpu/frontends/webapp.py`` on the
port: every prepare and run of ``main(device=...)`` is on the card by
default. Run from the repository root with:

    streamlit run fdtd_solver_antennas_tpu_torch/frontends/webapp.py

Parity flows:
- sidebar parameter inputs (frequency, εr, h, L/W overrides, metal, tanδ);
- instant analytical pattern + metric tiles (L, W, D0, G0, η — :116-123);
- fixed-solver prepare / run buttons with ``st.session_state`` caching of
  the prepared simulation (:25-28, 222-344) — here "prepare" builds the
  simulation on the card (and the kernels at their first use) and "run"
  steps it, so the two-phase flow is preserved;
- legacy 3D + quasi-2D prepare/run panels with mode select and session
  cache (:146-220), rendering φ = 0°/90° polar cuts with the reference's
  ``normalize_and_bounds`` scaling — which the reference defines but never
  uses (:215-220, dead code / truncated feature); here it is wired up;
- the side-by-side "Compare with Analytical Solution" expander after
  every FDTD result (:339-344) — the reference's signature validation UX;
- pattern-analysis tiles with the dynamic-range classification (:268-290);
- E/H-cut → full-sphere interpolated 3D surface (:346-469);
- an interactive 3D scene view (viz/scene3d.py) replacing the reference's
  Windows-only PyVista embedding (gui_app.py:1352-2480);
- an Array tab (beyond the reference): nx×ny embedded-pattern extraction
  with live progress + abort, S-matrix plot, and interactive beam steering
  on the shared ``design_array``/``array_run_summary`` workflow.

Unlike the reference's abort flag (which could only prevent a run from
*starting*, :165-168), FDTD runs execute on a background thread
(:class:`BackgroundRun`) with a live progress bar and a Stop button that
cancels mid-flight through the engine's ``abort_cb`` hook — the UI polls
the thread via ``st.rerun`` so the button stays responsive during the run.

Streamlit is an optional dependency: importing this module without it
raises a clear error only from ``main()``; the module-level helpers are
headless and unit-tested (tests/test_torch_frontends.py).
"""

from __future__ import annotations

import threading
from typing import Tuple

import numpy as np


# ---------------------------------------------------------------------------
# headless helpers (unit-tested; streamlit not required)
# ---------------------------------------------------------------------------

#: the reference's legacy-panel mode names (streamlit_app.py:61)
LEGACY_MODES = ("2D (fast)", "3D legacy (full)")


def touchstone_bytes(freq_hz, s, z_ref=50.0) -> bytes:
    """Touchstone v1 text for a download button (1-port or N-port).
    The reference webapp has no data export of any kind."""
    from ..post.touchstone import format_touchstone

    text, _ = format_touchstone(freq_hz, s, z_ref=z_ref)
    return text.encode()


def _show(fig) -> None:
    """st.pyplot + close: the polling background-run loop reruns the
    script ~2.5×/s, and figures left in matplotlib's global registry
    accumulate without bound in the long-lived server process.
    (Imports are local: streamlit/matplotlib are gated dependencies.)"""
    import matplotlib.pyplot as plt
    import streamlit as st

    st.pyplot(fig)
    plt.close(fig)


def normalize_and_bounds(curve) -> Tuple[np.ndarray, float, float]:
    """Polar-plot scaling contract from the reference
    (streamlit_app.py:215-220): normalize to peak (0 dB at max), snap the
    radial minimum to 5 dB steps, clamp to [−40, 0].

    The reference defines this and then renders nothing with it (dead
    code / truncated feature, SURVEY §7); this UI actually uses it for
    the legacy/2D polar cuts.
    """
    cur = np.asarray(curve, dtype=float)
    cur = cur - float(np.max(cur))
    rmin = max(-40.0, 5.0 * np.floor(float(np.min(cur)) / 5.0))
    return cur, rmin, 0.0


def prepare_legacy_mode(params, mode: str, device="cuda", **kw):
    """Prepare the legacy-panel solver for ``mode`` (one of LEGACY_MODES)
    on ``device``.

    Mode dispatch contract: streamlit_app.py:148-152 (``mode.startswith
    ('2D')`` selects the quasi-2D prepare, else the legacy 3D one).
    """
    from ..solvers.patch_2d import prepare_patch_2d
    from ..solvers.patch_legacy import prepare_patch_legacy

    if mode.startswith("2D"):
        return prepare_patch_2d(params, device=device, **kw)
    return prepare_patch_legacy(params, device=device, **kw)


def run_legacy_mode(prepared, mode: str, *, frequency_hz: float, verbose=0):
    """Run a prepared legacy-panel simulation for ``mode``."""
    from ..solvers.patch_2d import run_prepared_2d
    from ..solvers.patch_legacy import run_prepared_legacy

    if mode.startswith("2D"):
        return run_prepared_2d(
            prepared, frequency_hz=frequency_hz, verbose=verbose
        )
    return run_prepared_legacy(
        prepared, frequency_hz=frequency_hz, verbose=verbose
    )


def plane_cuts_dbi(result) -> Tuple[np.ndarray, np.ndarray]:
    """(ZX-plane cut, ZY-plane cut) in dB, from a solver result's
    (θ, φ) intensity grid — φ nearest 0° and 90° (streamlit_app.py:
    205-212 plane extraction)."""
    arr = np.asarray(result.intensity, dtype=float)
    ph = np.asarray(result.phi, dtype=float)
    ph_wrapped = (ph + 2 * np.pi) % (2 * np.pi)
    zx = int(np.argmin(np.abs(ph_wrapped - 0.0)))
    zy = int(np.argmin(np.abs(ph_wrapped - np.pi / 2)))
    return arr[:, zx], arr[:, zy]


class BackgroundRun:
    """Threaded solver run with live progress and mid-flight abort.

    Streamlit reruns the whole script on every widget event, so a
    blocking solver call would freeze the Stop button until completion
    (exactly the reference's broken abort, streamlit_app.py:165-168).
    Instead the run executes on a daemon thread; the script polls
    ``progress``/``running`` each rerun and ``abort()`` flips the event
    the engine's ``abort_cb`` checks after every chunk.
    """

    def __init__(self) -> None:
        self.progress: Tuple[int, int, float] = (0, 1, 1.0)
        self.result = None
        self.error: str | None = None
        self._abort = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self, fn, *args, **kwargs) -> "BackgroundRun":
        """Launch ``fn(*args, progress_cb=…, abort_cb=…, **kwargs)``."""
        kwargs.setdefault("progress_cb", self._on_progress)
        kwargs.setdefault("abort_cb", self._abort.is_set)

        def work():
            try:
                self.result = fn(*args, **kwargs)
            except Exception as e:  # surface, don't kill the server
                self.error = str(e)

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()
        return self

    def _on_progress(self, done: int, total: int, ratio: float) -> None:
        self.progress = (int(done), int(total), float(ratio))

    def abort(self) -> None:
        self._abort.set()

    @property
    def aborting(self) -> bool:
        return self._abort.is_set()

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()


# ---------------------------------------------------------------------------
# the app
# ---------------------------------------------------------------------------

def main(device="cuda") -> None:  # pragma: no cover - needs streamlit
    try:
        import streamlit as st
    except ImportError as e:
        raise ImportError(
            "streamlit is not installed; `pip install streamlit` to use the "
            "web UI. All functionality is also available via the CLI "
            "(python -m fdtd_solver_antennas_tpu_torch) and the library API."
        ) from e

    import matplotlib.pyplot as plt

    from ..models.params import PatchAntennaParams
    from ..solvers.analytical import AnalyticalPatchSolver
    from ..solvers.patch_fixed import (
        prepare_patch_fixed,
        probe_fdtd,
        run_prepared_fixed,
    )
    from ..viz.patterns import classify_pattern, interpolate_cuts_to_sphere
    from ..viz.plotting import (
        draw_patch_3d_geometry,
        plot_3d_pattern_from_grid,
        plot_cross_sections,
    )
    from ..viz.scene3d import patch_scene_meshes, scene_html

    st.set_page_config(page_title="Patch Antenna Simulator (PyTorch / CUDA)",
                       layout="wide")
    st.title(f"Patch Antenna Simulator — FDTD on {device}")

    for key in ("prepared_fixed", "prepared_legacy", "legacy_mode",
                "fixed_run", "fixed_result", "array_run", "array_design"):
        if key not in st.session_state:
            st.session_state[key] = None

    with st.sidebar:
        st.header("Antenna parameters")
        frequency_ghz = st.number_input("Frequency (GHz)", 0.1, 100.0, 2.45)
        er = st.number_input("Substrate εr", 1.01, 12.0, 4.3)
        h_mm = st.number_input("Substrate h (mm)", 0.1, 10.0, 1.6)
        loss_tangent = st.number_input("Loss tangent", 0.0, 0.2, 0.02)
        metal = st.selectbox(
            "Metal", ["copper", "aluminum", "gold", "silver", "tin"]
        )
        use_custom = st.checkbox("Custom patch dimensions")
        L_mm = st.number_input("L (mm)", 1.0, 500.0, 29.1) if use_custom else None
        W_mm = st.number_input("W (mm)", 1.0, 500.0, 37.6) if use_custom else None

        st.header("Legacy FDTD")
        st.info("Tip: start with 2D (fast) to sanity-check ports and "
                "fields, then run 3D (full).")
        legacy_mode = st.selectbox("Mode", list(LEGACY_MODES), index=0)
        cl1, cl2 = st.columns(2)
        prep_legacy_btn = cl1.button("⚙️ Prepare legacy")
        run_legacy_btn = cl2.button(
            "⚡ Run legacy",
            disabled=st.session_state.prepared_legacy is None,
        )

    params = PatchAntennaParams.from_user_units(
        frequency_ghz=frequency_ghz, er=er, h_mm=h_mm, L_mm=L_mm, W_mm=W_mm,
        metal=metal, loss_tangent=loss_tangent,
    )
    solver = AnalyticalPatchSolver(params)
    summary = solver.summary()

    # metric tiles (reference :116-123)
    cols = st.columns(5)
    for col, (label, key, fmt) in zip(
        cols,
        [
            ("L", "L_mm", "{:.2f} mm"),
            ("W", "W_mm", "{:.2f} mm"),
            ("D0", "D0_dBi", "{:.2f} dBi"),
            ("G0", "G0_dBi", "{:.2f} dBi"),
            ("η", "efficiency", "{:.1%}"),
        ],
    ):
        col.metric(label, fmt.format(summary[key]))

    tab_analytical, tab_fdtd, tab_legacy, tab_array, tab_scene = st.tabs(
        ["Analytical", "FDTD (GPU)", "Legacy / 2D", "Array", "Scene 3D"]
    )

    def analytical_compare_expander():
        """'Compare with Analytical Solution' (reference :339-344)."""
        with st.expander("📈 Compare with Analytical Solution", expanded=False):
            st.write("**Expected patch antenna pattern from theory:**")
            _show(plot_cross_sections(solver))
            st.write(
                "**Note**: the analytical cavity model provides the "
                "theoretical baseline for comparison with FDTD results."
            )

    def result_tiles(result):
        label, dr = classify_pattern(result.intensity)
        m1, m2, m3, m4 = st.columns(4)
        m1.metric("Max gain", f"{result.intensity.max():.1f} dBi")
        m2.metric("Min gain", f"{result.intensity.min():.1f} dBi")
        m3.metric("Dynamic range", f"{dr:.1f} dB")
        m4.metric("Pattern type", label)
        if result.diagnostics and not result.diagnostics.get(
            "rad_eff_converged", True
        ):
            st.warning(
                "Radiation efficiency did not converge within the "
                "step budget — the reported η is a lower-bound estimate."
            )

    with tab_analytical:
        c1, c2 = st.columns(2)
        with c1:
            _show(draw_patch_3d_geometry(solver.L_m, solver.W_m, params.h_m))
        with c2:
            _show(plot_cross_sections(solver))

    with tab_fdtd:
        probe = probe_fdtd(device)
        st.caption(probe.message)
        c1, c2 = st.columns(2)
        if c1.button("Prepare simulation"):
            with st.spinner("Building mesh + simulation…"):
                st.session_state.prepared_fixed = prepare_patch_fixed(
                    params, device=device)
        prepared = st.session_state.prepared_fixed
        if prepared is not None:
            # a failed prepare must read as a failure and keep Run off
            (st.success if prepared.ok else st.error)(prepared.message)
        run_disabled = (
            prepared is None
            or not prepared.ok
            or st.session_state.fixed_run is not None
        )
        if c2.button("Run prepared", disabled=run_disabled):
            st.session_state.fixed_result = None
            st.session_state.fixed_run = BackgroundRun().start(
                run_prepared_fixed,
                st.session_state.prepared_fixed,
                frequency_hz=params.frequency_hz,
            )
            st.rerun()

        run = st.session_state.fixed_run
        if run is not None:
            if run.running:
                done, total, ratio = run.progress
                from .gui_app import format_progress

                pct, text = format_progress(done, total, ratio)
                st.progress(pct / 100.0, text=f"Time-stepping on {device} — {text}")
                if st.button("🛑 Stop run", disabled=run.aborting):
                    run.abort()
                import time as _time

                _time.sleep(0.4)  # poll cadence; reruns keep Stop responsive
                st.rerun()
            else:
                st.session_state.fixed_run = None
                if run.error is not None:
                    # persist: st.rerun() discards anything rendered in
                    # THIS script run, so an un-persisted error vanished
                    st.session_state.fixed_error = f"Run failed: {run.error}"
                else:
                    st.session_state.fixed_error = None
                    st.session_state.fixed_result = run.result
                st.rerun()

        if st.session_state.get("fixed_error"):
            st.error(st.session_state.fixed_error)
        result = st.session_state.fixed_result
        if result is not None:
            if not result.ok:
                st.error(result.message)
            else:
                st.success(
                    f"{result.steps_run} steps in {result.wall_time_s:.2f} s "
                    f"({result.mcells_per_s:.0f} Mcells/s); "
                    f"f_res = {result.f_res_hz / 1e9:.3f} GHz"
                )
                # S11 sweep
                s11_db = 20 * np.log10(np.maximum(np.abs(result.s11), 1e-12))
                fig, ax = plt.subplots(figsize=(8, 3))
                ax.plot(result.freq / 1e9, s11_db)
                ax.axhline(-10, ls="--", c="gray")
                ax.set_xlabel("f (GHz)")
                ax.set_ylabel("|S11| (dB)")
                ax.grid(alpha=0.4)
                _show(fig)
                st.download_button(
                    "Download S11 (Touchstone .s1p)",
                    touchstone_bytes(result.freq, result.s11),
                    file_name="patch_s11.s1p",
                    mime="text/plain",
                )

                # pattern tiles (reference :268-290)
                result_tiles(result)

                # E/H cuts → interpolated full sphere; shares the GUI's
                # helper (incl. its full-sphere guard) instead of an
                # inline copy of the cut-selection convention
                from .gui_app import pattern_grid_for_plot

                theta_g, phi_full, grid_db = pattern_grid_for_plot(result)
                _show(
                    plot_3d_pattern_from_grid(
                        theta_g,
                        phi_full,
                        10 ** (grid_db / 10.0),
                        colors_db=grid_db,
                        L_m=solver.L_m,
                        W_m=solver.W_m,
                        h_m=params.h_m,
                    )
                )
                analytical_compare_expander()

    with tab_legacy:
        st.subheader("Legacy 3D / quasi-2D solvers")
        st.caption(
            "PML-8 walls, NrTS 60000, EndCriteria 1e-5 — the reference's "
            "earlier solver family (solver_fdtd_openems.py / _2d.py)."
        )
        if prep_legacy_btn:
            with st.spinner(f"Preparing {legacy_mode}…"):
                st.session_state.prepared_legacy = prepare_legacy_mode(
                    params, legacy_mode, device=device
                )
                st.session_state.legacy_mode = legacy_mode
            if st.session_state.prepared_legacy.ok:
                st.rerun()  # enable the Run button (message renders below)
        prep = st.session_state.prepared_legacy
        if prep is not None:
            # rendered on every run, so the rerun doesn't swallow it
            (st.success if prep.ok else st.error)(prep.message)
        if run_legacy_btn and st.session_state.prepared_legacy is not None:
            mode = st.session_state.legacy_mode or legacy_mode
            with st.spinner(f"Running {mode} on {device}…"):
                result = run_legacy_mode(
                    st.session_state.prepared_legacy, mode,
                    frequency_hz=params.frequency_hz,
                )
            if not result.ok:
                st.error(result.message)
            else:
                st.success(
                    f"{result.steps_run} steps in {result.wall_time_s:.2f} s; "
                    f"f_res = {result.f_res_hz / 1e9:.3f} GHz"
                )
                # φ = 0°/90° polar cuts with the reference's (dead-code)
                # polar scaling, now actually rendered
                zx, zy = plane_cuts_dbi(result)
                fig, axes = plt.subplots(
                    1, 2, subplot_kw=dict(projection="polar"), figsize=(10, 4)
                )
                theta = np.asarray(result.theta)
                for ax, cut, name in zip(
                    axes, (zx, zy), ("ZX plane (φ=0°)", "ZY plane (φ=90°)")
                ):
                    cur, rmin, rmax = normalize_and_bounds(cut)
                    ax.plot(theta, np.maximum(cur, rmin))
                    ax.set_rmin(rmin)
                    ax.set_rmax(rmax)
                    ax.set_rticks(np.arange(rmin, rmax + 1e-9, 5.0))
                    ax.set_theta_zero_location("N")
                    ax.set_title(name)
                _show(fig)
                result_tiles(result)
                analytical_compare_expander()

    with tab_array:
        st.subheader("Phased array — embedded patterns + S-matrix")
        st.caption(
            "Places nx×ny copies of the sidebar patch, runs one FDTD per "
            "port to extract the full S-matrix and embedded element "
            "patterns, then synthesizes steered beams (beyond the "
            "reference, which simulates one element at a time)."
        )
        c1, c2, c3, c4 = st.columns(4)
        arr_nx = c1.number_input("nx", 1, 8, 2)
        arr_ny = c2.number_input("ny", 1, 8, 1)
        arr_pitch = c3.number_input(
            "Pitch (mm, 0 = λ₀/2)", 0.0, 500.0, 0.0, step=5.0
        )
        arr_quality = c4.number_input("Mesh quality", 1, 5, 3)

        arun = st.session_state.array_run
        if st.button(
            "Design array", disabled=arun is not None and arun.running
        ):
            from ..solvers.array_synth import design_array

            st.session_state.array_design = None
            st.session_state.array_run = BackgroundRun().start(
                design_array,
                params,
                int(arr_nx),
                int(arr_ny),
                float(arr_pitch) or None,
                mesh_quality=int(arr_quality),
                device=device,
            )
            st.rerun()

        arun = st.session_state.array_run
        if arun is not None:
            if arun.running:
                done, total, ratio = arun.progress
                st.progress(
                    min(max(ratio, 0.0), 1.0),
                    text=f"One-hot FDTD runs: {done}/{total} complete",
                )
                if st.button("🛑 Stop array run", disabled=arun.aborting):
                    arun.abort()
                import time as _time

                _time.sleep(0.4)
                st.rerun()
            else:
                st.session_state.array_run = None
                if arun.error is not None:
                    st.session_state.array_error = (
                        f"Array design failed: {arun.error}"
                    )
                else:
                    st.session_state.array_error = None
                    st.session_state.array_design = arun.result
                st.rerun()

        if st.session_state.get("array_error"):
            st.error(st.session_state.array_error)
        design = st.session_state.array_design
        if design is not None and not design.ok:
            st.error(design.message)
        elif design is not None:
            from ..solvers.array_synth import array_run_summary

            st.success(design.message)
            s1, s2, s3 = st.columns(3)
            steer_theta = s1.slider("Steer θ (°)", 0.0, 60.0, 25.0, 5.0)
            steer_phi = s2.slider("Steer φ (°)", 0.0, 360.0, 0.0, 15.0)
            steer_kind = s3.selectbox(
                "Steering weights", ["conjugate", "geometric"],
                help="conjugate = embedded-pattern conjugate match; "
                "geometric = ideal progressive phase",
            )
            summary, broadside, steered, _ = array_run_summary(
                design, steer_theta, steer_phi, kind=steer_kind
            )
            m1, m2, m3, m4 = st.columns(4)
            m1.metric("Synthesis f", f"{summary['synth_freq_ghz']:.3f} GHz")
            m2.metric(
                "Broadside gain", f"{summary['broadside_gain_dbi']:.1f} dBi"
            )
            m3.metric("Steered gain", f"{summary['steered_gain_dbi']:.1f} dBi")
            m4.metric(
                "Max coupling",
                "—" if summary["max_coupling_db"] is None
                else f"{summary['max_coupling_db']:.1f} dB",
            )
            if not design.resonant:
                st.warning(
                    "No mean-S11 dip cleared −10 dB in the simulated band; "
                    "synthesizing at the design frequency instead."
                )
            pk = summary["steered_peak_deg"]
            st.caption(
                f"Steered beam peaks at θ={pk[0]:.0f}°, φ={pk[1]:.0f}° "
                f"(commanded θ={steer_theta:.0f}°, φ={steer_phi:.0f}°)."
            )

            # per-port return loss + worst coupling vs frequency
            sm = design.smatrix
            s_db = 20 * np.log10(np.maximum(np.abs(sm.s), 1e-12))
            fig, ax = plt.subplots(figsize=(8, 3))
            n = s_db.shape[0]
            for k in range(n):
                ax.plot(sm.freq_hz / 1e9, s_db[k, k], label=f"S{k+1}{k+1}")
            if n > 1:
                mask = ~np.eye(n, dtype=bool)
                ax.plot(
                    sm.freq_hz / 1e9,
                    s_db[mask].reshape(n * (n - 1), -1).max(axis=0),
                    "k--", label="max |Sij|, i≠j",
                )
            ax.axhline(-10, ls=":", c="gray")
            ax.axvline(summary["synth_freq_ghz"], ls=":", c="tab:red")
            ax.set_xlabel("f (GHz)")
            ax.set_ylabel("dB")
            ax.legend(fontsize=8, ncol=min(n + 1, 5))
            ax.grid(alpha=0.4)
            _show(fig)
            st.download_button(
                f"Download S-matrix (Touchstone .s{n}p)",
                touchstone_bytes(sm.freq_hz, sm.s, z_ref=sm.z_ref),
                file_name=f"array.s{n}p",
                mime="text/plain",
            )

            from ..viz.plotting import plot_3d_pattern_from_grid as _p3g

            p1, p2 = st.columns(2)
            for col, tag, pat in (
                (p1, "Broadside", broadside), (p2, "Steered", steered)
            ):
                with col:
                    st.write(f"**{tag}** — realized gain")
                    _show(
                        _p3g(
                            pat.theta, pat.phi, pat.realized_gain,
                            colors_db=pat.realized_gain_dbi(),
                        )
                    )

    with tab_scene:
        st.subheader("Interactive 3D scene")
        st.caption(
            "Portable replacement for the reference's Windows-only "
            "PyVista view (gui_app.py:1352-2480)."
        )
        meshes = patch_scene_meshes(
            solver.L_m * 1e3, solver.W_m * 1e3, params.h_m * 1e3
        )
        try:
            import plotly  # noqa: F401

            from ..viz.scene3d import scene_plotly_figure

            st.plotly_chart(scene_plotly_figure(meshes), width="stretch")
        except ImportError:
            import streamlit.components.v1 as components

            components.html(scene_html(meshes), height=520)


if __name__ == "__main__":
    if __package__:
        main()
    else:  # `streamlit run <this file>`: no package, so run the package's
        import sys
        from pathlib import Path

        sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
        from fdtd_solver_antennas_tpu_torch.frontends.webapp import main as _main

        _main()
