"""Matplotlib visualization with reference-parity signatures.

Counterpart of ``fdtd_solver_antennas_tpu/viz/plotting.py``. Importing it
imports matplotlib; ``viz/__init__.py`` resolves these names lazily, so the
rest of the package runs without matplotlib.

Covers the reference's primary plotting surface (``antenna_sim/plotting.py``):
geometry renders, polar E/H cuts, analytical 3D surface, and the FDTD-grid
3D dBi surface. Written fresh; notably ``draw_microstrip_patch_3d_geometry``
is defined exactly once (the reference defines it four times in one module,
plotting.py:138,340,523,834 — a documented defect we do not replicate).
"""

from __future__ import annotations

from typing import Optional

import matplotlib

matplotlib.use("Agg", force=False)  # headless-safe default; GUIs may override
import matplotlib.pyplot as plt
import numpy as np
from mpl_toolkits.mplot3d.art3d import Poly3DCollection


# ---------------------------------------------------------------------------
# geometry helpers
# ---------------------------------------------------------------------------

def _box_faces(lo, hi):
    """Return the 6 quad faces of an axis-aligned box as vertex lists."""
    x0, y0, z0 = lo
    x1, y1, z1 = hi
    v = np.array(
        [
            [x0, y0, z0], [x1, y0, z0], [x1, y1, z0], [x0, y1, z0],
            [x0, y0, z1], [x1, y0, z1], [x1, y1, z1], [x0, y1, z1],
        ]
    )
    idx = [
        (0, 1, 2, 3), (4, 5, 6, 7), (0, 1, 5, 4),
        (2, 3, 7, 6), (1, 2, 6, 5), (0, 3, 7, 4),
    ]
    return [v[list(i)] for i in idx]


def _add_box(ax, lo, hi, color, alpha=0.9, edge="k"):
    pc = Poly3DCollection(_box_faces(lo, hi), alpha=alpha)
    pc.set_facecolor(color)
    pc.set_edgecolor(edge)
    ax.add_collection3d(pc)


def draw_patch_3d_geometry(
    L_m: float, W_m: float, h_m: float, fig_size=(8, 6), show_labels: bool = True
):
    """3D render of the patch on its substrate + ground (reference:
    plotting.py:10-135; signature preserved)."""
    mm = 1e3
    L, W, h = L_m * mm, W_m * mm, h_m * mm
    margin = max(5.0, 0.2 * max(L, W))
    sub_L, sub_W = L + 2 * margin, W + 2 * margin

    fig = plt.figure(figsize=fig_size)
    ax = fig.add_subplot(111, projection="3d")
    # ground plane (thin slab below substrate)
    _add_box(ax, (-sub_W / 2, -sub_L / 2, -0.05 * h), (sub_W / 2, sub_L / 2, 0),
             "#c9a227", alpha=0.8)
    # substrate
    _add_box(ax, (-sub_W / 2, -sub_L / 2, 0), (sub_W / 2, sub_L / 2, h),
             "#2d6a4f", alpha=0.55)
    # patch
    _add_box(ax, (-W / 2, -L / 2, h), (W / 2, L / 2, 1.02 * h),
             "#e07a1f", alpha=0.95)

    if show_labels:
        ax.text(0, 0, 1.6 * h, f"Patch {W:.1f} × {L:.1f} mm", ha="center")
        ax.text(sub_W / 2, 0, 0.0, f"h = {h:.2f} mm", ha="left")
    lim = max(sub_W, sub_L) / 2 * 1.1
    ax.set_xlim(-lim, lim)
    ax.set_ylim(-lim, lim)
    ax.set_zlim(-0.2 * lim, 0.5 * lim)
    ax.set_xlabel("x (mm)")
    ax.set_ylabel("y (mm)")
    ax.set_zlabel("z (mm)")
    ax.set_title("Patch antenna geometry")
    ax.view_init(elev=25, azim=-60)
    return fig


def draw_microstrip_patch_3d_geometry(
    L_m: float,
    W_m: float,
    h_m: float,
    feed_direction,
    frequency_hz: float,
    eps_r: float,
    feed_line_length_mm: float = 20.0,
    fig_size=(8, 6),
):
    """3D render of the microstrip-fed patch (defined once, unlike the
    reference's quadruplicate definitions)."""
    from ..solvers.microstrip import FeedDirection, calculate_microstrip_width

    mm = 1e3
    L, W, h = L_m * mm, W_m * mm, h_m * mm
    fd = FeedDirection(feed_direction)
    fw = calculate_microstrip_width(frequency_hz, eps_r, h_m) * mm
    margin = 30.0
    fl = feed_line_length_mm
    if fd in (FeedDirection.POS_X, FeedDirection.NEG_X):
        sub_W, sub_L = W + 2 * margin + fl, L + 2 * margin
    else:
        sub_W, sub_L = W + 2 * margin, L + 2 * margin + fl

    fig = plt.figure(figsize=fig_size)
    ax = fig.add_subplot(111, projection="3d")
    _add_box(ax, (-sub_W / 2, -sub_L / 2, -0.05 * h), (sub_W / 2, sub_L / 2, 0),
             "#c9a227", alpha=0.8)
    _add_box(ax, (-sub_W / 2, -sub_L / 2, 0), (sub_W / 2, sub_L / 2, h),
             "#2d6a4f", alpha=0.5)
    _add_box(ax, (-W / 2, -L / 2, h), (W / 2, L / 2, 1.02 * h),
             "#e07a1f", alpha=0.95)
    # feed strip
    if fd == FeedDirection.NEG_X:
        lo, hi = (-sub_W / 2, -fw / 2, h), (-W / 2, fw / 2, 1.02 * h)
    elif fd == FeedDirection.POS_X:
        lo, hi = (W / 2, -fw / 2, h), (sub_W / 2, fw / 2, 1.02 * h)
    elif fd == FeedDirection.NEG_Y:
        lo, hi = (-fw / 2, -sub_L / 2, h), (fw / 2, -L / 2, 1.02 * h)
    else:
        lo, hi = (-fw / 2, L / 2, h), (fw / 2, sub_L / 2, 1.02 * h)
    _add_box(ax, lo, hi, "#d62828", alpha=0.95)

    lim = max(sub_W, sub_L) / 2 * 1.1
    ax.set_xlim(-lim, lim)
    ax.set_ylim(-lim, lim)
    ax.set_zlim(-0.2 * lim, 0.5 * lim)
    ax.set_xlabel("x (mm)")
    ax.set_ylabel("y (mm)")
    ax.set_zlabel("z (mm)")
    ax.set_title(f"Microstrip-fed patch ({fd.value} feed, w={fw:.2f} mm)")
    ax.view_init(elev=25, azim=-60)
    return fig


def draw_patch_top_view(ax, L_m: float, W_m: float, h_m: float):
    """2D top view onto an existing Axes (reference: plotting.py:258-295)."""
    mm = 1e3
    L, W = L_m * mm, W_m * mm
    margin = max(5.0, 0.2 * max(L, W))
    sub_L, sub_W = L + 2 * margin, W + 2 * margin
    ax.add_patch(
        plt.Rectangle((-sub_W / 2, -sub_L / 2), sub_W, sub_L,
                      facecolor="#2d6a4f", alpha=0.5, edgecolor="k")
    )
    ax.add_patch(
        plt.Rectangle((-W / 2, -L / 2), W, L,
                      facecolor="#e07a1f", alpha=0.95, edgecolor="k")
    )
    ax.set_xlim(-sub_W / 2 * 1.1, sub_W / 2 * 1.1)
    ax.set_ylim(-sub_L / 2 * 1.1, sub_L / 2 * 1.1)
    ax.set_aspect("equal")
    ax.set_xlabel("x (mm)")
    ax.set_ylabel("y (mm)")
    ax.set_title(f"Top view — patch {W:.1f} × {L:.1f} mm")
    return ax


# ---------------------------------------------------------------------------
# pattern plots
# ---------------------------------------------------------------------------

def plot_cross_sections(solver, *, fig_size=(12, 6)):
    """Polar E/H-plane gain cuts (reference: plotting.py:298-337)."""
    th_e, G_e = solver.cross_section_gain_lin("E")
    th_h, G_h = solver.cross_section_gain_lin("H")
    G_e_db = solver.lin_to_dbi(G_e)
    G_h_db = solver.lin_to_dbi(G_h)
    peak = max(float(np.max(G_e_db)), float(np.max(G_h_db)))
    r_max = np.ceil(peak / 5) * 5
    r_min = r_max - 40.0

    fig, axes = plt.subplots(
        1, 2, subplot_kw={"projection": "polar"}, figsize=fig_size
    )
    for ax, th, g, title in zip(
        axes,
        (th_e, th_h),
        (G_e_db, G_h_db),
        ("E-plane (φ=0°)", "H-plane (φ=90°)"),
    ):
        ax.plot(th, g, lw=2.2, color="#0b7285")
        ax.set_thetalim(0, np.pi)
        ax.set_rmax(r_max)
        ax.set_rmin(r_min)
        ax.set_rticks(np.arange(r_min, r_max + 5, 5))
        ax.set_rlabel_position(112)
        ax.set_title(title, pad=18)
        ax.grid(True, alpha=0.5)
    fig.suptitle("Radiation patterns (gain, dBi)")
    fig.tight_layout()
    return fig


def _spherical_to_cart(r, th, ph):
    return (
        r * np.sin(th) * np.cos(ph),
        r * np.sin(th) * np.sin(ph),
        r * np.cos(th),
    )


def plot_3d_pattern(solver, *, show_isotropic: bool = True, fig_size=(8, 9)):
    """Analytical 3D gain surface (reference: plotting.py:467-520)."""
    res = solver.compute_full_pattern(num_theta=121, num_phi=241)
    G = res.gain
    Gn = G / max(1e-16, float(np.max(G)))
    th, ph = np.meshgrid(res.theta, res.phi, indexing="ij")
    x, y, z = _spherical_to_cart(Gn, th, ph)

    fig = plt.figure(figsize=fig_size)
    ax = fig.add_subplot(111, projection="3d")
    ax.plot_surface(
        x, y, z,
        rstride=2, cstride=2,
        facecolors=plt.cm.viridis(Gn),
        linewidth=0.1, antialiased=True, alpha=0.95, shade=False,
    )
    if show_isotropic:
        xs, ys, zs = _spherical_to_cart(np.ones_like(Gn), th, ph)
        ax.plot_surface(xs, ys, zs, color="#888888", alpha=0.12, linewidth=0)
    lim = 1.1
    for setter in (ax.set_xlim, ax.set_ylim, ax.set_zlim):
        setter(-lim, lim)
    ax.set_box_aspect([1, 1, 1])
    ax.set_xlabel("x")
    ax.set_ylabel("y")
    ax.set_zlabel("z")
    ax.set_title("3D radiation surface (normalized gain)")
    ax.view_init(elev=22, azim=35)
    return fig


def plot_3d_pattern_from_grid(
    theta: np.ndarray,
    phi: np.ndarray,
    intensity: np.ndarray,
    *,
    L_m: Optional[float] = None,
    W_m: Optional[float] = None,
    h_m: Optional[float] = None,
    dB_min: Optional[float] = None,
    dB_max: Optional[float] = None,
    fig_size=(8, 9),
    colors_db: Optional[np.ndarray] = None,
    clip_db: Optional[float] = None,
):
    """FDTD-grid 3D far-field surface with dB colormap and colorbar
    (reference: plotting.py:643-831). ``intensity`` may be linear or a dBi
    grid passed through ``colors_db``. ``h_m`` is accepted for reference
    signature parity but unused (the footprint box is drawn flat)."""
    th = np.asarray(theta).reshape(-1)
    ph = np.asarray(phi).reshape(-1)
    G = np.asarray(intensity, dtype=float)
    if G.ndim == 1:
        G = (
            np.tile(G.reshape(-1, 1), (1, ph.size))
            if G.size == th.size
            else np.tile(G.reshape(1, -1), (th.size, 1))
        )
    thg, phg = np.meshgrid(th, ph, indexing="ij")

    G = np.maximum(G, 1e-16)
    Gn = G / np.nanmax(G)
    if colors_db is None:
        color_db = 10.0 * np.log10(Gn)
    else:
        color_db = np.asarray(colors_db, float)
        if color_db.ndim == 3:
            color_db = color_db[0]
    if clip_db is not None:
        Gn = np.where(color_db < clip_db, np.nan, Gn)
    if dB_min is None:
        dB_min = max(-40.0, float(np.nanpercentile(color_db, 10)))
    if dB_max is None:
        # default to the grid's real peak: callers pass absolute-dBi
        # grids (peak ~+7 dBi for a patch), and the reference's fixed
        # 0 dB ceiling rendered the whole main lobe as one saturated
        # color with a mislabeled colorbar
        dB_max = float(np.nanmax(color_db))
    if dB_max <= dB_min:
        dB_min, dB_max = min(dB_min, -10.0), 0.0
    norm = np.clip((color_db - dB_min) / max(1e-9, dB_max - dB_min), 0, 1)

    x, y, z = _spherical_to_cart(Gn, thg, phg)
    fig = plt.figure(figsize=fig_size)
    ax = fig.add_subplot(111, projection="3d")
    ax.plot_surface(
        x, y, z,
        facecolors=plt.cm.turbo(norm),
        rstride=1, cstride=1, linewidth=0, antialiased=True, shade=False,
    )
    # optional patch footprint for orientation
    if L_m and W_m:
        mm_norm = 0.6 / max(L_m, W_m)
        _add_box(
            ax,
            (-W_m * mm_norm / 2, -L_m * mm_norm / 2, -1.05),
            (W_m * mm_norm / 2, L_m * mm_norm / 2, -1.0),
            "#e07a1f", alpha=0.9,
        )
    m = plt.cm.ScalarMappable(cmap=plt.cm.turbo)
    m.set_array([dB_min, dB_max])
    fig.colorbar(m, ax=ax, shrink=0.6, label="dB")
    lim = 1.1
    for setter in (ax.set_xlim, ax.set_ylim, ax.set_zlim):
        setter(-lim, lim)
    ax.set_box_aspect([1, 1, 1])
    ax.set_title("3D far-field pattern")
    ax.view_init(elev=22, azim=35)
    return fig
