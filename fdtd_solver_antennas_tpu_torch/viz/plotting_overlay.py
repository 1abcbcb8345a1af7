"""Two-layer overlay geometry renderer (parity with plotting_mtplt.py:6-122).

Counterpart of ``fdtd_solver_antennas_tpu/viz/plotting_overlay.py``.

The reference keeps an alternate renderer that splits the scene across two
stacked 3D axes — substrate/ground/sides on the main axis and the opaque
copper top faces on a transparent overlay axis — to sidestep matplotlib's
depth-sorting artifacts for coplanar faces. The returned figure carries an
``_overlay_ax`` attribute so callers can add more copper (e.g. a microstrip
feed) to the overlay in the correct draw order — the same contract the
reference exposes.

The second legacy module, ``plotting_new.py``, is an alternate-styling copy
whose 3D entry point calls a non-existent solver method
(``plotting_new.py:324`` → ``AnalyticalPatchSolver.gain_3d_pattern`` — a
documented latent bug). Its working surface is a styling variant of the
primary module; we keep the primary renderers as the single styled
implementation rather than replicating the broken copy.
"""

from __future__ import annotations

import matplotlib.pyplot as plt
from mpl_toolkits.mplot3d.art3d import Poly3DCollection


def _quad_faces_box(lo, hi, *, skip_top=False):
    x0, y0, z0 = lo
    x1, y1, z1 = hi
    faces = [
        [[x0, y0, z0], [x1, y0, z0], [x1, y1, z0], [x0, y1, z0]],  # bottom
        [[x0, y0, z0], [x0, y0, z1], [x0, y1, z1], [x0, y1, z0]],
        [[x1, y0, z0], [x1, y0, z1], [x1, y1, z1], [x1, y1, z0]],
        [[x0, y0, z0], [x1, y0, z0], [x1, y0, z1], [x0, y0, z1]],
        [[x0, y1, z0], [x1, y1, z0], [x1, y1, z1], [x0, y1, z1]],
    ]
    if not skip_top:
        faces.append(
            [[x0, y0, z1], [x1, y0, z1], [x1, y1, z1], [x0, y1, z1]]
        )
    return faces


def _setup_axis(ax, lim):
    ax.set_xlim(-lim, lim)
    ax.set_ylim(-lim, lim)
    ax.set_zlim(-lim / 3, lim / 2)
    ax.set_box_aspect([1, 1, 0.5])
    ax.view_init(elev=24, azim=-58)


def draw_patch_3d_geometry(
    L_m: float, W_m: float, h_m: float, fig_size=(8, 6),
    show_labels: bool = True,
):
    """Two-layer patch render; fig gets ``_overlay_ax`` (reference contract).

    Main axis: substrate bottom/sides (top omitted) + ground sheet.
    Overlay axis: opaque patch top face + labels.
    """
    mm = 1e3
    L, W, h = L_m * mm, W_m * mm, h_m * mm
    margin = max(5.0, 0.2 * max(L, W))
    sub_L, sub_W = L + 2 * margin, W + 2 * margin

    fig = plt.figure(figsize=fig_size)
    ax = fig.add_subplot(111, projection="3d")

    # substrate slab drawn without its top so the copper never z-fights
    sub = Poly3DCollection(
        _quad_faces_box((-sub_W / 2, -sub_L / 2, -h), (sub_W / 2, sub_L / 2, -0.02),
                        skip_top=True),
        alpha=0.45, facecolor="#2e7d32", edgecolor="#1b5e20", linewidth=1.0,
    )
    try:
        sub.set_zsort("min")
    except Exception:
        pass
    ax.add_collection3d(sub)
    gnd = Poly3DCollection(
        [[[-sub_W / 2, -sub_L / 2, -h], [sub_W / 2, -sub_L / 2, -h],
          [sub_W / 2, sub_L / 2, -h], [-sub_W / 2, sub_L / 2, -h]]],
        facecolor="#c9a227", alpha=0.85, edgecolor="#7a6113",
    )
    ax.add_collection3d(gnd)

    lim = max(sub_W, sub_L) / 2 * 1.15
    _setup_axis(ax, lim)
    ax.set_xlabel("x (mm)")
    ax.set_ylabel("y (mm)")
    ax.set_zlabel("z (mm)")

    # transparent overlay axis sharing the projection: copper tops on top
    overlay = fig.add_axes(ax.get_position(), projection="3d")
    overlay.patch.set_alpha(0.0)
    overlay.set_axis_off()
    _setup_axis(overlay, lim)
    patch_top = Poly3DCollection(
        [[[-W / 2, -L / 2, 0], [W / 2, -L / 2, 0],
          [W / 2, L / 2, 0], [-W / 2, L / 2, 0]]],
        facecolor="#e07a1f", edgecolor="#8a4a12", linewidth=1.2,
    )
    overlay.add_collection3d(patch_top)
    if show_labels:
        overlay.text(0, 0, h + 4, f"{W:.1f} × {L:.1f} mm", ha="center",
                     color="#333333")
    fig._overlay_ax = overlay  # the reference's extension point
    return fig


def add_overlay_copper(fig, lo, hi, color="#d62828"):
    """Add another copper face to the overlay axis (feed lines etc.) —
    the usage pattern the reference's ``_overlay_ax`` enables."""
    overlay = getattr(fig, "_overlay_ax", None)
    if overlay is None:
        raise ValueError("figure has no _overlay_ax (not an overlay render)")
    x0, y0, z = lo[0], lo[1], hi[2]
    x1, y1 = hi[0], hi[1]
    quad = Poly3DCollection(
        [[[x0, y0, z], [x1, y0, z], [x1, y1, z], [x0, y1, z]]],
        facecolor=color, edgecolor="#5c1010",
    )
    overlay.add_collection3d(quad)
    return fig
