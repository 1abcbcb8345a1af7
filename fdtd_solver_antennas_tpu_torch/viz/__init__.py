"""Views: pattern helpers, the 3D scene viewer and the matplotlib plots.

Counterpart of ``fdtd_solver_antennas_tpu/viz``. The plotting names resolve
on first use (PEP 562), so importing this package or ``viz.scene3d`` needs
no matplotlib; only the plots do.
"""

from .scene3d import (
    SceneMesh,
    patch_scene_meshes,
    scene_html,
    scene_meshes,
    scene_plotly_figure,
)

_PLOTTING = (
    "plot_cross_sections",
    "plot_3d_pattern",
    "plot_3d_pattern_from_grid",
    "draw_patch_3d_geometry",
    "draw_patch_top_view",
    "draw_microstrip_patch_3d_geometry",
)

__all__ = [
    *_PLOTTING,
    "SceneMesh",
    "patch_scene_meshes",
    "scene_html",
    "scene_meshes",
    "scene_plotly_figure",
]


def __getattr__(name):
    if name in _PLOTTING:
        from . import plotting

        return getattr(plotting, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
