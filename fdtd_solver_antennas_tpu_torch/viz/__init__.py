"""Views: pattern helpers, the 3D scene viewer and the matplotlib plots.

Counterpart of ``fdtd_solver_antennas_tpu/viz``. The plotting names resolve
on first use (PEP 562), so importing this package or ``viz.scene3d`` needs
no matplotlib; only the plots do. :func:`save_figure` saves a figure, or
says that it was not drawn where matplotlib is not installed.
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
    "save_figure",
]


def save_figure(path, draw, **savefig) -> bool:
    """Save the figure ``draw()`` returns at ``path`` (``savefig`` goes to
    ``Figure.savefig``) and print ``Saved: <path>``; where matplotlib is
    not installed, print ``Not drawn: <path> (...)`` instead, without
    calling ``draw``. True when the figure was saved."""
    try:
        import matplotlib  # noqa: F401
    except ImportError as e:
        print(f"Not drawn: {path} ({e.name or 'matplotlib'} is not installed)")
        return False
    from . import plotting  # noqa: F401  (selects Agg, headless)
    import matplotlib.pyplot as plt

    fig = draw()
    fig.savefig(path, **savefig)
    plt.close(fig)
    print(f"Saved: {path}")
    return True


def __getattr__(name):
    if name in _PLOTTING:
        from . import plotting

        return getattr(plotting, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
