"""Portable interactive 3D scene view.

Counterpart of ``fdtd_solver_antennas_tpu/viz/scene3d.py``: NumPy and
JSON, on the port's own scene geometry (``models/scene.py``,
``solvers/multi_patch_3d.py``, ``solvers/horn.py``).

Replaces the reference's high-fidelity PyVista geometry viewer — a
Windows-only Qt ``QtInteractor`` reparented into Tk via Win32
``SetParent`` (reference: ``gui_app.py:1352-2480``, scene construction
``_build_scene_pyvista`` :1793-1912, camera-scaled axes :1956-2014) —
with a dependency-free triangle-mesh pipeline:

- :func:`scene_meshes` builds world-frame triangle meshes for a designer
  scene (oriented patch substrates/plates, horn waveguide + flare
  frustums, port markers) using the same row-vector transform convention
  as the solver (``world = local @ Rᵀ + T``, multi_patch_3d.py geometry);
- :func:`scene_plotly_figure` renders them as a rotatable plotly
  ``Mesh3d`` figure when plotly is installed;
- :func:`scene_html` always works: it emits a self-contained HTML page
  with an inline-JavaScript canvas orbit viewer (painter's-algorithm
  z-sorted flat-shaded triangles, drag to rotate, wheel to zoom) — no
  external dependencies, embeddable in Streamlit or openable in any
  browser from the desktop GUI.

Unlike the previous matplotlib preview (frontends/designer.py), rotated
instances are rendered with their true oriented geometry, not their
axis-aligned bounding boxes.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Iterable, List, Optional, Sequence

import numpy as np

__all__ = [
    "SceneMesh",
    "box_mesh",
    "quad_mesh",
    "marker_mesh",
    "patch_scene_meshes",
    "scene_meshes",
    "scene_plotly_figure",
    "scene_html",
]

# palette matching the designer preview's color language
COL_SUBSTRATE = "#2d6a4f"
COL_METAL = "#e07a1f"
COL_GROUND = "#8d99ae"
COL_HORN = "#6a4c93"
COL_PORT = "#d62828"


@dataclasses.dataclass
class SceneMesh:
    """One triangle mesh: world-frame vertices (mm) + faces + style."""

    name: str
    verts: np.ndarray  # (N, 3) float, mm
    faces: np.ndarray  # (M, 3) int vertex indices
    color: str = COL_METAL
    opacity: float = 1.0

    def transformed(self, R: Optional[np.ndarray], T) -> "SceneMesh":
        """Apply the solver's row-vector world transform
        ``world = local @ Rᵀ + T`` (multi_patch_3d.py contract)."""
        v = self.verts
        if R is not None:
            v = v @ np.asarray(R).T
        v = v + np.asarray(T, float)
        return dataclasses.replace(self, verts=v)


_BOX_FACES = np.array([
    [0, 1, 3], [0, 3, 2],  # x = lo
    [4, 6, 7], [4, 7, 5],  # x = hi
    [0, 4, 5], [0, 5, 1],  # y = lo
    [2, 3, 7], [2, 7, 6],  # y = hi
    [0, 2, 6], [0, 6, 4],  # z = lo
    [1, 5, 7], [1, 7, 3],  # z = hi
])


def box_mesh(
    lo: Sequence[float], hi: Sequence[float], name: str = "box",
    color: str = COL_METAL, opacity: float = 1.0,
    min_extent: float = 0.15,
) -> SceneMesh:
    """Axis-aligned (local-frame) box as 12 triangles.

    Zero-thickness sheets (PEC plates) are puffed to ``min_extent`` mm so
    they stay visible, matching the PyVista view's thin-plate handling.
    """
    lo = np.asarray(lo, float).copy()
    hi = np.asarray(hi, float).copy()
    flat = hi - lo < min_extent
    lo[flat] -= min_extent / 2
    hi[flat] += min_extent / 2
    verts = np.array(
        [[x, y, z] for x in (lo[0], hi[0]) for y in (lo[1], hi[1])
         for z in (lo[2], hi[2])]
    )
    return SceneMesh(name, verts, _BOX_FACES.copy(), color, opacity)


def quad_mesh(
    corners: np.ndarray, name: str = "quad", color: str = COL_METAL,
    opacity: float = 1.0,
) -> SceneMesh:
    """Planar quadrilateral (4 corners, in order) as 2 triangles."""
    corners = np.asarray(corners, float)
    if corners.shape != (4, 3):
        raise ValueError("quad_mesh expects (4, 3) corners")
    faces = np.array([[0, 1, 2], [0, 2, 3]])
    return SceneMesh(name, corners.copy(), faces, color, opacity)


def marker_mesh(
    center: Sequence[float], size: float = 2.0, name: str = "marker",
    color: str = COL_PORT,
) -> SceneMesh:
    """Small octahedron marker (port locations)."""
    c = np.asarray(center, float)
    s = float(size)
    verts = c + s * np.array(
        [[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]]
    )
    faces = np.array([
        [4, 0, 2], [4, 2, 1], [4, 1, 3], [4, 3, 0],
        [5, 2, 0], [5, 1, 2], [5, 3, 1], [5, 0, 3],
    ])
    return SceneMesh(name, verts, faces, color, 1.0)


# ---------------------------------------------------------------------------
# scene assembly
# ---------------------------------------------------------------------------

def _patch_instance_meshes(inst, margin_mm: float = 30.0) -> List[SceneMesh]:
    """Oriented meshes for one PatchInstance: substrate slab, ground
    sheet, patch plate, feed-point marker (PyVista analog:
    gui_app.py:1806-1866)."""
    from ..models.scene import rotation_matrix
    from ..solvers.multi_patch_3d import _instance_local_geometry

    # the SOLVER's local boxes (substrate incl. feed-side extension,
    # ground, patch, feed trace) — a hand-rebuilt symmetric footprint
    # omitted the feed line and was 20 mm short on the fed side of what
    # is actually simulated
    boxes, port_line, dims = _instance_local_geometry(inst, 20.0)
    h = dims["h"]
    R = rotation_matrix(inst.rot_x_deg, inst.rot_y_deg, inst.rot_z_deg)
    if np.allclose(R, np.eye(3), atol=1e-12):
        R = None
    T = np.array([inst.center_x_m, inst.center_y_m, inst.center_z_m]) * 1e3

    meshes = [
        box_mesh(*boxes["substrate"], f"{inst.name}: substrate",
                 COL_SUBSTRATE, 0.45),
        box_mesh(*boxes["ground"], f"{inst.name}: ground",
                 COL_GROUND, 0.8),
        box_mesh(*boxes["patch"], f"{inst.name}: patch", COL_METAL, 1.0),
        box_mesh(*boxes["feed"], f"{inst.name}: feed", COL_METAL, 1.0),
    ]
    p0 = np.asarray(port_line[0], float)
    meshes.append(
        marker_mesh((p0[0], p0[1], h / 2),
                    size=max(1.5, h), name=f"{inst.name}: port")
    )
    return [m.transformed(R, T) for m in meshes]


def _horn_instance_meshes(inst, mesh_res_mm: float = 3.0) -> List[SceneMesh]:
    """Oriented meshes for one HornInstance: waveguide wall boxes, flare
    plates, feed marker (PyVista analog ``_pv_horn``; geometry shared
    with the solver via horn_local_geometry)."""
    from ..models.scene import rotation_matrix
    from ..solvers.horn import horn_local_geometry

    geo = horn_local_geometry(inst.params, mesh_res_mm)
    R = rotation_matrix(inst.rot_x_deg, inst.rot_y_deg, inst.rot_z_deg)
    if np.allclose(R, np.eye(3), atol=1e-12):
        R = None
    T = np.array([inst.center_x_m, inst.center_y_m, inst.center_z_m]) * 1e3

    meshes = [
        box_mesh(lo, hi, f"{inst.name}: waveguide", COL_HORN, 0.9)
        for lo, hi in geo["boxes"]
    ]
    meshes += [
        quad_mesh(q, f"{inst.name}: flare", COL_HORN, 0.55)
        for q in geo["quads"]
    ]
    p0, p1 = geo["port_line"]
    meshes.append(
        marker_mesh(0.5 * (p0 + p1), size=max(1.5, geo["b"] / 4),
                    name=f"{inst.name}: port")
    )
    return [m.transformed(R, T) for m in meshes]


def scene_meshes(scene) -> List[SceneMesh]:
    """World-frame meshes for a full designer scene
    (frontends.designer.MultiPatchScene)."""
    meshes: List[SceneMesh] = []
    for inst in scene.patches:
        meshes += _patch_instance_meshes(inst)
    for inst in scene.horns:
        meshes += _horn_instance_meshes(inst)
    return meshes


def patch_scene_meshes(L_mm: float, W_mm: float, h_mm: float) -> List[SceneMesh]:
    """Meshes for a simple single-patch scene (webapp default view)."""
    sw, sl = W_mm / 2 + 30.0, L_mm / 2 + 30.0
    return [
        box_mesh((-sw, -sl, 0), (sw, sl, h_mm), "substrate",
                 COL_SUBSTRATE, 0.45),
        box_mesh((-sw, -sl, 0), (sw, sl, 0), "ground", COL_GROUND, 0.8),
        box_mesh((-W_mm / 2, -L_mm / 2, h_mm), (W_mm / 2, L_mm / 2, h_mm),
                 "patch", COL_METAL, 1.0),
        marker_mesh((-6.0, 0.0, h_mm / 2), size=max(1.5, h_mm), name="port"),
    ]


# ---------------------------------------------------------------------------
# renderers
# ---------------------------------------------------------------------------

def scene_plotly_figure(meshes: Iterable[SceneMesh]):
    """Rotatable plotly Mesh3d figure (requires plotly)."""
    import plotly.graph_objects as go

    traces = []
    for m in meshes:
        traces.append(go.Mesh3d(
            x=m.verts[:, 0], y=m.verts[:, 1], z=m.verts[:, 2],
            i=m.faces[:, 0], j=m.faces[:, 1], k=m.faces[:, 2],
            color=m.color, opacity=m.opacity, name=m.name,
            flatshading=True, showlegend=True,
        ))
    fig = go.Figure(data=traces)
    fig.update_layout(
        scene=dict(aspectmode="data",
                   xaxis_title="x (mm)", yaxis_title="y (mm)",
                   zaxis_title="z (mm)"),
        margin=dict(l=0, r=0, t=24, b=0),
    )
    return fig


_HTML_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>Antenna scene</title>
<style>
  html,body {{ margin:0; background:#14141c; color:#cfd3dc;
               font:12px system-ui, sans-serif; }}
  #hud {{ position:absolute; top:8px; left:10px; opacity:.75;
          pointer-events:none; }}
  canvas {{ display:block; cursor:grab; }}
</style></head><body>
<div id="hud">drag: rotate &middot; wheel: zoom &middot;
{n_meshes} meshes / {n_tris} triangles</div>
<canvas id="c"></canvas>
<script>
const MESHES = {mesh_json};
const canvas = document.getElementById('c');
const ctx = canvas.getContext('2d');
let W, H; function resize() {{
  W = canvas.width = window.innerWidth;
  H = canvas.height = Math.max(window.innerHeight, 480);
}} resize(); window.addEventListener('resize', () => {{ resize(); draw(); }});

// scene bounds -> center + scale
let lo = [1e30,1e30,1e30], hi = [-1e30,-1e30,-1e30];
for (const m of MESHES) for (const v of m.verts)
  for (let a = 0; a < 3; a++) {{
    lo[a] = Math.min(lo[a], v[a]); hi[a] = Math.max(hi[a], v[a]);
  }}
const C = [0,1,2].map(a => (lo[a]+hi[a])/2);
const span = Math.max(hi[0]-lo[0], hi[1]-lo[1], hi[2]-lo[2], 1);

let yaw = 0.7, pitch = 0.95, zoom = 1.0;
function rot(v) {{
  const x0 = v[0]-C[0], y0 = v[1]-C[1], z0 = v[2]-C[2];
  const cy = Math.cos(yaw), sy = Math.sin(yaw);
  const cp = Math.cos(pitch), sp = Math.sin(pitch);
  const x1 =  cy*x0 + sy*y0, y1 = -sy*x0 + cy*y0;      // about z
  const y2 =  cp*y1 - sp*z0, z2 =  sp*y1 + cp*z0;      // about x
  return [x1, y2, z2];
}}
function shade(hex, f) {{
  const n = parseInt(hex.slice(1), 16);
  const r = Math.min(255, ((n>>16)&255)*f)|0,
        g = Math.min(255, ((n>>8)&255)*f)|0,
        b = Math.min(255, (n&255)*f)|0;
  return `rgb(${{r}},${{g}},${{b}})`;
}}
function draw() {{
  ctx.fillStyle = '#14141c'; ctx.fillRect(0, 0, W, H);
  const s = zoom * 0.72 * Math.min(W, H) / span;
  const tris = [];
  for (const m of MESHES) {{
    const rv = m.verts.map(rot);
    for (const f of m.faces) {{
      const a = rv[f[0]], b = rv[f[1]], c = rv[f[2]];
      // flat shading from the camera-frame normal
      const ux = b[0]-a[0], uy = b[1]-a[1], uz = b[2]-a[2];
      const vx = c[0]-a[0], vy = c[1]-a[1], vz = c[2]-a[2];
      const nx = uy*vz-uz*vy, ny = uz*vx-ux*vz, nz = ux*vy-uy*vx;
      const nl = Math.hypot(nx, ny, nz) || 1;
      const lum = 0.55 + 0.45*Math.abs(nz/nl);
      tris.push({{
        z: (a[2]+b[2]+c[2])/3,
        p: [a, b, c].map(v => [W/2 + v[0]*s, H/2 - v[1]*s]),
        col: shade(m.color, lum), op: m.op,
      }});
    }}
  }}
  tris.sort((p, q) => p.z - q.z);
  for (const t of tris) {{
    ctx.globalAlpha = t.op;
    ctx.fillStyle = t.col;
    ctx.beginPath();
    ctx.moveTo(t.p[0][0], t.p[0][1]);
    ctx.lineTo(t.p[1][0], t.p[1][1]);
    ctx.lineTo(t.p[2][0], t.p[2][1]);
    ctx.closePath(); ctx.fill();
  }}
  ctx.globalAlpha = 1;
  // origin axes, camera-scaled (PyVista-view parity, gui_app.py:1956-2014)
  const axes = [[[0,0,0],[span/4,0,0],'#e63946','x'],
                [[0,0,0],[0,span/4,0],'#52b788','y'],
                [[0,0,0],[0,0,span/4],'#4895ef','z']];
  for (const [o, e, col, lbl] of axes) {{
    const a = rot(o), b = rot(e);
    ctx.strokeStyle = col; ctx.lineWidth = 1.5;
    ctx.beginPath();
    ctx.moveTo(W/2 + a[0]*s, H/2 - a[1]*s);
    ctx.lineTo(W/2 + b[0]*s, H/2 - b[1]*s);
    ctx.stroke();
    ctx.fillStyle = col;
    ctx.fillText(lbl, W/2 + b[0]*s + 4, H/2 - b[1]*s);
  }}
}}
let dragging = false, px = 0, py = 0;
canvas.addEventListener('mousedown', e => {{
  dragging = true; px = e.clientX; py = e.clientY;
  canvas.style.cursor = 'grabbing';
}});
window.addEventListener('mouseup', () => {{
  dragging = false; canvas.style.cursor = 'grab';
}});
window.addEventListener('mousemove', e => {{
  if (!dragging) return;
  yaw += (e.clientX - px) * 0.01;
  pitch += (e.clientY - py) * 0.01;
  px = e.clientX; py = e.clientY; draw();
}});
canvas.addEventListener('wheel', e => {{
  e.preventDefault();
  zoom *= Math.exp(-e.deltaY * 0.001);
  zoom = Math.min(20, Math.max(0.05, zoom)); draw();
}}, {{passive: false}});
draw();
</script></body></html>
"""


def scene_html(meshes: Iterable[SceneMesh]) -> str:
    """Self-contained interactive HTML (inline JS canvas orbit viewer)."""
    meshes = list(meshes)
    payload = [
        dict(
            name=m.name,
            verts=np.asarray(m.verts, float).round(4).tolist(),
            faces=np.asarray(m.faces, int).tolist(),
            color=m.color,
            op=float(m.opacity),
        )
        for m in meshes
    ]
    n_tris = sum(len(m.faces) for m in meshes)
    return _HTML_TEMPLATE.format(
        # script-safe: a literal '</script>' inside a JSON string would
        # terminate the script element and inject the rest as markup
        mesh_json=json.dumps(payload).replace('</', '<\\/'),
        n_meshes=len(meshes),
        n_tris=n_tris,
    )


def save_scene_html(meshes: Iterable[SceneMesh], path: str) -> str:
    """Write :func:`scene_html` to ``path``; returns the path."""
    html = scene_html(meshes)
    with open(path, "w", encoding="utf-8") as fh:
        fh.write(html)
    return path
