"""Yee-grid FDTD engine in PyTorch.

Counterpart of ``fdtd_solver_antennas_tpu/ops/fdtd.py`` (its XLA path):

- staggered (Ex..Hz) leapfrog update on a graded mesh with per-axis
  inverse-spacing vectors;
- first-order MUR walls, PEC walls, or an N-cell CPML (``PML_N``);
- lumped resistive ports folded into the E-update as an edge conductivity
  plus a soft source, with V/I probes;
- decimated probe sampling: port V/I and Huygens-box tangential fields
  every D steps, staged per chunk and folded into the DFT accumulators as
  matmuls;
- an energy-decay early exit checked once per chunk.

The step itself is the four kernels of ``ops/fdtd_cuda.py``: on a CUDA
device the run launches them, on the CPU it runs their plain PyTorch
twins. There is no other switch. The accumulators and the resumable state
keep the JAX package's layouts (stacked real/imaginary float32, fields in
the 3-D grid layout), so a checkpoint carries across in both directions
(:func:`state_from_numpy`, :func:`state_to_numpy`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models.scene import LumpedPortSpec, Scene
from ..physics import C0, EPS0, ETA0, MU0
from . import fdtd_cuda
from .fdtd_cuda import PSI_KEYS, YeeOperands
from .mesh import YeeGrid
from .source import gaussian_excitation, source_active_steps
from .voxelize import cell_to_edge_average, voxelize

_AXIS_OF = {"x": 0, "y": 1, "z": 2}
# cells between the outer wall (or the CPML slab) and the Huygens box
_NF_MARGIN_CELLS = 4


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; asking for CUDA where there is no
    CUDA raises (nothing falls back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but torch.cuda.is_available() "
                "is False")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (use 'cuda' or 'cpu')")
    return dev


def nf_to_complex(stacked) -> np.ndarray:
    """Convert a stacked (re, im) float array (re/im on axis 0) to complex
    on the host. Complex input passes through."""
    a = _to_numpy(stacked)
    if np.iscomplexobj(a):
        return a
    return a[0] + 1j * a[1]


# ---------------------------------------------------------------------------
# configuration / prepared-simulation containers
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FDTDConfig:
    """Run controls (reference analogs: NrTS / EndCriteria / boundary).

    ``boundary``: 'MUR' (first-order ABC), 'PEC' (closed box), or 'PML_N'
    (N-cell CPML, e.g. 'PML_8').
    """

    n_steps_max: int = 30_000
    end_criteria: float = 1e-4
    boundary: str = "MUR"
    check_every: int = 500
    courant: float = 0.95
    # Probe/DFT sampling stride. None → the largest D keeping the sampling
    # interval D·dt below 1/(2.5·(f0+fc)); 1 samples every step.
    probe_decimation: int | None = None

    def pml_cells(self) -> int:
        """0 when not a PML boundary, else the slab thickness in cells."""
        b = self.boundary.upper()
        if not b.startswith("PML"):
            return 0
        try:
            return int(b.split("_")[-1])
        except ValueError:
            return 8


@dataclasses.dataclass
class PortRuntime:
    """Port geometry resolved onto the grid."""

    spec: LumpedPortSpec
    axis: int
    sl: Tuple  # index tuple selecting the port's E-edge column
    dl_m: np.ndarray  # (n_edges,) edge lengths
    src_col: np.ndarray  # (n_edges,) source coefficient (× s(t) each step)
    # current probe: 4 gather tuples + 2 dual lengths
    i_gather: List[Tuple]
    i_lengths: Tuple[float, float]


@dataclasses.dataclass
class FaceRuntime:
    """One Huygens-box face: slicing recipe + geometry for the transform."""

    name: str
    axis: int
    m: int  # node index of the face plane along `axis`
    u_axis: int
    v_axis: int
    u0: int
    u1: int
    v0: int
    v1: int
    normal: np.ndarray  # outward unit normal (3,)
    centers_m: np.ndarray  # (nu, nv, 3) face-cell centers, meters
    areas_m2: np.ndarray  # (nu, nv)


def port_probe_sources(sim: "PreparedSimulation"):
    """Per-port probe source lists: for each port a list of
    ((comp, i, j, k), weight) terms — V over the E stack, I over the H
    stack."""
    Px, Py, Pz = sim.padded_shape
    v_lists, i_lists = [], []
    for prt in sim.ports:
        col = np.stack(
            np.meshgrid(
                *[np.atleast_1d(np.arange((Px, Py, Pz)[a])[prt.sl[a]])
                  for a in range(3)],
                indexing="ij",
            ),
            axis=-1,
        ).reshape(-1, 3)
        v_lists.append([
            ((prt.axis, int(t[0]), int(t[1]), int(t[2])), -float(w))
            for t, w in zip(col, prt.dl_m)
        ])
        dv, du = prt.i_lengths
        hv = (prt.axis + 2) % 3
        hu = (prt.axis + 1) % 3
        g = prt.i_gather
        i_lists.append([
            ((hv, *g[0]), float(dv)), ((hv, *g[1]), -float(dv)),
            ((hu, *g[2]), -float(du)), ((hu, *g[3]), float(du)),
        ])
    return v_lists, i_lists


def n_probe_rows(sim: "PreparedSimulation") -> int:
    """Rows in the uf/if_ port-DFT accumulators: one per lumped port."""
    return len(sim.ports)


@dataclasses.dataclass
class PreparedSimulation:
    """Coefficients, probes and run controls of one simulation, with its
    tensors on ``device``."""

    grid: YeeGrid
    dt: float
    cfg: FDTDConfig
    device: torch.device
    coeffs: Dict[str, torch.Tensor]
    waveform: np.ndarray
    ports: List[PortRuntime]
    faces: List[FaceRuntime]
    port_freqs_hz: np.ndarray
    nf_freqs_hz: np.ndarray
    n_source_steps: int
    f0: float
    fc: float
    padded_shape: Tuple[int, int, int]
    probe_decim: int
    operands: YeeOperands
    face_layout: List[Tuple[int, int, int]]  # (offset, nu, nv) per face
    n_face_slots: int  # T: E (or H) face samples per probe interval
    _coeffs_np: Dict[str, np.ndarray] = None  # host copies of ``coeffs``

    @property
    def shape(self) -> Tuple[int, int, int]:
        return self.grid.shape

    @property
    def dft_dt(self) -> float:
        """Effective sampling interval of the DFT sums (dt × decimation)."""
        return self.dt * self.probe_decim

    def _adapt_resume_arrays(self, resume_state):
        """Crop/zero-pad a resume state's 3-D arrays to this simulation's
        shape. Pad cells carry zero coefficients and stay zero, so a state
        written with another padding (the JAX package pads for its
        kernels) resumes exactly."""
        tgt = self.padded_shape

        def fix(a):
            a = _to_numpy(a)
            if a.ndim != 3 or a.shape == tuple(tgt):
                return a
            a = a[tuple(slice(0, min(a.shape[i], tgt[i])) for i in range(3))]
            pads = [(0, tgt[i] - a.shape[i]) for i in range(3)]
            return np.pad(a, pads) if any(p[1] for p in pads) else a

        out = dict(resume_state)
        out["fields"] = tuple(fix(f) for f in resume_state["fields"])
        for grp in ("psi_e", "psi_h"):
            if resume_state.get(grp):
                out[grp] = {k: fix(v) for k, v in resume_state[grp].items()}
        return out

    def run(self, resume_state=None, progress_cb=None, abort_cb=None):
        """Execute (or resume) the simulation.

        ``resume_state`` is the ``out["state"]`` of a previous run of
        either package, as numpy arrays or tensors; the loop continues
        from its step count until ``n_steps_max`` or the energy criterion.
        ``progress_cb(steps_done, n_steps_max, e_ratio)`` is called after
        every chunk that does not end the run, and once at the end;
        ``abort_cb() -> bool`` is checked after every chunk and stops the
        run (``aborted=True``, the state is a valid checkpoint).
        """
        return run_simulation(self, fdtd_cuda.kernels, resume_state,
                              progress_cb, abort_cb)


# ---------------------------------------------------------------------------
# CPML (convolutional PML) profiles
# ---------------------------------------------------------------------------

def _cpml_profiles(
    grid: YeeGrid,
    padded_shape: Tuple[int, int, int],
    dt: float,
    npml: int,
    m: float = 3.0,
    r0: float = 1e-8,
    alpha_max: float = 0.05,
):
    """Per-axis recursive-convolution coefficients b, c at node and half
    positions (Roden–Gedney CPML, κ = 1).

    σ is polynomially graded over the *physical* slab depth, so the graded
    mesh needs no special casing; σ_max = −(m+1)·ln(R0)/(2·η0·L_slab) per
    side. α is linearly graded from α_max at the inner interface to 0 at
    the wall (CFS term for low-frequency/evanescent absorption).
    """
    out = {}
    for a, name in enumerate("xyz"):
        lines = grid.lines[name] * grid.unit  # meters
        Q = len(lines)
        P = padded_shape[a]
        if npml * 2 + 4 > Q:
            raise ValueError(
                f"grid axis {name} too small for {npml}-cell PML"
            )
        x_lo, x_hi = lines[npml], lines[Q - 1 - npml]
        L_lo = x_lo - lines[0]
        L_hi = lines[-1] - x_hi
        s_max_lo = -(m + 1.0) * math.log(r0) / (2.0 * ETA0 * L_lo)
        s_max_hi = -(m + 1.0) * math.log(r0) / (2.0 * ETA0 * L_hi)

        prof = {}
        for kind in ("node", "half"):
            pos = np.full(P, 0.5 * (x_lo + x_hi))  # pad slots → interior
            if kind == "node":
                pos[:Q] = lines
            else:
                pos[: Q - 1] = 0.5 * (lines[:-1] + lines[1:])
            d = np.zeros(P)
            s_max = np.zeros(P)
            lo = pos < x_lo
            hi = pos > x_hi
            d[lo] = (x_lo - pos[lo]) / L_lo
            s_max[lo] = s_max_lo
            d[hi] = (pos[hi] - x_hi) / L_hi
            s_max[hi] = s_max_hi
            d = np.clip(d, 0.0, 1.0)
            sigma = s_max * d**m
            alpha = alpha_max * (1.0 - d) * (d > 0)
            b = np.exp(-(sigma + alpha) * dt / EPS0)
            denom = sigma + alpha
            c = np.where(denom > 0, sigma / np.maximum(denom, 1e-30) * (b - 1.0), 0.0)
            prof[kind] = (b.astype(np.float32), c.astype(np.float32))
        out[a] = prof
    return out


# ---------------------------------------------------------------------------
# builders
# ---------------------------------------------------------------------------

def _build_port_runtime(
    spec: LumpedPortSpec,
    grid: YeeGrid,
    sigma_edges: Dict[str, np.ndarray],
) -> PortRuntime:
    """Resolve a port spec to grid edges; folds its resistance into the
    edge conductivity arrays (mutates ``sigma_edges``) — the Piket-May
    lumped-element formulation: a resistor R across edges of length dl and
    dual area A is exactly an added conductivity σ_p = L_total/(R·A)."""
    axis = _AXIS_OF[spec.direction]
    t_axes = [a for a in range(3) if a != axis]
    lines = [grid.x, grid.y, grid.z]

    def nearest(ax: int, val: float) -> int:
        return int(np.argmin(np.abs(lines[ax] - val)))

    start = np.asarray(spec.start, float)
    stop = np.asarray(spec.stop, float)
    ti = [nearest(a, start[a]) for a in t_axes]
    e0 = nearest(axis, min(start[axis], stop[axis]))
    e1 = nearest(axis, max(start[axis], stop[axis]))
    n_edges = max(1, e1 - e0)

    d_axis = np.diff(lines[axis]) * grid.unit  # primary spacings (m)
    dl = d_axis[e0 : e0 + n_edges]
    dd = [grid.dual_deltas_m("xyz"[a]) for a in range(3)]
    area = dd[t_axes[0]][ti[0]] * dd[t_axes[1]][ti[1]]

    sl: List = [None, None, None]
    sl[axis] = slice(e0, e0 + n_edges)
    sl[t_axes[0]] = ti[0]
    sl[t_axes[1]] = ti[1]
    sl = tuple(sl)

    # fold resistor conductivity into the E-edge sigma for this component
    comp = "e" + spec.direction
    sigma_p = dl.sum() / (spec.resistance * area)
    sigma_edges[comp][sl] += sigma_p

    # current probe: H loop around the middle edge. With (a, u, v) a cyclic
    # right-handed triple, ∮H·dl over the dual face is ΔH_v·dd_v − ΔH_u·dd_u.
    u, v = (axis + 1) % 3, (axis + 2) % 3
    k_mid = e0 + n_edges // 2
    idx = [0, 0, 0]
    idx[axis] = k_mid
    for a, t in zip(t_axes, ti):
        idx[a] = t

    def tup(base, ax, off):
        t2 = list(base)
        t2[ax] += off
        return tuple(t2)

    # the Ampère loop needs the H row one cell below the port in both
    # transverse directions; a port on the wall would read index −1
    for a in (u, v):
        if idx[a] < 1:
            raise ValueError(
                f"lumped port at {'xyz'[a]}-index {idx[a]} touches the "
                "grid boundary; its current probe needs one cell of "
                "clearance — move the port or extend the grid"
            )
    i_gather = [
        tup(idx, u, 0),  # Hv at idx        (+)
        tup(idx, u, -1),  # Hv at idx − û   (−)
        tup(idx, v, 0),  # Hu at idx        (−)
        tup(idx, v, -1),  # Hu at idx − v̂   (+)
    ]
    i_lengths = (float(dd[v][idx[v]]), float(dd[u][idx[u]]))

    return PortRuntime(
        spec=spec,
        axis=axis,
        sl=sl,
        dl_m=dl,
        src_col=np.zeros_like(dl, dtype=np.float32),  # filled after cb known
        i_gather=i_gather,
        i_lengths=i_lengths,
    )


def _build_faces(
    grid: YeeGrid, box_idx: Tuple[int, int, int, int, int, int]
) -> List[FaceRuntime]:
    i0, i1, j0, j1, k0, k1 = box_idx
    lines_m = [grid.x * grid.unit, grid.y * grid.unit, grid.z * grid.unit]
    d_m = [np.diff(l) for l in lines_m]
    centers_m = [0.5 * (l[:-1] + l[1:]) for l in lines_m]
    lo = {0: i0, 1: j0, 2: k0}
    hi = {0: i1, 1: j1, 2: k1}
    faces: List[FaceRuntime] = []
    for axis in range(3):
        u_axis, v_axis = [a for a in range(3) if a != axis]
        u0, u1 = lo[u_axis], hi[u_axis]
        v0, v1 = lo[v_axis], hi[v_axis]
        cu = centers_m[u_axis][u0:u1]
        cv = centers_m[v_axis][v0:v1]
        dA = np.outer(d_m[u_axis][u0:u1], d_m[v_axis][v0:v1])
        for side, m in (("lo", lo[axis]), ("hi", hi[axis])):
            normal = np.zeros(3)
            normal[axis] = -1.0 if side == "lo" else 1.0
            cpts = np.zeros((len(cu), len(cv), 3))
            cpts[..., axis] = lines_m[axis][m]
            cpts[..., u_axis] = cu[:, None]
            cpts[..., v_axis] = cv[None, :]
            faces.append(
                FaceRuntime(
                    name=f"{'xyz'[axis]}_{side}",
                    axis=axis,
                    m=m,
                    u_axis=u_axis,
                    v_axis=v_axis,
                    u0=u0,
                    u1=u1,
                    v0=v0,
                    v1=v1,
                    normal=normal,
                    centers_m=cpts,
                    areas_m2=dA,
                )
            )
    return faces


def build_src_mats(sim, Px, Py, Pz) -> Dict[int, np.ndarray]:
    """Per-component dense source stamps: every lumped-port column of one
    E component folded into one (Px, Py, Pz) array, keyed by component."""
    src_mats = {}
    for prt in sim.ports:
        mat = src_mats.setdefault(prt.axis, np.zeros((Px, Py, Pz), np.float32))
        mat[prt.sl] += prt.src_col
    return src_mats


def build_probe_gathers(sim: "PreparedSimulation"):
    """Flat gather indices + weights for every probe quantity.

    Indices address the flattened (Px, Py, Pz) arrays of one field stack
    (E or H), component-major. Returns ``(pg_e_idx, pg_e_w, pg_h_idx,
    pg_h_w, face_layout, T_faces, pv_idx, pv_w, pi_idx, pi_w)`` — face
    tangential E/H gathers (with the per-face slot layout), and per-port
    V/I gathers. The JAX package's function of the same name with
    ``Pz_stride = Pz`` gives the same tables.
    """
    Px, Py, Pz = sim.padded_shape
    faces = sim.faces
    nf_shapes = [(f.u1 - f.u0, f.v1 - f.v0) for f in faces]
    n_ports = n_probe_rows(sim)

    def _flat_idx(comp, i, j, k):
        return ((comp * Px + i) * Py + j) * Pz + k

    e_idx, e_w, h_idx, h_w = [], [], [], []
    layout = []
    off = 0
    for face, (nu, nv) in zip(faces, nf_shapes):
        a, m = face.axis, face.m
        ua, va = face.u_axis, face.v_axis
        uu = np.arange(face.u0, face.u1)
        vv = np.arange(face.v0, face.v1)
        U, V = np.meshgrid(uu, vv, indexing="ij")

        def eidx(comp, a_i, u_off, v_off):
            c = [None, None, None]
            c[a] = np.full_like(U, a_i)
            c[ua] = U + u_off
            c[va] = V + v_off
            return _flat_idx(comp, c[0], c[1], c[2]).ravel()

        # E_u then E_v (comp-major, row-major within), matching the
        # (2, nu, nv) per-face accumulator layout
        e_idx.append(np.stack([eidx(ua, m, 0, 0), eidx(ua, m, 0, 1)], -1))
        e_idx.append(np.stack([eidx(va, m, 0, 0), eidx(va, m, 1, 0)], -1))
        e_w.extend([np.full((nu * nv, 2), 0.5, np.float32)] * 2)
        h_idx.append(np.stack([
            eidx(ua, m - 1, 0, 0), eidx(ua, m, 0, 0),
            eidx(ua, m - 1, 1, 0), eidx(ua, m, 1, 0)], -1))
        h_idx.append(np.stack([
            eidx(va, m - 1, 0, 0), eidx(va, m, 0, 0),
            eidx(va, m - 1, 0, 1), eidx(va, m, 0, 1)], -1))
        h_w.extend([np.full((nu * nv, 4), 0.25, np.float32)] * 2)
        layout.append((off, nu, nv))
        off += 2 * nu * nv
    pg_e_idx = np.concatenate(e_idx)
    pg_e_w = np.concatenate(e_w)
    pg_h_idx = np.concatenate(h_idx)
    pg_h_w = np.concatenate(h_w)
    T_faces = off

    v_lists, i_lists = port_probe_sources(sim)

    def _pack_sources(lists):
        S = max([1] + [len(l) for l in lists])
        idx = np.zeros((n_ports, S), np.int64)
        w = np.zeros((n_ports, S), np.float32)
        for piNo, lst in enumerate(lists):
            for e, ((comp, ii, jj, kk), weight) in enumerate(lst):
                idx[piNo, e] = _flat_idx(comp, ii, jj, kk)
                w[piNo, e] = weight
        return idx, w

    pv_idx, pv_w = _pack_sources(v_lists)
    pi_idx, pi_w = _pack_sources(i_lists)
    return (pg_e_idx, pg_e_w, pg_h_idx, pg_h_w, layout, T_faces,
            pv_idx, pv_w, pi_idx, pi_w)


def _probe_table(gathers, n_cells: int):
    """One (rows, k) table over the stack [Ex Ey Ez Hx Hy Hz]: rows are
    port V, port I, face E, face H; short rows pad with weight 0."""
    (pg_e_idx, pg_e_w, pg_h_idx, pg_h_w, _layout, _T,
     pv_idx, pv_w, pi_idx, pi_w) = gathers
    if 6 * n_cells >= 2**31:
        raise ValueError(f"{n_cells} cells: too many for int32 probe indices")
    h_off = 3 * n_cells
    blocks = [(pv_idx, pv_w), (pi_idx + h_off, pi_w),
              (pg_e_idx, pg_e_w), (pg_h_idx + h_off, pg_h_w)]
    k = max(b[0].shape[1] for b in blocks)
    idx = np.concatenate([
        np.pad(i, ((0, 0), (0, k - i.shape[1]))) for i, _ in blocks])
    w = np.concatenate([
        np.pad(x, ((0, 0), (0, k - x.shape[1]))) for _, x in blocks])
    return idx.astype(np.int32), w.astype(np.float32)


def build_simulation(
    scene: Scene,
    grid: YeeGrid,
    *,
    f0: float,
    fc: float,
    device,
    cfg: FDTDConfig = FDTDConfig(),
    port_freqs_hz: Optional[np.ndarray] = None,
    nf_freqs_hz: Optional[np.ndarray] = None,
) -> PreparedSimulation:
    """Voxelize, build the coefficients and probes, and move them to
    ``device`` ('cuda' runs the kernels, 'cpu' the plain twins)."""
    dev = resolve_device(device)
    if scene.msl_ports:
        raise NotImplementedError(
            "MSL ports are not ported to fdtd_solver_antennas_tpu_torch yet")
    Px, Py, Pz = grid.shape
    dt = grid.courant_dt(cfg.courant)

    vox = voxelize(scene, grid)

    # --- per-edge material arrays -----------------------------------------
    sigma_edges = {
        "ex": cell_to_edge_average(vox.sigma, "ex"),
        "ey": cell_to_edge_average(vox.sigma, "ey"),
        "ez": cell_to_edge_average(vox.sigma, "ez"),
    }
    # finite-conductivity metallization: per-edge added conductivity
    for comp, sheet in (("ex", vox.sheet_sigma_ex),
                        ("ey", vox.sheet_sigma_ey),
                        ("ez", vox.sheet_sigma_ez)):
        if sheet is not None:
            sigma_edges[comp] = sigma_edges[comp] + sheet
    eps_edges = {
        c: cell_to_edge_average(vox.eps_r, c) * EPS0 for c in ("ex", "ey", "ez")
    }

    # --- ports fold their resistance into sigma ---------------------------
    ports = [_build_port_runtime(p, grid, sigma_edges) for p in scene.ports]

    # --- Ca/Cb per component ----------------------------------------------
    pec = {"ex": vox.pec_ex, "ey": vox.pec_ey, "ez": vox.pec_ez}
    coeffs_np: Dict[str, np.ndarray] = {}
    mur = cfg.boundary.upper().startswith("MUR")
    for comp, d_axis in (("ex", 0), ("ey", 1), ("ez", 2)):
        eps_a = eps_edges[comp]
        sig_a = sigma_edges[comp]
        beta = sig_a * dt / (2.0 * eps_a)
        ca = (1.0 - beta) / (1.0 + beta)
        cb = (dt / eps_a) / (1.0 + beta)
        # invalid trailing slot along the component's own axis
        sl = [slice(None)] * 3
        sl[d_axis] = -1
        ca[tuple(sl)] = 0.0
        cb[tuple(sl)] = 0.0
        # outer boundary planes tangential to this component
        for b_axis in (a for a in range(3) if a != d_axis):
            for idx in (0, grid.shape[b_axis] - 1):
                slb = [slice(None)] * 3
                slb[b_axis] = idx
                cb[tuple(slb)] = 0.0
                ca[tuple(slb)] = 1.0 if mur else 0.0
        # PEC objects win last
        ca[pec[comp]] = 0.0
        cb[pec[comp]] = 0.0
        coeffs_np["ca_" + comp] = ca.astype(np.float32, copy=False)
        coeffs_np["cb_" + comp] = cb.astype(np.float32, copy=False)

    # --- port source columns (need cb) ------------------------------------
    dd = [grid.dual_deltas_m("xyz"[a]) for a in range(3)]
    for prt in ports:
        cb_col = coeffs_np["cb_e" + prt.spec.direction][prt.sl]
        t_axes = [a for a in range(3) if a != prt.axis]
        idx_probe = prt.i_gather[0]
        area = dd[t_axes[0]][idx_probe[t_axes[0]]] * dd[t_axes[1]][idx_probe[t_axes[1]]]
        unit = (cb_col / (prt.spec.resistance * area)).astype(np.float32)
        prt.src_col = (unit * prt.spec.excite).astype(np.float32)

    padded_shape = tuple(grid.shape)

    # --- inverse spacing vectors -------------------------------------------
    inv_p, inv_d = {}, {}
    for a, name in enumerate("xyz"):
        d = grid.deltas_m(name)
        ip = np.zeros(padded_shape[a], np.float32)
        ip[: len(d)] = 1.0 / d
        inv_p[a] = ip
        idv = np.zeros(padded_shape[a], np.float32)
        idv[: grid.shape[a]] = 1.0 / grid.dual_deltas_m(name)
        inv_d[a] = idv

    # --- MUR face coefficients ----------------------------------------------
    mur_coef = None
    if mur:
        mur_coef = []
        for name in "xyz":
            d = grid.deltas_m(name)
            mur_coef.append((
                float(np.float32((C0 * dt - d[0]) / (C0 * dt + d[0]))),
                float(np.float32((C0 * dt - d[-1]) / (C0 * dt + d[-1]))),
            ))
        mur_coef = tuple(mur_coef)

    # --- CPML profiles -------------------------------------------------------
    npml = cfg.pml_cells()
    pml = _cpml_profiles(grid, padded_shape, dt, npml) if npml > 0 else None

    # --- NF2FF faces ----------------------------------------------------------
    m = max(_NF_MARGIN_CELLS, npml + 3)  # keep the box out of the PML
    faces = _build_faces(grid, (m, Px - 1 - m, m, Py - 1 - m, m, Pz - 1 - m))

    # --- excitation ------------------------------------------------------------
    n_src = source_active_steps(f0, fc, dt)
    # the waveform covers the full source duration, not just n_steps_max,
    # so a short run's checkpoint resumes to the same physics
    waveform = gaussian_excitation(
        f0, fc, dt, max(int(cfg.n_steps_max), n_src))

    if port_freqs_hz is None:
        port_freqs_hz = np.linspace(max(1e8, f0 * 0.5), f0 * 1.5, 201)
    if nf_freqs_hz is None:
        nf_freqs_hz = np.linspace(f0 * 0.85, f0 * 1.15, 11)
    port_freqs_hz = np.asarray(port_freqs_hz, np.float64)
    nf_freqs_hz = np.asarray(nf_freqs_hz, np.float64)

    if cfg.probe_decimation is not None:
        probe_decim = max(1, int(cfg.probe_decimation))
    else:
        # 2.5x the -20 dB corner: content that could alias back sits at
        # ≥1.8·fc beyond the corner, where the Gaussian envelope is below
        # 10^-3 in amplitude.
        probe_decim = max(1, int(1.0 / (2.5 * (f0 + fc) * dt)))
    probe_decim = min(probe_decim, max(1, int(cfg.check_every)))

    def to_dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    coeffs = {k: to_dev(v) for k, v in coeffs_np.items()}
    sim = PreparedSimulation(
        grid=grid,
        dt=dt,
        cfg=cfg,
        device=dev,
        coeffs=coeffs,
        waveform=waveform,
        ports=ports,
        faces=faces,
        port_freqs_hz=port_freqs_hz,
        nf_freqs_hz=nf_freqs_hz,
        n_source_steps=n_src,
        f0=f0,
        fc=fc,
        padded_shape=padded_shape,
        probe_decim=probe_decim,
        operands=None,
        face_layout=[],
        n_face_slots=0,
        _coeffs_np=coeffs_np,
    )
    gathers = build_probe_gathers(sim)
    sim.face_layout, sim.n_face_slots = gathers[4], gathers[5]
    probe_idx, probe_w = _probe_table(gathers, Px * Py * Pz)
    src = build_src_mats(sim, Px, Py, Pz)
    sim.operands = YeeOperands(
        shape=padded_shape,
        grid_shape=tuple(grid.shape),
        dtmu=float(np.float32(dt / MU0)),
        inv_p=tuple(to_dev(inv_p[a]) for a in range(3)),
        inv_d=tuple(to_dev(inv_d[a]) for a in range(3)),
        ca=tuple(coeffs["ca_" + c] for c in ("ex", "ey", "ez")),
        cb=tuple(coeffs["cb_" + c] for c in ("ex", "ey", "ez")),
        src=tuple(to_dev(src[a]) if a in src else None for a in range(3)),
        mur=mur_coef,
        pml=None if pml is None else {
            "bh": tuple(to_dev(pml[a]["half"][0]) for a in range(3)),
            "ch": tuple(to_dev(pml[a]["half"][1]) for a in range(3)),
            "be": tuple(to_dev(pml[a]["node"][0]) for a in range(3)),
            "ce": tuple(to_dev(pml[a]["node"][1]) for a in range(3)),
        },
        probe_idx=to_dev(probe_idx),
        probe_w=to_dev(probe_w),
    )
    return sim


# ---------------------------------------------------------------------------
# resumable state
# ---------------------------------------------------------------------------

def _to_numpy(a):
    if torch.is_tensor(a):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def state_to_numpy(state) -> dict:
    """A run's ``out["state"]`` as numpy arrays, in the JAX package's
    layout (its ``run(resume_state=...)`` takes the result)."""
    out = {
        "fields": tuple(_to_numpy(f) for f in state["fields"]),
        "psi_e": {k: _to_numpy(v) for k, v in state["psi_e"].items()},
        "psi_h": {k: _to_numpy(v) for k, v in state["psi_h"].items()},
    }
    for k in ("uf", "if_", "nf_e", "nf_h"):
        out[k] = _to_numpy(state[k]).astype(np.float32)
    out["n"] = np.int32(_to_numpy(state["n"]))
    out["e_max"] = np.float32(_to_numpy(state["e_max"]))
    out["e_ratio"] = np.float32(_to_numpy(state["e_ratio"]))
    if "decim" in state:
        out["decim"] = np.int32(_to_numpy(state["decim"]))
    return out


def state_from_numpy(state, device) -> dict:
    """A state of either package (numpy arrays or tensors) as float32
    tensors on ``device``; scalars stay Python numbers."""
    dev = torch.device(device)

    def t(a):
        return torch.from_numpy(np.array(_to_numpy(a), np.float32)).to(dev)

    out = {
        "fields": tuple(t(f) for f in state["fields"]),
        "psi_e": {k: t(v) for k, v in (state.get("psi_e") or {}).items()},
        "psi_h": {k: t(v) for k, v in (state.get("psi_h") or {}).items()},
    }
    for k in ("uf", "if_", "nf_e", "nf_h"):
        out[k] = t(state[k])
    out["n"] = int(_to_numpy(state["n"]))
    out["e_max"] = float(np.float32(_to_numpy(state["e_max"])))
    out["e_ratio"] = float(np.float32(_to_numpy(state["e_ratio"])))
    if state.get("decim") is not None:
        out["decim"] = int(_to_numpy(state["decim"]))
    return out


# ---------------------------------------------------------------------------
# the time loop
# ---------------------------------------------------------------------------

def run_simulation(sim: PreparedSimulation, impl, resume_state=None,
                   progress_cb=None, abort_cb=None) -> dict:
    """The chunk loop of :meth:`PreparedSimulation.run`, stepping with
    ``impl`` — :data:`fdtd_cuda.kernels` (kernel on CUDA, plain twin on
    CPU) or :data:`fdtd_cuda.plain` (plain twins everywhere, to compare
    with the kernels on the card).

    A chunk is ``n_sub`` probe intervals of ``D`` steps. After each
    interval every probe is sampled into a staging buffer; after each
    chunk the samples fold into the DFT accumulators as matmuls, and the
    energy check decides whether to stop (one host sync per chunk).
    """
    cfg = sim.cfg
    dev = sim.device
    ops = sim.operands
    decim = int(sim.probe_decim)
    n_sub = max(1, int(cfg.check_every) // decim)
    chunk = n_sub * decim
    n_chunks_max = int(math.ceil(cfg.n_steps_max / chunk))
    n_ports = n_probe_rows(sim)
    T = sim.n_face_slots
    f32 = dict(dtype=torch.float32, device=dev)

    st = fdtd_cuda.new_state(sim.padded_shape, dev, ops.pml is not None)
    acc = {
        "uf": torch.zeros((2, n_ports, len(sim.port_freqs_hz)), **f32),
        "if_": torch.zeros((2, n_ports, len(sim.port_freqs_hz)), **f32),
        "nf_e": torch.zeros((2, len(sim.nf_freqs_hz), T), **f32),
        "nf_h": torch.zeros((2, len(sim.nf_freqs_hz), T), **f32),
    }
    n = 0
    e_max = torch.zeros((), **f32)
    ratio = 1.0
    if resume_state is not None:
        rs = state_from_numpy(sim._adapt_resume_arrays(resume_state), dev)
        old = rs.pop("decim", None)
        if old is not None:
            # the sums were built at the old cadence; scale them so the
            # dft_dt = dt·decim factor stays a correct integral
            scale = float(np.float32(old) / np.float32(decim))
            for k in acc:
                rs[k] = rs[k] * scale
        for k in acc:
            acc[k].copy_(rs[k])
        for dst, src in zip(st.fields, rs["fields"]):
            dst.copy_(src)
        if ops.pml is not None and rs["psi_e"]:
            for dst, k in zip(st.psi_e, PSI_KEYS):
                dst.copy_(rs["psi_e"][k])
            for dst, k in zip(st.psi_h, PSI_KEYS):
                dst.copy_(rs["psi_h"][k])
        n = rs["n"]
        e_max.fill_(rs["e_max"])
        ratio = rs["e_ratio"]

    # zero-padded to whole chunks past any start: a chunk that overruns
    # n_steps_max injects zeros, never replays source samples
    wf = np.zeros(max(n_chunks_max * chunk, len(sim.waveform)) + chunk,
                  np.float32)
    wf[: len(sim.waveform)] = sim.waveform
    wf = wf.tolist()

    w_port = torch.from_numpy(
        (2 * math.pi * sim.port_freqs_hz).astype(np.float32)).to(dev)
    w_nf = torch.from_numpy(
        (2 * math.pi * sim.nf_freqs_hz).astype(np.float32)).to(dev)
    j_idx = torch.arange(n_sub, **f32)
    # float32 scalars as Python floats: exact, and no host→device copy
    dt32 = float(np.float32(sim.dt))
    half_dt32 = float(np.float32(0.5 * sim.dt))
    bufs = torch.zeros((n_sub, ops.probe_idx.shape[0]), **f32)
    b_v = bufs[:, :n_ports]
    b_i = bufs[:, n_ports:2 * n_ports]
    b_fe = bufs[:, 2 * n_ports:2 * n_ports + T]
    b_fh = bufs[:, 2 * n_ports + T:]
    end = np.float32(cfg.end_criteria)

    aborted = False
    while n < cfg.n_steps_max:
        n0 = n
        for j in range(n_sub):
            for _ in range(decim):
                fdtd_cuda.leapfrog_step(impl, ops, st, wf[n])
                n += 1
            impl.probe_gather(ops, st, bufs[j])

        # DFT flush: sample j sits after step n0 + (j+1)·D — E at that
        # time, H half a step earlier. Angles in float32, as the JAX
        # package forms them; layout (re, −im).
        t_e = ((j_idx + 1.0) * decim + float(n0)) * dt32
        t_h = t_e - half_dt32

        def dft(w, t):
            ang = w[:, None] * t[None, :]
            return torch.cos(ang), torch.sin(ang)

        ce, se = dft(w_port, t_e)
        ch, sh = dft(w_port, t_h)
        acc["uf"] += torch.stack([ce @ b_v, -(se @ b_v)]).transpose(1, 2)
        acc["if_"] += torch.stack([ch @ b_i, -(sh @ b_i)]).transpose(1, 2)
        ce, se = dft(w_nf, t_e)
        ch, sh = dft(w_nf, t_h)
        acc["nf_e"] += torch.stack([ce @ b_fe, -(se @ b_fe)])
        acc["nf_h"] += torch.stack([ch @ b_fh, -(sh @ b_fh)])

        # energy-decay check over the current E
        energy = sum((e * e).sum() for e in st.e[st.parity])
        e_max = torch.maximum(e_max, energy)
        r = torch.where(e_max > 0, energy / e_max, torch.ones((), **f32))
        ratio = float(r)  # the one host sync of the chunk
        if ratio < end and n > sim.n_source_steps:
            break
        if progress_cb is not None:
            progress_cb(n, int(cfg.n_steps_max), ratio)
        if abort_cb is not None and abort_cb():
            aborted = True
            break

    if progress_cb is not None and not aborted:
        progress_cb(n, n, ratio)
    return _assemble_output(sim, st, acc, n, e_max, ratio, decim, aborted)


def _assemble_output(sim, st, acc, n, e_max, ratio, decim, aborted) -> dict:
    """Output dict + resumable state (fields/ψ in the 3-D grid layout)."""
    n_nf = len(sim.nf_freqs_hz)
    fields = st.fields
    state = {
        "fields": fields,
        "psi_e": dict(zip(PSI_KEYS, st.psi_e)),
        "psi_h": dict(zip(PSI_KEYS, st.psi_h)),
        **acc,
        "n": n,
        "e_max": float(e_max),
        "e_ratio": ratio,
        "decim": decim,
    }

    def split_faces(a):
        a = _to_numpy(a)
        return [
            a[:, :, off : off + 2 * nu * nv].reshape(2, n_nf, 2, nu, nv)
            for (off, nu, nv) in sim.face_layout
        ]

    return dict(
        uf=nf_to_complex(acc["uf"]),
        if_=nf_to_complex(acc["if_"]),
        nf_e=split_faces(acc["nf_e"]),
        nf_h=split_faces(acc["nf_h"]),
        steps=n,
        e_ratio=ratio,
        fields=fields,
        state=state,
        aborted=aborted,
    )
