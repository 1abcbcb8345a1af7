"""Yee-grid FDTD engine in PyTorch.

Counterpart of ``fdtd_solver_antennas_tpu/ops/fdtd.py`` (its XLA path):

- staggered (Ex..Hz) leapfrog update on a graded mesh with per-axis
  inverse-spacing vectors;
- first-order MUR walls, PEC walls, or an N-cell CPML (``PML_N``);
- lumped resistive ports folded into the E-update as an edge conductivity
  plus a soft source, with V/I probes; microstrip-line (MSL) ports as a
  soft Ez source plane under the strip, with three V and two I probes
  for the 3-probe deembedding (``post/ports.py::msl_port_spectra``);
- decimated probe sampling: port V/I and Huygens-box tangential fields
  every D steps, staged per chunk and folded into the DFT accumulators as
  matmuls;
- an energy-decay early exit checked once per chunk;
- re-excitation of a prepared simulation (:func:`set_port_excitation`),
  its source stamps rewritten on the device in place.

The steps are K1's ``chunk_steps`` (``ops/fdtd_cuda.py``, "chunk" mode):
one launch per termination chunk, the probe samples taken in the kernel;
or, for grids whose working set exceeds the L2, the T-step kernel of
``ops/fdtd_stream.py`` ("stream" mode, K2), with K1's ``probe_gather``
between launches; :func:`resolve_pallas_mode` picks one. A geometry
sweep's B design variants of one grid run through :func:`run_batched`
in the mode its base resolved: one ``chunk_steps_batch`` launch per
chunk for all of them (batched K1), or in stream mode one
``stream_steps_batch`` launch per T steps and one ``probe_gather_batch``
per probe interval (batched K2). On a CUDA device the run launches the kernels, on the CPU it runs their
plain PyTorch twins. There is no other switch. The accumulators and the resumable state
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
from ..utils.tracing import span
from . import fdtd_cuda, fdtd_stream, grid_build
from .fdtd_cuda import PSI_KEYS, ProbeTable, YeeOperands
from .mesh import YeeGrid
from .source import gaussian_excitation, source_active_steps
from .voxelize import cell_to_edge_average, voxelize

_AXIS_OF = {"x": 0, "y": 1, "z": 2}


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


def nf_to_complex(stacked, axis: int = 0) -> np.ndarray:
    """Convert a stacked (re, im) float array to complex on the host;
    ``axis`` is the 2-wide re/im axis (1 for batched outputs, whose
    variant axis leads). Complex input passes through."""
    a = _to_numpy(stacked)
    if np.iscomplexobj(a):
        return a
    return np.take(a, 0, axis) + 1j * np.take(a, 1, axis)


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
    # Stepping kernels, under the JAX package's names: "chunk" (K1, one
    # launch per termination chunk) or "stream" (K2, T steps per launch).
    # None → auto: stream when the working set exceeds the L2.
    pallas_mode: str | None = None
    # Leapfrog steps per stream launch. None → the deepest the march's
    # region allows (threads, shared memory), at most the probe decimation.
    stream_T: int | None = None

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
    # excite=1 basis of src_col, the column a re-excitation rescales
    src_col_unit: Optional[np.ndarray] = None
    # the resistor's conductivity, added to the sigma of the edges ``sl``
    sigma_p: float = 0.0


@dataclasses.dataclass
class MSLRuntime:
    """MSL-port geometry resolved onto the grid.

    ``sl`` selects the excited block of Ez edges at the excitation plane.
    ``v_probes`` / ``i_probes`` are probe source lists
    [((comp, i, j, k), weight)] over the E / H field stacks: three V
    probes on node planes m−1, m, m+1 and two Ampère-loop I probes on
    dual planes m−½, m+½ around the measurement plane (openEMS-style
    3-probe deembedding). ``v_pos_m`` / ``i_pos_m`` are the probe-plane
    coordinates along the propagation axis, in meters.
    """

    spec: object  # models.scene.MSLPortSpec
    sl: Tuple
    src_col: np.ndarray  # filled once cb is known
    v_probes: list  # 3 probe source lists
    i_probes: list  # 2 probe source lists
    v_pos_m: np.ndarray
    i_pos_m: np.ndarray
    z_ref: float
    # excite=1 basis of src_col, the plane a re-excitation rescales
    src_col_unit: Optional[np.ndarray] = None

    # each MSL port occupies this many probe rows in the uf/if_
    # accumulators: (V@m−1, I@m−½), (V@m, I@m+½), (V@m+1, —)
    N_ROWS = 3


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
    """Per-port probe source lists, lumped ports first, then MSL: for
    each row a list of ((comp, i, j, k), weight) terms — V over the E
    stack, I over the H stack. An MSL port gives three rows; its third I
    row has no terms (``build_probe_gathers`` pads it with weight 0)."""
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
    for msl in sim.msl_ports:
        v_lists += msl.v_probes
        i_lists += [msl.i_probes[0], msl.i_probes[1], []]
    return v_lists, i_lists


def n_probe_rows(sim: "PreparedSimulation") -> int:
    """Rows in the uf/if_ port-DFT accumulators: one per lumped port,
    :attr:`MSLRuntime.N_ROWS` per MSL port."""
    return len(sim.ports) + MSLRuntime.N_ROWS * len(sim.msl_ports)


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
    msl_ports: List[MSLRuntime]
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
    # host copies of ``coeffs``, made at the first read of :attr:`_coeffs_np`
    _coeffs_host: Dict[str, np.ndarray] = None
    # host copies of (inv_p, inv_d, mur_coef, pml): the 1-D spacing
    # profiles per axis, the MUR coefficients ((x0, x1), (y0, y1), (z0, z1))
    # or None, and the CPML profiles {axis: {"node"|"half": (b, c)}} or None
    _aux: tuple = None
    pallas_mode: str = "chunk"  # resolved stepping kernels: "chunk" | "stream"
    stream_T: int = 1  # leapfrog steps per stream launch
    pallas_mode_reason: str = ""
    # the rank mesh ``parallel.shard_simulation`` set: ``run`` then runs
    # SPMD over it (the JAX package's ``field_sharding``); None: one device
    field_sharding: object = None

    @property
    def shape(self) -> Tuple[int, int, int]:
        return self.grid.shape

    @property
    def _coeffs_np(self) -> Dict[str, np.ndarray]:
        """Host copies of ``coeffs``, copied at the first read (the
        explicit path cuts its slabs from them; no single-card run reads
        them)."""
        if self._coeffs_host is None:
            self._coeffs_host = {k: v.detach().cpu().numpy()
                                 for k, v in self.coeffs.items()}
        return self._coeffs_host

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
        every chunk that does not end the run, and once at the end (an
        exception it raises is ignored: a broken UI callback must not kill
        the run); ``abort_cb() -> bool`` is checked after every chunk and stops the
        run (``aborted=True``, the state is a valid checkpoint).

        After ``parallel.shard_simulation(sim, mesh)`` every rank of the
        mesh calls ``run`` and it runs the explicit path over the mesh
        (``parallel/sharding.py::sharded_run``); ``progress_cb`` is then
        called once at the end, and ``abort_cb`` is refused (one rank
        alone cannot stop a run of all of them).
        """
        if self.field_sharding is not None:
            from ..parallel.sharding import sharded_run

            if abort_cb is not None:
                raise ValueError("abort_cb: a sharded run stops on its "
                                 "energy criterion or step cap only")
            return sharded_run(self, resume_state, progress_cb)
        return run_simulation(self, fdtd_stream.kernels, resume_state,
                              progress_cb, abort_cb)


# ---------------------------------------------------------------------------
# which kernels step the run
# ---------------------------------------------------------------------------

# The H100's L2 cache. A working set above it comes from device memory at
# every K1 step; the stream kernel fetches it once per T steps instead.
L2_BYTES = 50 * 1024 * 1024


def working_set_bytes(shape, n_src: int, pml: bool) -> int:
    """Bytes a step touches: six fields, ca/cb, the source stamps and,
    under CPML, the twelve ψ."""
    cells = int(np.prod(shape))
    return 4 * cells * (12 + int(n_src) + (12 if pml else 0))


def resolve_pallas_mode(cfg: FDTDConfig, shape, n_src: int,
                        probe_decim: int) -> Tuple[str, int, int, str]:
    """``(mode, stream_T, probe_decim, reason)`` for a run of ``shape``.

    Mirrors the JAX package's ``_resolve_pallas_mode``: ``cfg.pallas_mode``
    forces "chunk" or "stream"; None picks "stream" when the working set
    exceeds :data:`L2_BYTES`, else "chunk". In stream mode T is
    ``cfg.stream_T`` or the deepest the march's region allows, at most the
    probe decimation, and the decimation is rounded down to a multiple of
    T. A forced ``stream_T`` that cannot be honoured raises.
    """
    forced = cfg.pallas_mode
    if forced not in (None, "chunk", "stream"):
        raise ValueError(f"pallas_mode={forced!r}: use None, 'chunk' or 'stream'")
    mur = cfg.boundary.upper().startswith("MUR")
    pml = cfg.pml_cells() > 0
    ws = working_set_bytes(shape, n_src, pml)
    fits = f"working set {ws / 1e6:.1f} MB, L2 {L2_BYTES / 1e6:.1f} MB"
    if forced == "chunk" or (forced is None and ws <= L2_BYTES):
        why = "forced" if forced else "fits the L2"
        return "chunk", 1, probe_decim, f"chunk kernels ({why}; {fits})"
    t_max = fdtd_stream.max_T(shape, mur, pml)
    want = cfg.stream_T
    if want is not None and not (1 <= want <= t_max and want <= probe_decim):
        raise ValueError(
            f"stream_T={want} cannot be honored: the march's region allows "
            f"T <= {t_max} for grid {tuple(shape)} and the probe "
            f"decimation {probe_decim} bounds it too")
    T = want or min(t_max, probe_decim)
    probe_decim = max(T, (probe_decim // T) * T)
    why = "forced" if forced else "exceeds the L2"
    kind = "CPML" if pml else "MUR" if mur else "PEC"
    return "stream", T, probe_decim, (
        f"stream kernel ({why}; {fits}) [T={T}, march under {kind}, y-z core "
        f"{fdtd_stream.march_core(mur, pml)}]")


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

def _build_port_runtime(spec: LumpedPortSpec, grid: YeeGrid) -> PortRuntime:
    """Resolve a port spec to grid edges. Its resistance is the edge
    conductivity ``sigma_p`` that the coefficient build adds on the edges
    ``sl`` — the Piket-May lumped-element formulation: a resistor R across
    edges of length dl and dual area A is exactly an added conductivity
    σ_p = L_total/(R·A)."""
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

    sigma_p = dl.sum() / (spec.resistance * area)

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
        sigma_p=sigma_p,
    )


def _build_msl_runtime(spec, grid: YeeGrid) -> MSLRuntime:
    """Resolve an MSL port spec onto the grid.

    Excitation: a uniform vertical-E (quasi-TEM) soft source on the plane
    of Ez edges under the strip at ``exc_pos``. Probes: the openEMS-style
    3-probe deembedding layout around ``meas_pos`` — three V probes
    (−∫E·dl at the strip center) on the node planes m−1, m, m+1 and two
    Ampère-loop I probes on the dual planes m−½, m+½.
    """
    axis = _AXIS_OF[spec.prop_axis]
    if axis == 2:
        raise ValueError("MSL propagation axis must be x or y")
    t_axis = 1 - axis  # the other horizontal axis
    lines = [grid.x, grid.y, grid.z]

    def nearest(ax, val):
        return int(np.argmin(np.abs(lines[ax] - val)))

    exc_i = nearest(axis, spec.exc_pos_mm)
    meas_i = nearest(axis, spec.meas_pos_mm)
    k0 = nearest(2, 0.0)
    kh = nearest(2, spec.height_mm)
    t_lo = spec.strip_center_mm - spec.strip_width_mm / 2
    t_hi = spec.strip_center_mm + spec.strip_width_mm / 2
    t_nodes = np.where(
        (lines[t_axis] >= t_lo - 1e-9) & (lines[t_axis] <= t_hi + 1e-9)
    )[0]
    if len(t_nodes) == 0:
        t_nodes = np.array([nearest(t_axis, spec.strip_center_mm)])
    j_lo, j_hi = int(t_nodes[0]), int(t_nodes[-1])
    jc = nearest(t_axis, spec.strip_center_mm)

    sl = [None, None, None]
    sl[axis] = exc_i
    sl[t_axis] = slice(j_lo, j_hi + 1)
    sl[2] = slice(k0, kh)
    sl = tuple(sl)

    dz = grid.deltas_m("z")
    dd = [grid.dual_deltas_m(n) for n in "xyz"]

    def idx3(a_i, t_j, k):
        out = [0, 0, 0]
        out[axis] = a_i
        out[t_axis] = t_j
        out[2] = k
        return tuple(out)

    def v_probe_at(p):
        """−∫Ez·dl at the strip center on node plane ``p``."""
        return [((2, *idx3(p, jc, k)), -float(dz[k])) for k in range(k0, kh)]

    # propagation direction sign: I measured along exc → meas travel
    direction = 1.0 if spec.meas_pos_mm >= spec.exc_pos_mm else -1.0

    def i_probe_at(p):
        """Ampère loop around the strip sheet using H on dual plane p+½:
        curl_x = ∂Hz/∂y − ∂Hy/∂z (axis x), curl_y = ∂Hx/∂z − ∂Hz/∂x
        (axis y)."""
        srcs = []
        for j in range(max(j_lo - 1, 1), min(j_hi + 2, len(lines[t_axis]) - 1)):
            base = idx3(p, j, kh)
            jm = idx3(p, j - 1, kh)
            km = idx3(p, j, kh - 1)
            if axis == 0:
                w_t = float(dd[2][kh]) * direction
                w_z = float(dd[t_axis][j]) * direction
                srcs += [
                    ((2, *base), w_t), ((2, *jm), -w_t),   # ΔHz·dzd
                    ((1, *base), -w_z), ((1, *km), w_z),   # −ΔHy·dyd
                ]
            else:
                w_x = float(dd[t_axis][j]) * direction
                w_z = float(dd[2][kh]) * direction
                srcs += [
                    ((0, *base), w_x), ((0, *km), -w_x),   # ΔHx·dxd
                    ((2, *base), -w_z), ((2, *jm), w_z),   # −ΔHz·dzd
                ]
        return srcs

    if not (1 <= meas_i - 1 and meas_i + 1 < len(lines[axis])):
        raise ValueError(
            "MSL measurement plane too close to the grid edge for the "
            "3-probe deembedding layout"
        )
    ax_mm = np.asarray(lines[axis], np.float64)
    v_planes = [meas_i - 1, meas_i, meas_i + 1]
    i_planes = [meas_i - 1, meas_i]
    return MSLRuntime(
        spec=spec,
        sl=sl,
        src_col=np.zeros((j_hi + 1 - j_lo, kh - k0), np.float32),
        v_probes=[v_probe_at(p) for p in v_planes],
        i_probes=[i_probe_at(p) for p in i_planes],
        v_pos_m=ax_mm[v_planes] * 1e-3,
        i_pos_m=np.array(
            [0.5 * (ax_mm[p] + ax_mm[p + 1]) for p in i_planes]
        ) * 1e-3,
        z_ref=float(spec.z0_ohm),
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
    E component, and every MSL port's Ez plane, folded into one
    (Px, Py, Pz) array, keyed by component."""
    src_mats = {}
    for prt in sim.ports:
        mat = src_mats.setdefault(prt.axis, np.zeros((Px, Py, Pz), np.float32))
        mat[prt.sl] += prt.src_col
    for msl in sim.msl_ports:
        mat = src_mats.setdefault(2, np.zeros((Px, Py, Pz), np.float32))
        mat[msl.sl] += msl.src_col
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


def probe_blocks(gathers, n_cells: int):
    """The four gathers of :func:`build_probe_gathers` as the probe
    table's blocks over the stack [Ex Ey Ez Hx Hy Hz]: port V, port I
    (+3·n_cells, into the H stack), face E, face H (+3·n_cells), each an
    ``(idx, w)`` pair of (rows, k) arrays at its own width k."""
    (pg_e_idx, pg_e_w, pg_h_idx, pg_h_w, _layout, _T,
     pv_idx, pv_w, pi_idx, pi_w) = gathers
    h_off = 3 * n_cells
    return [(pv_idx, pv_w), (pi_idx + h_off, pi_w),
            (pg_e_idx, pg_e_w), (pg_h_idx + h_off, pg_h_w)]


def host_coeffs(scene: Scene, grid: YeeGrid, ports: List[PortRuntime],
                dt: float, mur: bool,
                padded_shape: Tuple[int, int, int]) -> Dict[str, np.ndarray]:
    """The host's reference ``ca_*``/``cb_*`` (float32, ``padded_shape``,
    zero in the pad cells), as the JAX package builds them: the raster of
    :func:`voxelize` on the native core, the node averages of ε and σ,
    the sheets' and the ports' added σ, then β, Ca and Cb in float64, the
    invalid trailing slot, the outer planes tangential to each component,
    PEC last. No simulation is built from it: :func:`build_simulation`
    builds through ``ops/grid_build.py`` (its kernels on a card, their
    plain twins on the CPU), and the tests and ``chip_smoke.py`` hold that
    build to this one bit for bit."""
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
    for prt in ports:
        sigma_edges["e" + prt.spec.direction][prt.sl] += prt.sigma_p

    # --- Ca/Cb per component ----------------------------------------------
    pec = {"ex": vox.pec_ex, "ey": vox.pec_ey, "ez": vox.pec_ez}
    coeffs_np: Dict[str, np.ndarray] = {}
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
    pads = [(0, padded_shape[a] - grid.shape[a]) for a in range(3)]
    return {k: np.pad(v, pads) for k, v in coeffs_np.items()}


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
    nf_margin_cells: int = 4,
    pad_multiple: Tuple[int, int, int] = (1, 1, 1),
) -> PreparedSimulation:
    """Voxelize, build the coefficients and probes, and move them to
    ``device`` ('cuda' runs the kernels, 'cpu' the plain twins).

    The material raster and the float32 ``ca_*``/``cb_*`` are built on
    ``device`` from a packed table of the scene (``ops/grid_build.py``):
    by its CUDA kernels on a card, by their plain twins on the CPU, the
    same bits as the host's :func:`host_coeffs`. The span
    ``fdtd.prepare.voxelize`` counts ``on_device``, 1 on a card, else 0.

    ``nf_margin_cells`` is the gap between the outer wall (or the CPML
    slab, plus 3) and the Huygens box. ``pad_multiple`` zero-pads every
    3-D array so each axis is a multiple of the given value; pad cells
    carry zero ca/cb, zero inverse spacings and no source, so their fields
    stay zero and the physics is unchanged. The explicit multi-device run
    (``parallel/explicit.py``) needs ``Px`` divisible by its rank count.
    """
    dev = resolve_device(device)
    Qx, Qy, Qz = grid.shape
    dt = grid.courant_dt(cfg.courant)
    mur = cfg.boundary.upper().startswith("MUR")
    padded_shape = tuple(
        int(-(-grid.shape[a] // pad_multiple[a]) * pad_multiple[a])
        for a in range(3))
    # the lumped ports' resistances are folds of the grid's table
    ports = [_build_port_runtime(p, grid) for p in scene.ports]

    with span("fdtd.prepare.voxelize") as vox_span:
        vox_span.add("on_device", int(dev.type == "cuda"))
        table = grid_build.pack_scene(scene, grid, ports)
        with span("fdtd.prepare.upload"):
            table = table.to(dev)
        cells = grid_build.paint_cells(table)

    # the rest of the build; the uploads nest inside as their own spans
    with span("fdtd.prepare.coeffs"):
        coeffs = grid_build.edge_coeffs(table, *cells, dt, mur, padded_shape)
        del cells
        msl_ports = [_build_msl_runtime(m, grid) for m in scene.msl_ports]

        # --- MSL excitation planes (need cb): uniform quasi-TEM profile ---
        for msl in msl_ports:
            msl.src_col_unit = coeffs["cb_ez"][msl.sl].cpu().numpy().astype(
                np.float32)
            msl.src_col = (msl.src_col_unit * msl.spec.excite).astype(np.float32)

        # --- port source columns (need cb) --------------------------------
        dd = [grid.dual_deltas_m("xyz"[a]) for a in range(3)]
        for prt in ports:
            cb_col = coeffs["cb_e" + prt.spec.direction][prt.sl].cpu().numpy()
            t_axes = [a for a in range(3) if a != prt.axis]
            idx_probe = prt.i_gather[0]
            area = (dd[t_axes[0]][idx_probe[t_axes[0]]]
                    * dd[t_axes[1]][idx_probe[t_axes[1]]])
            prt.src_col_unit = (cb_col / (prt.spec.resistance * area)).astype(
                np.float32)
            prt.src_col = (prt.src_col_unit * prt.spec.excite).astype(np.float32)

        # --- inverse spacing vectors ---------------------------------------
        inv_p, inv_d = {}, {}
        for a, name in enumerate("xyz"):
            d = grid.deltas_m(name)
            ip = np.zeros(padded_shape[a], np.float32)
            ip[: len(d)] = 1.0 / d
            inv_p[a] = ip
            idv = np.zeros(padded_shape[a], np.float32)
            idv[: grid.shape[a]] = 1.0 / grid.dual_deltas_m(name)
            inv_d[a] = idv

        # --- MUR face coefficients ------------------------------------------
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

        # --- CPML profiles ---------------------------------------------------
        npml = cfg.pml_cells()
        pml = _cpml_profiles(grid, padded_shape, dt, npml) if npml > 0 else None

        # --- NF2FF faces ------------------------------------------------------
        m = max(nf_margin_cells, npml + 3)  # keep the box out of the PML
        faces = _build_faces(grid, (m, Qx - 1 - m, m, Qy - 1 - m, m, Qz - 1 - m))

        # --- excitation --------------------------------------------------------
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
        n_stamps = len({prt.axis for prt in ports} | ({2} if msl_ports else set()))
        mode, stream_T, probe_decim, mode_reason = resolve_pallas_mode(
            cfg, padded_shape, n_stamps, probe_decim)

        def to_dev(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        sim = PreparedSimulation(
            grid=grid,
            dt=dt,
            cfg=cfg,
            device=dev,
            coeffs=coeffs,
            waveform=waveform,
            ports=ports,
            msl_ports=msl_ports,
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
            pallas_mode=mode,
            stream_T=stream_T,
            pallas_mode_reason=mode_reason,
            _aux=(inv_p, inv_d, mur_coef, pml),
        )
        gathers = build_probe_gathers(sim)
        sim.face_layout, sim.n_face_slots = gathers[4], gathers[5]
        n_cells = int(np.prod(padded_shape))
        probes = ProbeTable.from_blocks(probe_blocks(gathers, n_cells), n_cells)
        src = build_src_mats(sim, *padded_shape)
        with span("fdtd.prepare.upload"):
            probes = probes.to(dev)
            on_dev = dict(
                inv_p=tuple(to_dev(inv_p[a]) for a in range(3)),
                inv_d=tuple(to_dev(inv_d[a]) for a in range(3)),
                src=tuple(to_dev(src[a]) if a in src else None for a in range(3)),
                pml=None if pml is None else {
                    "bh": tuple(to_dev(pml[a]["half"][0]) for a in range(3)),
                    "ch": tuple(to_dev(pml[a]["half"][1]) for a in range(3)),
                    "be": tuple(to_dev(pml[a]["node"][0]) for a in range(3)),
                    "ce": tuple(to_dev(pml[a]["node"][1]) for a in range(3)),
                },
            )
        sim.operands = YeeOperands(
            shape=padded_shape,
            grid_shape=tuple(grid.shape),
            dtmu=float(np.float32(dt / MU0)),
            ca=tuple(coeffs["ca_" + c] for c in ("ex", "ey", "ez")),
            cb=tuple(coeffs["cb_" + c] for c in ("ex", "ey", "ez")),
            mur=mur_coef,
            probes=probes,
            **on_dev,
        )
    return sim


def set_port_excitation(sim: PreparedSimulation, scales) -> None:
    """Re-excite a prepared simulation without re-voxelizing or
    re-preparing (the JAX package's function of the same name).

    ``scales`` gives every port's new excitation amplitude, lumped ports
    first, then MSL ports (the order of the uf/if_ port rows). Each port's
    ``src_col`` becomes its excite=1 basis ``src_col_unit`` times the
    float32 scale; the stamps are rebuilt with :func:`build_src_mats` and
    copied into the existing ``sim.operands.src`` tensors in place. The
    port loads are untouched (a lumped port's resistance lives in the σ of
    its cells), so a port scaled to 0 stays a matched termination. A
    component that had a stamp keeps it, all zeros when no port on it is
    driven; one that had none keeps ``None``. So the run's mode, launch
    plans and storage forms are the same before and after.

    In place, because launches hold the stamps by address: K1's and K2's
    packed launch arguments (kept on a run's state, ``fdtd_cuda`` and
    ``fdtd_stream``'s ``_StreamBuffers``) point at these tensors, and K1's
    resident form copies them to shared memory at the start of each
    launch, so the next launch of any of them, even on a state that is
    already running, steps with the new drive. A K4 stepper
    (``ops/fdtd_steps.py::build_stepper``) on the simulation's device
    shares the tensors and sees it too. A stepper on a copy does not: an
    explicit run (``parallel.build_explicit_run``) builds each slab's
    stamps from ``src_col`` when it is built, so one built before a
    re-excitation keeps the drive it was built with; build it again after.
    """
    all_ports = list(sim.ports) + list(sim.msl_ports)
    scales = list(np.asarray(scales, np.float64).ravel())
    if len(scales) != len(all_ports):
        raise ValueError(
            f"expected {len(all_ports)} port scales, got {len(scales)}")
    for p, s in zip(all_ports, scales):
        p.src_col = (p.src_col_unit * np.float32(s)).astype(np.float32)
    src = build_src_mats(sim, *sim.padded_shape)
    for m, t in enumerate(sim.operands.src):
        if t is not None:  # the ports, hence the stamped components, are fixed
            t.copy_(torch.from_numpy(src[m]))


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

class ProbeDFT:
    """One chunk's probe samples and the DFT sums they fold into.

    ``bufs[j]`` is the staging row of probe interval j, in the probe
    table's row order (port V, port I, face E, face H); :meth:`flush`
    folds the chunk's samples into ``acc`` as matmuls. Shared by the
    single-device loop and the explicit multi-device run, whose ranks
    keep partial sums. ``batch`` B > 0 puts a leading variant axis on the
    staging rows and the sums (the batched loop, :func:`run_batched`).
    """

    def __init__(self, sim: PreparedSimulation, n_sub: int, dev,
                 batch: int = 0):
        f32 = dict(dtype=torch.float32, device=dev)
        n_ports, T = n_probe_rows(sim), sim.n_face_slots
        n_pf, n_nf = len(sim.port_freqs_hz), len(sim.nf_freqs_hz)
        lead = (batch,) if batch else ()
        self.decim = int(sim.probe_decim)
        self.acc = {
            "uf": torch.zeros((*lead, 2, n_ports, n_pf), **f32),
            "if_": torch.zeros((*lead, 2, n_ports, n_pf), **f32),
            "nf_e": torch.zeros((*lead, 2, n_nf, T), **f32),
            "nf_h": torch.zeros((*lead, 2, n_nf, T), **f32),
        }
        self.w_port = torch.from_numpy(
            (2 * math.pi * sim.port_freqs_hz).astype(np.float32)).to(dev)
        self.w_nf = torch.from_numpy(
            (2 * math.pi * sim.nf_freqs_hz).astype(np.float32)).to(dev)
        self.j_idx = torch.arange(n_sub, **f32)
        # float32 scalars as Python floats: exact, and no host→device copy
        self.dt32 = float(np.float32(sim.dt))
        self.half_dt32 = float(np.float32(0.5 * sim.dt))
        self.bufs = torch.zeros((*lead, n_sub, 2 * n_ports + 2 * T), **f32)
        b = self.bufs
        self._v, self._i = b[..., :n_ports], b[..., n_ports:2 * n_ports]
        self._fe = b[..., 2 * n_ports:2 * n_ports + T]
        self._fh = b[..., 2 * n_ports + T:]

    def flush(self, n0: int, active: Optional[torch.Tensor] = None) -> None:
        """Fold the chunk that started after step ``n0`` into ``acc``.

        Sample j sits after step n0 + (j+1)·D — E at that time, H half a
        step earlier. Angles in float32, as the JAX package forms them;
        layout (re, −im). Batched, ``active`` is a (B,) bool tensor on the
        device: a frozen variant's sums stay exactly as they are.
        """
        t_e = ((self.j_idx + 1.0) * self.decim + float(n0)) * self.dt32
        t_h = t_e - self.half_dt32

        def dft(w, t):
            ang = w[:, None] * t[None, :]
            return torch.cos(ang), torch.sin(ang)

        def fold(key, c, s, b, port):
            d = torch.stack([c @ b, -(s @ b)], dim=-3)
            if port:
                d = d.transpose(-1, -2)
            a = self.acc[key]
            if active is None:
                a += d
            else:
                a.copy_(torch.where(active.view(-1, *[1] * (a.dim() - 1)),
                                    a + d, a))

        ce, se = dft(self.w_port, t_e)
        ch, sh = dft(self.w_port, t_h)
        fold("uf", ce, se, self._v, True)
        fold("if_", ch, sh, self._i, True)
        ce, se = dft(self.w_nf, t_e)
        ch, sh = dft(self.w_nf, t_h)
        fold("nf_e", ce, se, self._fe, False)
        fold("nf_h", ch, sh, self._fh, False)


def chunk_geometry(sim: PreparedSimulation) -> Tuple[int, int, int, int]:
    """``(D, n_sub, chunk, n_chunks_max)``: the probe decimation, probe
    intervals per chunk, steps per chunk and the most chunks a run takes."""
    decim = int(sim.probe_decim)
    n_sub = max(1, int(sim.cfg.check_every) // decim)
    chunk = n_sub * decim
    return decim, n_sub, chunk, int(math.ceil(sim.cfg.n_steps_max / chunk))


def psi_cell_updates_per_step(sim: PreparedSimulation) -> int:
    """The CPML ψ cell-updates of one step of one variant as the run's
    kernels plan them, 0 without CPML. In stream mode K2's march steps
    each of the twelve ψ outside its axis's flat profile run
    (``fdtd_stream.flat_runs``) over the padded cross-section; in chunk
    mode K1 steps all twelve on every padded cell. Reckoned from the
    host's profiles, with no device read."""
    pml = sim._aux[3]
    if pml is None:
        return 0
    shape = sim.padded_shape
    cells = int(np.prod(shape))
    if sim.pallas_mode != "stream":
        return 2 * len(PSI_KEYS) * cells
    runs = fdtd_stream.flat_runs({
        key: tuple(pml[a][where][i] for a in range(3))
        for key, where, i in (("bh", "half", 0), ("ch", "half", 1),
                              ("be", "node", 0), ("ce", "node", 1))})
    n = 0
    for side in runs:
        for ax in fdtd_stream.PSI_AXIS:
            lo, hi = side[ax]
            n += (shape[ax] - (hi - lo)) * (cells // shape[ax])
    return n


def padded_waveform(sim: PreparedSimulation) -> List[float]:
    """The source samples as Python floats, zero-padded to whole chunks
    past any start: a chunk that overruns ``n_steps_max`` injects zeros,
    never replays source samples."""
    _decim, _n_sub, chunk, n_chunks_max = chunk_geometry(sim)
    wf = np.zeros(max(n_chunks_max * chunk, len(sim.waveform)) + chunk,
                  np.float32)
    wf[: len(sim.waveform)] = sim.waveform
    return wf.tolist()


def resume_decim_scale(resume_state, decim: int) -> float:
    """Factor for a checkpoint's DFT sums: they were built at the
    checkpoint's probe decimation, so old/new keeps the dft_dt = dt·decim
    factor a correct integral (1 for an untagged checkpoint)."""
    old = resume_state.get("decim")
    if old is None:
        return 1.0
    return float(np.float32(int(_to_numpy(old))) / np.float32(decim))


def run_simulation(sim: PreparedSimulation, impl, resume_state=None,
                   progress_cb=None, abort_cb=None) -> dict:
    """The chunk loop of :meth:`PreparedSimulation.run`, stepping with
    ``impl`` — :data:`fdtd_stream.kernels` (kernels on CUDA, plain twins
    on CPU) or :data:`fdtd_stream.plain` (plain twins everywhere, to
    compare with the kernels on the card). A chunk-mode run also takes
    :data:`fdtd_cuda.kernels`, :data:`fdtd_cuda.plain` or
    :data:`fdtd_cuda.step_kernels` (the per-step kernels).

    A chunk is ``n_sub`` probe intervals of ``D`` steps, every probe
    sampled into a staging buffer after each interval: one
    ``impl.chunk_steps`` call in chunk mode (the source samples uploaded
    once per run), D / T stream launches of T steps and a
    ``probe_gather`` per interval in stream mode. After each chunk the
    samples fold into the DFT accumulators as matmuls, and the energy
    check decides whether to stop (one host sync per chunk).
    """
    cfg = sim.cfg
    dev = sim.device
    ops = sim.operands
    decim, n_sub, _chunk, _n_chunks = chunk_geometry(sim)
    T_stream = int(sim.stream_T) if sim.pallas_mode == "stream" else 0
    if T_stream and not hasattr(impl, "stream_steps"):
        raise ValueError("a stream-mode run needs an impl with stream_steps "
                         "(fdtd_stream.kernels or fdtd_stream.plain)")
    if not T_stream and not hasattr(impl, "chunk_steps"):
        raise ValueError("a chunk-mode run needs an impl with chunk_steps")
    if T_stream and decim % T_stream:
        raise ValueError(f"probe decimation {decim} is not a multiple of "
                         f"stream_T={T_stream}")
    with span("fdtd.run") as run_span:
        f32 = dict(dtype=torch.float32, device=dev)
        psi_step = psi_cell_updates_per_step(sim)

        st = fdtd_cuda.new_state(sim.padded_shape, dev, ops.pml is not None)
        probes = ProbeDFT(sim, n_sub, dev)
        acc = probes.acc
        n = 0
        e_max = torch.zeros((), **f32)
        ratio = 1.0
        if resume_state is not None:
            scale = resume_decim_scale(resume_state, decim)
            rs = state_from_numpy(sim._adapt_resume_arrays(resume_state), dev)
            for k in acc:
                acc[k].copy_(rs[k] * scale if scale != 1.0 else rs[k])
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

        wf = padded_waveform(sim)
        if not T_stream:  # chunk_steps reads the samples on the device
            wf = torch.tensor(wf, dtype=torch.float32, device=dev)
        bufs = probes.bufs
        end = np.float32(cfg.end_criteria)

        aborted = False
        while n < cfg.n_steps_max:
            n0 = n
            if T_stream:
                for j in range(n_sub):
                    for _ in range(decim // T_stream):
                        impl.stream_steps(ops, st, wf[n:n + T_stream])
                        n += T_stream
                    impl.probe_gather(ops, st, bufs[j])
            else:
                impl.chunk_steps(ops, st, wf, n0, n_sub, decim, bufs)
                n += n_sub * decim
            if psi_step:
                run_span.add("psi_cell_updates", psi_step * (n - n0))
            probes.flush(n0)

            # energy-decay check over the current E
            energy = sum((e * e).sum() for e in st.e[st.parity])
            e_max = torch.maximum(e_max, energy)
            r = torch.where(e_max > 0, energy / e_max, torch.ones((), **f32))
            with span("fdtd.run.sync"):
                ratio = float(r)  # the one host sync of the chunk
            if ratio < end and n > sim.n_source_steps:
                break
            if progress_cb is not None:
                try:
                    progress_cb(n, int(cfg.n_steps_max), ratio)
                except Exception:
                    pass  # a broken UI callback must not kill the run
            if abort_cb is not None and abort_cb():
                aborted = True
                break

        if progress_cb is not None and not aborted:
            try:  # the final 100% tick
                progress_cb(n, n, ratio)
            except Exception:
                pass
        with span("fdtd.run.sync"):  # the output's host reads
            return _assemble_output(sim, st, acc, n, e_max, ratio, decim,
                                    aborted)


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


# ---------------------------------------------------------------------------
# the batched time loop: B design variants of one grid
# ---------------------------------------------------------------------------

def run_batched(sim: PreparedSimulation, coeffs: Dict[str, torch.Tensor],
                impl=None) -> dict:
    """The chunk loop of :func:`run_simulation` for B design variants of
    ``sim``'s grid at once, as the JAX package runs it under ``jax.vmap``
    (``solvers/sweep.py``).

    ``coeffs`` holds the variants' ``ca_ex`` … ``cb_ez`` as (B, X, Y, Z)
    tensors on ``sim.device``; everything else is ``sim``'s and shared,
    the excitation included (every variant is driven by ``sim``'s source
    stamps, as the JAX sweep binds its source operands once). The run
    follows ``sim.pallas_mode``, as the JAX package's vmapped run follows
    its base's: in chunk mode ``impl.chunk_steps_batch`` steps a chunk of
    every active variant (one ``chunk_batch_kernel`` launch on CUDA); in
    stream mode each probe interval is D / T ``impl.stream_steps_batch``
    calls (one launch of the batched march, MUR, PEC or CPML) and one
    ``impl.probe_gather_batch`` (K2's
    ``coef_ops_from`` form under ``jax.vmap``). ``impl`` is
    :data:`fdtd_stream.kernels` (the default: the kernels on CUDA, the
    plain twins on the CPU) or :data:`fdtd_stream.plain`.

    Each variant stops on its own: after every chunk its energy ratio is
    checked as in :func:`run_simulation` (one host sync for all B), and a
    variant that is done is frozen, as a batched ``lax.while_loop`` keeps
    a member whose condition is false: its step count, fields, DFT sums,
    ``e_max`` and ``e_ratio`` stay as they were, and it is neither
    stepped nor sampled again. The loop ends when every variant is done
    or at ``n_steps_max``.

    Returns the outputs of :func:`run_simulation` with a leading variant
    axis: ``uf``/``if_`` (B, ports, Nf) complex, ``nf_e``/``nf_h`` per
    face (B, 2, Nf, 2, nu, nv), ``steps``, ``e_ratio`` and ``e_max`` (B,)
    arrays, ``fields`` six (B, X, Y, Z) tensors (each variant's E from its
    own buffer, H from its own set), and ``state`` the
    :class:`fdtd_cuda.YeeBatch`.
    """
    impl = fdtd_stream.kernels if impl is None else impl
    cfg = sim.cfg
    dev = sim.device
    ops = fdtd_cuda.batch_operands(
        sim.operands, [coeffs["ca_" + c] for c in ("ex", "ey", "ez")],
        [coeffs["cb_" + c] for c in ("ex", "ey", "ez")])
    B = ops.ca[0].shape[0]
    decim, n_sub, chunk, _n_chunks = chunk_geometry(sim)
    T_stream = int(sim.stream_T) if sim.pallas_mode == "stream" else 0
    if T_stream and not hasattr(impl, "stream_steps_batch"):
        raise ValueError("a stream-mode run needs an impl with "
                         "stream_steps_batch (fdtd_stream.kernels or "
                         "fdtd_stream.plain)")
    if T_stream and decim % T_stream:
        raise ValueError(f"probe decimation {decim} is not a multiple of "
                         f"stream_T={T_stream}")
    with span("fdtd.run") as run_span:
        f32 = dict(dtype=torch.float32, device=dev)

        st = fdtd_cuda.new_batch_state(sim.padded_shape, dev, ops.pml is not None, B)
        psi_step = psi_cell_updates_per_step(sim)
        probes = ProbeDFT(sim, n_sub, dev, batch=B)
        wf = padded_waveform(sim)
        if not T_stream:  # chunk_steps_batch reads the samples on the device
            wf = torch.tensor(wf, **f32)
        e_max = torch.zeros(B, **f32)
        ratio = torch.ones(B, **f32)
        active = [True] * B
        on = torch.ones(B, dtype=torch.bool, device=dev)
        steps = [0] * B
        end = np.float32(cfg.end_criteria)
        n = 0
        while n < cfg.n_steps_max and any(active):
            n0 = n
            live = sum(active)
            run_span.add("live_variant_chunks", live)
            run_span.add("frozen_variant_chunks", B - live)
            if T_stream:
                for j in range(n_sub):
                    for _ in range(decim // T_stream):
                        impl.stream_steps_batch(ops, st, wf[n:n + T_stream],
                                                active)
                        n += T_stream
                    impl.probe_gather_batch(ops, st, probes.bufs[:, j], active)
            else:
                impl.chunk_steps_batch(ops, st, wf, n0, n_sub, decim, probes.bufs,
                                       active)
                n += chunk
            if psi_step:
                run_span.add("psi_cell_updates", psi_step * live * (n - n0))
            probes.flush(n0, on)
            # energy-decay check over each variant's current E: every active
            # variant is at the same parity
            p = st.parity[active.index(True)]
            energy = sum((e * e).sum(dim=(1, 2, 3)) for e in st.e[p])
            peak = torch.maximum(e_max, energy)
            r = torch.where(peak > 0, energy / peak, torch.ones((), **f32))
            e_max = torch.where(on, peak, e_max)
            ratio = torch.where(on, r, ratio)
            with span("fdtd.run.sync"):
                ratios = ratio.tolist()  # the one host sync of the chunk
            done = [b for b in range(B) if active[b] and ratios[b] < end
                    and n > sim.n_source_steps]
            for b in done:
                active[b] = False
                steps[b] = n
            if done:
                on = torch.tensor(active, dtype=torch.bool, device=dev)
        for b in range(B):
            if active[b]:
                steps[b] = n
        with span("fdtd.run.sync"):  # the output's host reads
            return _assemble_batch(sim, st, probes.acc, steps, e_max, ratio)


def _assemble_batch(sim, st, acc, steps, e_max, ratio) -> dict:
    """:func:`run_batched`'s output dict (see there)."""
    n_nf = len(sim.nf_freqs_hz)

    def split_faces(a):
        a = _to_numpy(a)
        return [
            a[..., off : off + 2 * nu * nv].reshape(
                a.shape[0], 2, n_nf, 2, nu, nv)
            for (off, nu, nv) in sim.face_layout
        ]

    return dict(
        uf=nf_to_complex(acc["uf"], axis=1),
        if_=nf_to_complex(acc["if_"], axis=1),
        nf_e=split_faces(acc["nf_e"]),
        nf_h=split_faces(acc["nf_h"]),
        steps=np.asarray(steps, np.int64),
        e_ratio=_to_numpy(ratio),
        e_max=_to_numpy(e_max),
        fields=st.fields(),
        state=st,
    )


# ---------------------------------------------------------------------------
# the exposed step: one leapfrog iteration under torch.autograd
# ---------------------------------------------------------------------------

# The six curl terms in PSI_KEYS order (ψ_xy rides ∂/∂y of the z
# component, …) as (derivative axis, component), and each component's curl
# as the difference of two of them: x = xy − xz, y = yz − yx, z = zx − zy.
_CURL_TERMS = ((1, 2), (2, 1), (2, 0), (0, 2), (0, 1), (1, 0))
_CURL_PAIRS = ((0, 2, 4), (1, 3, 5))
# the two field components tangential to the x, y and z walls
_MUR_TANGENTIAL = (slice(1, 3), slice(0, 3, 2), slice(0, 2))


def _axis_terms(F: torch.Tensor, inv: torch.Tensor, forward: bool) -> torch.Tensor:
    """The (9, X, Y, Z) derivatives of a (3, X, Y, Z) field stack along
    each axis a (rows 3a..3a+2), times ``inv`` (its inverse spacings as a
    (9, X, Y, Z) stack): ``F[i+1] − F[i]`` (``forward``) or
    ``F[i] − F[i−1]``, as the twins' ``_fdiff``/``_bdiff`` and the JAX
    package's, whose neighbour past the edge reads 0. Here it is the
    wrapped-around neighbour, and in every term a step uses that is 0 too:
    forward, ``inv`` (a primary spacing) is 0 on the last plane; in a
    backward term the last plane of H_c along an axis a ≠ c lies past the
    grid's cells, where H stays 0 from a zero start (its ca/cb, and so its
    E neighbours, are 0 there)."""
    if forward:
        d = [F.roll(-1, a + 1) - F for a in range(3)]
    else:
        d = [F - F.roll(1, a + 1) for a in range(3)]
    return torch.cat(d) * inv


class ExposedStep:
    """One leapfrog iteration as a pure function of tensors.

    Counterpart of the JAX package's exposed XLA step
    (``_make_run_fn(..., _expose_step=True)`` and :func:`make_single_step`):
    :meth:`field_step` ``(carry, n, coeffs, waveform) -> (carry, probes)``
    and :meth:`init_carry` ``(coeffs, n_nf, n_pf)``, with the update order
    of every run: H (and ψ_h under CPML), the lumped ports' I sampled from
    the new H, E with ``coeffs``' ca/cb and the port-source FMA
    ``src·waveform[n]`` (and ψ_e), the MUR walls x → y → z, then V sampled
    from the new E. ``probes`` holds ``v`` and ``i`` (one entry per lumped
    port) and ``faces_e``/``faces_h``, a (2, nu, nv) tangential (u, v)
    sample per Huygens face. MUR, PEC and ``PML_N`` are supported.

    Its inputs are never written (the MUR walls go into a fresh copy of
    the new E), so ``torch.autograd`` differentiates through it: the
    adjoint inverse design (``solvers/inverse.py``) runs it for a fixed
    step count. A carry is one that steps produce from :meth:`init_carry`'s
    zeros, whose H stays 0 past the grid's cells (:func:`_axis_terms`
    reads it there). It runs on the simulation's device with
    PyTorch's own operations; it is neither a kernel nor a kernel's plain
    twin. The twins (``ops/fdtd_cuda.py``) update the fields in place,
    which autograd refuses, and stay as the kernels' reference. In the
    JAX package too the differentiated loop runs XLA ops, no Pallas
    kernel. Each cell's arithmetic is the JAX step's; the three components
    of a field move as one (3, X, Y, Z) stack and the six ψ as one (6, X,
    Y, Z) stack, so a step is a few dozen operations (its cost on the card
    is their launches). The source stamps are ``sim.operands.src`` (the
    current excitation); the probes are rows of :func:`build_probe_gathers`.
    """

    def __init__(self, sim: PreparedSimulation):
        self.sim = sim
        ops = self.ops = sim.operands
        dev = sim.device
        # probe rows over the flat (Ex Ey Ez Hx Hy Hz) stack, each padded
        # with weight-0 terms to its table's widest: the lumped ports' V
        # then I rows, and those followed by the faces' E then H rows
        pv, pi, fe, fh = probe_blocks(build_probe_gathers(sim),
                                      int(np.prod(sim.padded_shape)))
        n = len(sim.ports)
        ports = [(pv[0][:n], pv[1][:n]), (pi[0][:n], pi[1][:n])]

        def table(blocks):
            k = max(i.shape[1] for i, _w in blocks)
            pad = [((0, 0), (0, k - i.shape[1])) for i, _w in blocks]
            idx = np.concatenate([np.pad(i, p) for (i, _w), p in zip(blocks, pad)])
            w = np.concatenate([np.pad(w, p) for (_i, w), p in zip(blocks, pad)])
            return (torch.from_numpy(idx).to(dev), torch.from_numpy(w).to(dev))

        self.port_rows = table(ports)
        self.all_rows = table(ports + [fe, fh])
        # the inverse spacings, primary and dual, as (9, X, Y, Z) stacks:
        # axis a's profile in rows 3a..3a+2
        def nine(prof):
            return torch.cat([
                fdtd_cuda._bvec(prof[a], a).expand(3, *sim.padded_shape)
                for a in range(3)]).contiguous()

        self.inv_p, self.inv_d = nine(ops.inv_p), nine(ops.inv_d)
        self.psi_bc = None
        if ops.pml is not None:
            def six(prof):
                return torch.stack([
                    fdtd_cuda._bvec(prof[a], a).expand(sim.padded_shape)
                    for a, _m in _CURL_TERMS])

            self.psi_bc = {k: six(v) for k, v in ops.pml.items()}
        terms = [3 * a + m for a, m in _CURL_TERMS]
        self.terms = torch.tensor(terms, device=dev)
        self.pairs = [torch.tensor(p, device=dev) for p in _CURL_PAIRS]
        # without ψ the curl's terms straight from the nine derivatives
        self.pairs9 = [torch.tensor([terms[i] for i in p], device=dev)
                       for p in _CURL_PAIRS]
        # per axis: its two walls and their inner neighbours along the
        # axis (strided views) and the two coefficients broadcast along it
        self.mur = None
        if ops.mur is not None:
            self.mur = []
            for ax in range(3):
                q = ops.grid_shape[ax]
                walls, nbs = [slice(None)] * 4, [slice(None)] * 4
                walls[ax + 1] = slice(0, q, q - 1)
                nbs[ax + 1] = slice(1, q - 1, max(q - 3, 1))
                shape = [1, 1, 1, 1]
                shape[ax + 1] = 2
                self.mur.append((tuple(walls), tuple(nbs), torch.tensor(
                    ops.mur[ax], dtype=torch.float32, device=dev).view(shape)))

    # -- the carry ------------------------------------------------------------

    def init_carry(self, coeffs, n_nf: int, n_pf: int) -> dict:
        """Zero fields (and ψ under CPML) with the JAX carry's keys; the
        DFT sums and the stop state are not touched by :meth:`field_step`
        (a caller keeps its own, as the JAX package's does)."""
        del coeffs  # the JAX signature; the carry does not depend on it
        sim = self.sim
        f32 = dict(dtype=torch.float32, device=sim.device)

        def zeros():
            return torch.zeros(sim.padded_shape, **f32)

        pml = self.psi_bc is not None
        n_ports, T = n_probe_rows(sim), sim.n_face_slots
        return dict(
            fields=tuple(zeros() for _ in range(6)),
            uf=torch.zeros((2, n_ports, n_pf), **f32),
            if_=torch.zeros((2, n_ports, n_pf), **f32),
            nf_e=torch.zeros((2, n_nf, T), **f32),
            nf_h=torch.zeros((2, n_nf, T), **f32),
            psi_e={k: zeros() for k in PSI_KEYS} if pml else {},
            psi_h={k: zeros() for k in PSI_KEYS} if pml else {},
            n=0,
            e_max=0.0,
            e_ratio=1.0,
            done=False,
        )

    def operands(self, coeffs):
        """``(ca, cb, src)`` as (3, X, Y, Z) stacks: ``coeffs``' ca_ex …
        cb_ez and the current source stamps (zeros where none)."""
        ca = torch.stack([coeffs["ca_" + c] for c in ("ex", "ey", "ez")])
        cb = torch.stack([coeffs["cb_" + c] for c in ("ex", "ey", "ez")])
        src = torch.stack([torch.zeros_like(ca[0]) if s is None else s
                           for s in self.ops.src])
        return ca, cb, src

    # -- the updates ------------------------------------------------------------

    def _curl(self, F, psi, bc, inv, forward):
        """The curl of one half-step from the (3, X, Y, Z) stack ``F``:
        the six terms of :data:`_CURL_TERMS`, with their ψ recursion under
        CPML (``bc`` the (b, c) stacks), paired into the three components'
        curls."""
        d9 = _axis_terms(F, inv, forward)
        if psi is None:
            plus, minus = self.pairs9
            return d9.index_select(0, plus) - d9.index_select(0, minus), None
        d6 = d9.index_select(0, self.terms)
        psi = bc[0] * psi + bc[1] * d6
        d6 = d6 + psi
        plus, minus = self.pairs
        return d6.index_select(0, plus) - d6.index_select(0, minus), psi

    def step(self, E, H, psi_e, psi_h, ca, cb, src, s):
        """One step on the stacks: ``(E, H, ψ_e, ψ_h)`` after it, the ψ as
        (6, X, Y, Z) in :data:`PSI_KEYS` order (None without CPML); ``s``
        the source sample."""
        bc = self.psi_bc
        curl, psi_h = self._curl(E, psi_h, bc and (bc["bh"], bc["ch"]),
                                 self.inv_p, True)
        H = H - self.ops.dtmu * curl
        curl, psi_e = self._curl(H, psi_e, bc and (bc["be"], bc["ce"]),
                                 self.inv_d, False)
        En = ca * E + cb * curl + src * s
        if self.mur is not None:
            # the walls of axis ax set the two components tangential to
            # it (a strided view of the stack), axis by axis as in the JAX
            # step, into a copy of the new E that only this step sees
            En = En.clone()
            for tang, (walls, nbs, c) in zip(_MUR_TANGENTIAL, self.mur):
                Eo, Et = E[tang], En[tang]
                Et[walls] = Eo[nbs] + c * (Et[nbs] - Eo[walls])
        return En, H, psi_e, psi_h

    def advance(self, carry: dict, n: int, coeffs, waveform) -> dict:
        """The carry after step ``n`` (source sample ``waveform[n]``)."""
        f = carry["fields"]
        pml = self.psi_bc is not None

        def six(d):
            return torch.stack([d[k] for k in PSI_KEYS]) if pml else None

        E, H, psi_e, psi_h = self.step(
            torch.stack(f[:3]), torch.stack(f[3:]), six(carry["psi_e"]),
            six(carry["psi_h"]), *self.operands(coeffs), waveform[n])
        return dict(
            carry, fields=(*E.unbind(0), *H.unbind(0)),
            psi_e=dict(zip(PSI_KEYS, psi_e.unbind(0))) if pml else {},
            psi_h=dict(zip(PSI_KEYS, psi_h.unbind(0))) if pml else {})

    # -- the probes -------------------------------------------------------------

    @staticmethod
    def sample(E, H, rows) -> torch.Tensor:
        """The probe rows ``rows`` (:attr:`port_rows`: the lumped ports' V
        then I; :attr:`all_rows`: those, then every face's tangential E
        then H, flat in ``sim.face_layout``'s order) of a step's (3, X, Y,
        Z) E and H, as one vector."""
        idx, w = rows
        flat = torch.cat([E.reshape(-1), H.reshape(-1)])
        return (flat[idx] * w).sum(-1)

    def field_step(self, carry: dict, n: int, coeffs, waveform):
        """One leapfrog iteration: ``(carry, probes)`` (see the class)."""
        carry = self.advance(carry, n, coeffs, waveform)
        f = carry["fields"]
        out = self.sample(torch.stack(f[:3]), torch.stack(f[3:]), self.all_rows)
        n_p, T = len(self.sim.ports), self.sim.n_face_slots
        fe, fh = out[2 * n_p:2 * n_p + T], out[2 * n_p + T:]
        lay = self.sim.face_layout
        probes = dict(
            v=out[:n_p], i=out[n_p:2 * n_p],
            faces_e=[fe[o:o + 2 * nu * nv].view(2, nu, nv) for o, nu, nv in lay],
            faces_h=[fh[o:o + 2 * nu * nv].view(2, nu, nv) for o, nu, nv in lay],
        )
        return carry, probes


def make_single_step(sim: PreparedSimulation):
    """One leapfrog step and its example arguments, as the JAX package's
    function of the same name: ``(step_fn, (carry, 0, sim.coeffs,
    waveform))`` with ``step_fn(carry, n, coeffs, waveform) -> (carry,
    probes)`` the :class:`ExposedStep` of ``sim``."""
    step = ExposedStep(sim)
    carry = step.init_carry(sim.coeffs, len(sim.nf_freqs_hz),
                            len(sim.port_freqs_hz))
    wf = torch.from_numpy(np.asarray(sim.waveform, np.float32)).to(sim.device)
    return step.field_step, (carry, 0, sim.coeffs, wf)
