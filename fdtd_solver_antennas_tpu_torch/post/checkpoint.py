"""Checkpoint / resume for long FDTD runs.

Counterpart of ``fdtd_solver_antennas_tpu/post/checkpoint.py``, with the
same ``.npz`` keys: ``field_0`` … ``field_5``, ``psi_e_<k>`` and
``psi_h_<k>`` (CPML only), ``uf``, ``if_``, ``nf_e``, ``nf_h``, ``n``,
``e_max``, ``e_ratio`` and ``decim``. A run's loop state (fields, CPML ψ,
port and NF2FF DFT sums, step count, energy tracker) goes to one file,
so a run can continue in a later process, in either package, through
``sim.run(resume_state=load_state(path))``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict

import numpy as np

from ..ops.fdtd import state_to_numpy


def _npz_path(path) -> Path:
    """np.savez_compressed appends '.npz' to a path without a suffix;
    normalize here so save and load take the same string."""
    path = Path(path)
    return path if path.suffix == ".npz" else path.with_suffix(
        path.suffix + ".npz")


def save_state(path, out_or_state: Dict) -> None:
    """Write a run's resumable state to ``path`` (.npz).

    Takes a ``sim.run()`` output dict (its ``state`` entry is used) or
    the state itself, its arrays tensors on any device or numpy arrays
    (:func:`ops.fdtd.state_to_numpy` brings them to the host).
    """
    state = state_to_numpy(out_or_state.get("state", out_or_state))
    flat: Dict[str, np.ndarray] = {}
    for i, f in enumerate(state["fields"]):
        flat[f"field_{i}"] = f
    for grp in ("psi_e", "psi_h"):
        for k, v in state[grp].items():
            flat[f"{grp}_{k}"] = v
    for k in ("uf", "if_", "nf_e", "nf_h", "n", "e_max", "e_ratio"):
        flat[k] = np.asarray(state[k])
    if "decim" in state:  # cadence tag for a resume at another decimation
        flat["decim"] = np.asarray(state["decim"])
    np.savez_compressed(_npz_path(path), **flat)


def load_state(path) -> Dict:
    """Load a state written by :func:`save_state` (or by the JAX
    package's) as numpy arrays in the layout ``sim.run(resume_state=...)``
    takes; the run moves them to its device
    (:func:`ops.fdtd.state_from_numpy`)."""
    with np.load(_npz_path(path)) as z:
        data = {k: z[k] for k in z.files}
    n_fields = sum(1 for k in data if k.startswith("field_"))
    fields = tuple(data[f"field_{i}"] for i in range(n_fields))
    psi_e = {
        k.split("_", 2)[2]: v for k, v in data.items() if k.startswith("psi_e_")
    }
    psi_h = {
        k.split("_", 2)[2]: v for k, v in data.items() if k.startswith("psi_h_")
    }
    return dict(
        fields=fields,
        psi_e=psi_e,
        psi_h=psi_h,
        uf=data["uf"],
        if_=data["if_"],
        nf_e=data["nf_e"],
        nf_h=data["nf_h"],
        n=np.int32(data["n"]),
        e_max=np.float32(data["e_max"]),
        e_ratio=np.float32(data["e_ratio"]),
        **({"decim": np.int32(data["decim"])} if "decim" in data else {}),
    )
