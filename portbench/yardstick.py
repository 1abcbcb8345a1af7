"""The yardstick of the Yee work: operations, bytes and the least time an
H100 needs for them, counted from the scene and the steps, whatever
kernels do the work.

- Operations: 48 a cell-update (the H and E curls, the ca/cb update and
  the source FMA of one Yee cell and step, in float32) and 4 a ψ
  cell-update where the CPML profile of that ψ's axis is not flat.
- Bytes: each job's state read once and written once: the six fields, ca
  and cb and the source stamps read, the six fields written, and under
  CPML the twelve ψ read and written, 4 bytes each, per variant.
- Peaks: one NVIDIA H100 SXM at its 700 W limit, from NVIDIA's data
  sheet: 67 TFLOP/s float32 outside the tensor cores, 3.35 TB/s of HBM3.
"""

from __future__ import annotations

from typing import Tuple

OPS_PER_CELL_UPDATE = 48
OPS_PER_PSI_UPDATE = 4
PEAK_FLOPS_F32 = 67e12
PEAK_BYTES_PER_S = 3.35e12
BYTES_PER_VALUE = 4


def job_ops(cell_updates: int, psi_updates: int) -> float:
    return (OPS_PER_CELL_UPDATE * float(cell_updates)
            + OPS_PER_PSI_UPDATE * float(psi_updates))


def job_bytes(cells: int, variants: int, n_stamps: int, cpml: bool) -> float:
    per_cell = 6 + 6 + n_stamps + 6 + (24 if cpml else 0)
    return float(BYTES_PER_VALUE * per_cell * cells * variants)


def least_time(ops: float, nbytes: float) -> Tuple[float, str]:
    """``(seconds, bound)``: the larger of the two floors and which it is."""
    t_ops, t_bytes = ops / PEAK_FLOPS_F32, nbytes / PEAK_BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def psi_cell_updates(shape, npml: int, steps: int) -> int:
    """ψ cell-updates of ``steps`` steps of a (Qx, Qy, Qz)-line grid under
    an ``npml``-cell CPML: each of the twelve ψ (two an axis for E, two for
    H) is stepped where its axis's profile is not flat, the npml cells at
    each end of that axis, over the whole cross-section."""
    if npml <= 0:
        return 0
    cells = 1
    for q in shape:
        cells *= q - 1
    per_step = 0
    for q in shape:
        per_step += 4 * (2 * npml) * cells // (q - 1)
    return per_step * steps
