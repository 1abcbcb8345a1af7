"""Multi-device runs (counterpart of ``fdtd_solver_antennas_tpu/parallel``)."""

from .explicit import build_explicit_run, build_walk_run
from .sharding import (
    make_device_mesh,
    shard_fields,
    shard_simulation,
    sharded_step_fn,
)
from .sweep_shard import (
    make_sweep_mesh,
    pad_batch,
    shard_sweep,
    trim_sweep_out,
)

__all__ = [
    "build_explicit_run",
    "make_device_mesh",
    "shard_fields",
    "shard_simulation",
    "sharded_step_fn",
    "make_sweep_mesh",
    "pad_batch",
    "shard_sweep",
    "trim_sweep_out",
]
