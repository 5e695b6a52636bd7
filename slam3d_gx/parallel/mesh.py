"""Device mesh construction and distributed bring-up.

The reference has no distributed communication backend at all
(single process, reference src/run_SLAM.cpp:30-33 is a sequential
frame loop; SURVEY.md §2.4). Here the comm backend is XLA collectives
(NCCL between GPUs); this module only standardizes how the framework
names and builds its meshes.

Axis conventions:
- "dp": data parallel — independent frame pairs / loop-closure
  candidates / pose-graph edges shard here;
- "sp": sequence parallel — the keyframe-database axis (lcdb.py)
  shards here when the history outgrows one chip.

A mesh of size 1 must work with no code fork (SURVEY.md §5.8) — all
shard_map code in this package is written against named axes and
degrades to single-device when an axis has size 1.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec

P = PartitionSpec

DP_AXIS = "dp"
SP_AXIS = "sp"


def distributed_init(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> None:
    """Bring up multi-host JAX. No-op when single-process (the common
    single-chip path must not fork, SURVEY.md §5.8)."""
    if num_processes is None or num_processes <= 1:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )


def _factor_2d(n: int) -> Tuple[int, int]:
    """Factor n into (dp, sp) as square as possible, dp >= sp."""
    best = (n, 1)
    for sp in range(1, int(math.isqrt(n)) + 1):
        if n % sp == 0:
            best = (n // sp, sp)
    return best


def make_mesh(
    n_devices: Optional[int] = None,
    axis_names: Sequence[str] = (DP_AXIS, SP_AXIS),
    shape: Optional[Sequence[int]] = None,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Build a named mesh over the first n_devices.

    Default layout is 2D (dp, sp) with dp taking the larger factor —
    registration fan-out dominates. The factoring assumes no link
    topology: GPUs of one host reach each other all to all (NVLink), so
    any device order serves either axis.
    """
    devs = list(devices if devices is not None else jax.devices())
    if n_devices is not None:
        devs = devs[:n_devices]
    n = len(devs)
    if shape is None:
        if len(axis_names) == 1:
            shape = (n,)
        elif len(axis_names) == 2:
            shape = _factor_2d(n)
        else:
            raise ValueError("provide shape for >2 axes")
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {shape} != {n} devices")
    return Mesh(np.asarray(devs).reshape(shape), axis_names=tuple(axis_names))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def dp_sharding(mesh: Mesh) -> NamedSharding:
    """Leading axis sharded over dp, rest replicated."""
    return NamedSharding(mesh, P(DP_AXIS))


def sp_sharding(mesh: Mesh) -> NamedSharding:
    """Leading axis sharded over sp (keyframe database axis)."""
    return NamedSharding(mesh, P(SP_AXIS))


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m
