"""Multi-host runtime: jax.distributed bring-up + host-sharded rendering.

SURVEY.md §5's distributed-backend plan: `jax.distributed.initialize` for
N>=2 hosts, scene+BVH replicated in each card's memory, rays sharded over
the global ("data","sample") mesh, gradients all-reduced across cards.  This module provides the bring-up and the global-mesh
constructor; parallel/render.py's shard_map functions work unchanged on a
multi-host mesh (jax inserts cross-host collectives).

Single-host environments (this image) exercise the same code path with
``initialize_single_host`` — the functions never require real multi-host.
"""

from __future__ import annotations

import os
from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Bring up the multi-host JAX runtime.

    With no arguments, reads the env vars JAX_COORDINATOR_ADDRESS /
    JAX_NUM_PROCESSES / JAX_PROCESS_ID.  A no-op when only one process
    exists.
    """
    num = num_processes or int(os.environ.get("JAX_NUM_PROCESSES", "1"))
    if num <= 1:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address
        or os.environ.get("JAX_COORDINATOR_ADDRESS"),
        num_processes=num,
        process_id=process_id
        if process_id is not None
        else int(os.environ.get("JAX_PROCESS_ID", "0")),
    )


def global_mesh(sample_axis: int = 1) -> Mesh:
    """("data","sample") mesh over ALL devices of ALL processes.

    Device order follows jax.devices() (grouped by host), so the "data"
    axis splits across hosts only at host boundaries — the all-reduce
    crosses the network between hosts once, and stays on each host's
    NVLink otherwise.
    """
    devices = np.asarray(jax.devices())
    n = devices.size
    if n % sample_axis != 0:
        raise ValueError(f"{n} devices not divisible by {sample_axis}")
    return Mesh(devices.reshape(n // sample_axis, sample_axis),
                ("data", "sample"))


def is_coordinator() -> bool:
    return jax.process_index() == 0


def process_info() -> dict:
    return {
        "process_index": jax.process_index(),
        "process_count": jax.process_count(),
        "local_devices": len(jax.local_devices()),
        "global_devices": len(jax.devices()),
    }
