"""Device mesh helpers.

The reference's only parallelism is an OpenMP ``parallel for`` over image
rows with a shared read-only scene (render_kernel.cpp:198-203).  Here
(SURVEY.md §2 parallelism table): a 2D jax.sharding Mesh

    ("data", "sample")

where pixels/rays shard over "data", spp shards over "sample", the scene and
BVH are replicated in each card's memory, and scene-parameter gradients are
mean-reduced over both axes.  The cards of a host reach each other at the
same rate (NVLink, all to all), so the mesh takes jax.devices() in order.
"""

from __future__ import annotations

import math

import jax
import numpy as np
from jax.sharding import Mesh


def make_mesh(n_devices: int | None = None, sample_axis: int = 1,
              devices=None) -> Mesh:
    """Build a ("data", "sample") mesh over the available devices."""
    if devices is None:
        devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    devices = devices[:n_devices]
    if n_devices % sample_axis != 0:
        raise ValueError(
            f"{n_devices} devices not divisible by sample_axis={sample_axis}"
        )
    arr = np.asarray(devices).reshape(n_devices // sample_axis, sample_axis)
    return Mesh(arr, ("data", "sample"))


def best_sample_axis(n_devices: int, samples: int) -> int:
    """Largest power-of-two sample-axis size that divides both."""
    s = 1
    while (
        s * 2 <= n_devices
        and n_devices % (s * 2) == 0
        and samples % (s * 2) == 0
    ):
        s *= 2
    return s


def pad_to_multiple(n: int, m: int) -> int:
    return int(math.ceil(n / m) * m)
