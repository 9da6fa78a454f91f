"""Shared helpers for the benchmark-config examples."""

from __future__ import annotations

import json
import sys
import time

import numpy as np


def setup_jax():
    import jax

    from sycl_ray_tracing.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    return jax


def small() -> bool:
    return "--small" in sys.argv


def timed_render(render_fn, *args, n: int = 2):
    """Compile + warm up, then the best of ``n`` timed runs (host clock
    around block_until_ready)."""
    render_fn(*args).block_until_ready()  # compile + warmup
    times = []
    for _ in range(n):
        t0 = time.time()
        img = render_fn(*args).block_until_ready()
        times.append(time.time() - t0)
    return np.asarray(img), min(times)


def report(name: str, seconds: float, rays: int, extra=None):
    out = {
        "example": name,
        "seconds": round(seconds, 3),
        "Mrays_per_s": round(rays / seconds / 1e6, 2),
    }
    if extra:
        out.update(extra)
    print(json.dumps(out))
