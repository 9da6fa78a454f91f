#!/usr/bin/env python
"""Benchmark: path-tracing throughput on one GPU.

    python bench.py

Sections, each printed as it finishes (one JSON object per line):

  * dragon_fwd      — the 200k-triangle dragon stand-in with the HDR sky
                      (BASELINE.json's flagship), 512x512, 1 spp/iter,
                      8 bounces, forward
  * dragon_fwd_bwd  — the same frame, value and gradient of the image mean
                      w.r.t. the diffuse albedo
  * dragon870k_fwd  — the reference's pbrt_dragon scale (870k triangles)
  * cornell_fwd     — the reference renderer's own default workload
                      (main.cpp:34-39: Cornell box, 512x512, 64 spp,
                      8 bounces) on data/cornell_box.obj

Rays counted = camera rays + continuation rays (W*H*spp*bounces); the two
NEE shadow queries per bounce are not counted.  Times are the median of
five runs on the host clock around block_until_ready, after a compile and
warm-up run whose time is reported as compile_s.  Every line names the
device and the card (name, power limit).  Without a GPU the script fails;
it exits non-zero if any section fails.  The last line is a summary.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def _measure(fn, args, runs: int = 5):
    """(compile+first-run seconds, median ms, min ms, max ms, output)."""
    import jax
    import numpy as np

    t0 = time.time()
    out = jax.block_until_ready(fn(*args))
    first = time.time() - t0
    ms = []
    for _ in range(runs):
        t0 = time.time()
        jax.block_until_ready(fn(*args))
        ms.append((time.time() - t0) * 1e3)
    return first, float(np.median(ms)), min(ms), max(ms), out


def main() -> int:
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py needs a GPU; JAX found {dev.platform}",
              file=sys.stderr)
        return 2
    subprocess.run(["make", "-C", os.path.join(REPO, "sycl_ray_tracing",
                                               "native")],
                   check=True, capture_output=True)

    import numpy as np

    from sycl_ray_tracing.models import pathtracer
    from sycl_ray_tracing.models.camera import (
        cornell_box_camera,
        pbrt_dragon_camera,
    )
    from sycl_ray_tracing.utils.compile_cache import enable_compile_cache
    from sycl_ray_tracing.utils.config import RenderConfig
    from sycl_ray_tracing.utils.obj_loader import load_scene
    from sycl_ray_tracing.utils.procedural import dragon_scene

    enable_compile_cache()
    where = {"platform": dev.platform, "kind": dev.device_kind,
             "count": len(jax.devices()), "card": _card()}
    results, failed = {}, []

    def section(name, rays, fn, args, check):
        try:
            first, med, lo, hi, out = _measure(fn, args)
            check(out)
            r = {"section": name, "compile_s": round(first, 3),
                 "ms": round(med, 3), "ms_min": round(lo, 3),
                 "ms_max": round(hi, 3),
                 "Mrays_per_s": round(rays / med / 1e3, 3),
                 "peak_bytes_in_use":
                     dev.memory_stats()["peak_bytes_in_use"], **where}
            results[name] = r
            print(json.dumps(r), flush=True)
        except Exception as e:  # a failed section fails the run, at exit
            failed.append(name)
            print(json.dumps({"section": name, "error": repr(e)[:500],
                              **where}), flush=True)

    def frame_ok(out):
        img, aux = out
        img = np.asarray(img)
        if not (np.isfinite(img).all() and img.mean() > 0.0):
            raise RuntimeError("bad frame")
        if bool(aux["overflow"]):
            raise RuntimeError("uncertified traversal")

    w = 512
    cfg = RenderConfig(width=w, height=w, samples=1, bounces=8)
    dcam = pbrt_dragon_camera()
    render = jax.jit(lambda s, k: pathtracer.render(s, dcam, cfg, k,
                                                    with_aux=True))
    key = jax.random.PRNGKey(0)
    rays = w * w * cfg.samples * cfg.bounces

    dragon = dragon_scene(n_tris=200_000, with_sky=True)
    section("dragon_fwd", rays, render, (dragon, key), frame_ok)

    mats = dragon.materials

    def loss(diffuse, k):
        s = dragon.with_materials(dataclasses.replace(mats, diffuse=diffuse))
        return pathtracer.render(s, dcam, cfg, k).mean()

    def grad_ok(out):
        g = np.asarray(out[1])
        if not (np.isfinite(g).all() and np.abs(g).sum() > 0.0):
            raise RuntimeError("bad gradient")

    section("dragon_fwd_bwd", rays, jax.jit(jax.value_and_grad(loss)),
            (mats.diffuse, key), grad_ok)
    del dragon
    big = dragon_scene(n_tris=870_000, with_sky=True)
    section("dragon870k_fwd", rays, render, (big, key), frame_ok)
    del big

    ccfg = RenderConfig(width=w, height=w, samples=64, bounces=8)
    cornell = load_scene(os.path.join(REPO, "data", "cornell_box.obj"))
    ccam = cornell_box_camera()
    crender = jax.jit(lambda s, k: pathtracer.render(s, ccam, ccfg, k))

    def cornell_ok(img):
        img = np.asarray(img)
        if not (np.isfinite(img).all() and img.mean() > 0.0):
            raise RuntimeError("bad frame")

    section("cornell_fwd", w * w * 64 * 8, crender, (cornell, key),
            cornell_ok)

    print(json.dumps({"sections": sorted(results), "failed": failed,
                      **where}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
