#!/usr/bin/env python
"""BASELINE config 3: dragon (stand-in), Cook-Torrance roughness/metallic
with BRDF importance sampling + MIS, 720p @ 128spp."""

import os
import sys

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(_HERE), _HERE]

import numpy as np
from _common import report, setup_jax, small, timed_render

jax = setup_jax()

from sycl_ray_tracing.models import pathtracer
from sycl_ray_tracing.models.camera import pbrt_dragon_camera
from sycl_ray_tracing.ops.tonemap import tonemap
from sycl_ray_tracing.utils.config import RenderConfig
from sycl_ray_tracing.utils.procedural import dragon_scene
from sycl_ray_tracing.utils.png import write_png


def main():
    if small():
        w, h, spp, tris = 128, 72, 2, 20_000
    else:
        w, h, spp, tris = 1280, 720, 128, 200_000
    cfg = RenderConfig(width=w, height=h, samples=spp, bounces=4,
                       tile_rays=32768)
    scene = dragon_scene(n_tris=tris, with_sky=False)
    cam = pbrt_dragon_camera()
    f = jax.jit(lambda s, c, k: pathtracer.render(s, c, cfg, k))
    img, dt = timed_render(f, scene, cam, jax.random.PRNGKey(0), n=1)
    assert np.isfinite(img).all()
    write_png("example3.png", np.asarray(tonemap(img)))
    report("config3_dragon_mis", dt, w * h * spp * cfg.bounces,
           {"triangles": tris})


if __name__ == "__main__":
    main()
