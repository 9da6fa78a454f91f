#!/usr/bin/env python
"""BASELINE config 2: low-poly OBJ mesh + accelerated traversal,
direct + 4-bounce indirect, 512x512 @ 64spp."""

import os
import sys

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(_HERE), _HERE]

import numpy as np
from _common import report, setup_jax, small, timed_render

jax = setup_jax()

from sycl_ray_tracing.models import pathtracer
from sycl_ray_tracing.models.camera import cornell_box_camera
from sycl_ray_tracing.ops.tonemap import tonemap
from sycl_ray_tracing.utils.config import RenderConfig
from sycl_ray_tracing.utils.obj_loader import load_scene
from sycl_ray_tracing.utils.png import write_png


def main():
    size = 64 if small() else 512
    spp = 4 if small() else 64
    tile = 4096 if small() else 32768
    cfg = RenderConfig(width=size, height=size, samples=spp, bounces=4,
                       tile_rays=tile)
    from sycl_ray_tracing.models.camera import cornell_box_camera

    scene = load_scene(os.path.join(os.path.dirname(_HERE), "data",
                                    "cornell_box.obj"))
    # NOTE the pair-budget hint must match the RAY TILE size, not the image
    scene = scene.build_acceleration(num_rays_hint=tile)
    cam = cornell_box_camera()
    f = jax.jit(lambda s, c, k: pathtracer.render(s, c, cfg, k))
    img, dt = timed_render(f, scene, cam, jax.random.PRNGKey(0))
    assert np.isfinite(img).all() and img.mean() > 0.05
    write_png("example2.png", np.asarray(tonemap(img)))
    report("config2_obj_bvh", dt, size * size * spp * cfg.bounces)


if __name__ == "__main__":
    main()
