#!/usr/bin/env python
"""BASELINE config 1: Cornell-style spheres-only scene, direct lighting,
diffuse BRDF, 256x256 @ 16spp."""

import os
import sys

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(_HERE), _HERE]

import numpy as np
from _common import report, setup_jax, small, timed_render

jax = setup_jax()

from sycl_ray_tracing.models import pathtracer
from sycl_ray_tracing.models.camera import cornell_box_camera
from sycl_ray_tracing.models.scene import add_sphere, make_materials, make_scene
from sycl_ray_tracing.ops.tonemap import tonemap
from sycl_ray_tracing.utils.config import RenderConfig
from sycl_ray_tracing.utils.png import write_png


def build_scene():
    # floor + area light as the only triangles; everything else is spheres
    g = 3.0
    tris = np.array(
        [
            [[-g, 0, -g], [g, 0, g], [g, 0, -g]],
            [[-g, 0, -g], [-g, 0, g], [g, 0, g]],
            # light quad facing down at y=3
            [[-0.6, 3, -0.6], [0.6, 3, -0.6], [0.6, 3, 0.6]],
            [[-0.6, 3, -0.6], [0.6, 3, 0.6], [-0.6, 3, 0.6]],
        ],
        np.float32,
    )
    mats = make_materials(
        emission=[(1, 0, 1), (0, 0, 0), (30, 30, 30)],
        diffuse=[(0, 0, 0), (0.7, 0.7, 0.7), (0, 0, 0)],
        metalness=[0, 0, 0],
        roughness=[1.0, 1.0, 1.0],  # roughness 1 = diffuse-dominant
    )
    scene = make_scene(tris, np.array([1, 1, 2, 2], np.int32), mats)
    scene = add_sphere(scene, (0.0, 0.7, 0.0), 0.7, diffuse=(0.8, 0.3, 0.3),
                       roughness=1.0)
    scene = add_sphere(scene, (1.4, 0.45, 0.6), 0.45, diffuse=(0.3, 0.8, 0.3),
                       roughness=1.0)
    scene = add_sphere(scene, (-1.3, 0.5, -0.4), 0.5, diffuse=(0.3, 0.3, 0.8),
                       roughness=1.0)
    return scene


def main():
    size = 64 if small() else 256
    spp = 4 if small() else 16
    cfg = RenderConfig(width=size, height=size, samples=spp, bounces=1,
                      tile_rays=None)
    scene = build_scene()
    from sycl_ray_tracing.ops import transform as T
    from sycl_ray_tracing.models.camera import Camera

    cam = Camera.create(45.0, T.compose(T.rotation_x(-20.0),
                                        T.translation(0.0, 0.2, 6.0)))
    f = jax.jit(lambda s, c, k: pathtracer.render(s, c, cfg, k))
    img, dt = timed_render(f, scene, cam, jax.random.PRNGKey(0))
    assert np.isfinite(img).all() and img.mean() > 0.01
    write_png("example1.png", np.asarray(tonemap(img)))
    report("config1_spheres_direct", dt, size * size * spp * cfg.bounces)


if __name__ == "__main__":
    main()
