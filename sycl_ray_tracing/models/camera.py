"""Pinhole camera: presets + batched primary-ray generation.

Parity with the reference (include/camera.h, source/camera.cpp,
render_kernel.cpp:56-73):
  * view_matrix = transform @ DEFAULT_COORDINATES_SYSTEM (-Z forward)
  * fov_dist = 1/tan(fov/2); ray through (x_ndc*aspect, y_ndc, fov_dist)
  * the five presets (Cornell / Ganesha / ITE orb / PBRT dragon / MIS)

The camera is a pytree whose view matrix is a differentiable leaf — camera
pose gradients come for free.
"""

from __future__ import annotations

import dataclasses
import math

import jax
import jax.numpy as jnp

from sycl_ray_tracing.ops import transform as T


# -Z forward coordinate flip (reference camera.cpp:3)
def _default_coordinate_system() -> jnp.ndarray:
    return jnp.diag(jnp.array([1.0, 1.0, -1.0, 1.0], jnp.float32))


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Camera:
    view_matrix: jnp.ndarray                                   # [4,4]
    fov_dist: jnp.ndarray                                      # [] scalar

    @staticmethod
    def create(fov_degrees: float = 45.0, transform=None) -> "Camera":
        """fov is the FULL field of view in degrees (camera.h:22-31)."""
        if transform is None:
            transform = T.identity()
        view = T.compose(jnp.asarray(transform, jnp.float32),
                         _default_coordinate_system())
        fov_dist = 1.0 / math.tan(math.radians(fov_degrees) / 2.0)
        return Camera(view_matrix=view,
                      fov_dist=jnp.asarray(fov_dist, jnp.float32))

    def generate_rays(self, px: jnp.ndarray, py: jnp.ndarray,
                      width: int, height: int):
        """Primary rays through continuous pixel coords px, py [...].

        Matches reference get_camera_ray (render_kernel.cpp:56-73):
        NDC in [-1,1], aspect applied on x, two points through the view
        matrix, normalized direction.
        """
        x_ndc = (px / width * 2.0 - 1.0) * (width / height)
        y_ndc = py / height * 2.0 - 1.0

        origin = T.apply_point(self.view_matrix,
                               jnp.zeros(px.shape + (3,), jnp.float32))
        target_ndc = jnp.stack(
            [x_ndc, y_ndc, jnp.broadcast_to(self.fov_dist, px.shape)], axis=-1
        )
        target_world = T.apply_point(self.view_matrix, target_ndc)
        direction = target_world - origin
        direction = direction / jnp.linalg.norm(direction, axis=-1, keepdims=True)
        return origin, direction


# The five reference presets (camera.cpp:4-8)
def cornell_box_camera() -> Camera:
    return Camera.create(45.0, T.translation(0.0, 1.0, 3.5))


def ganesha_camera() -> Camera:
    return Camera.create(
        45.0, T.compose(T.rotation_x(-15.0), T.translation(-0.0205, 0.67, 1.0))
    )


def ite_orb_camera() -> Camera:
    return Camera.create(
        45.0, T.compose(T.rotation_x(-45.0), T.translation(0.0, 0.15, 1.5))
    )


def pbrt_dragon_camera() -> Camera:
    return Camera.create(
        45.0, T.compose(T.rotation_x(-45.0), T.translation(0.0, -1.0, 10.5))
    )


def mis_camera() -> Camera:
    return Camera.create(
        45.0, T.compose(T.rotation_x(-10.0), T.translation(0.0, -3.0, 10.5))
    )


PRESETS = {
    "cornell": cornell_box_camera,
    "ganesha": ganesha_camera,
    "ite_orb": ite_orb_camera,
    "pbrt_dragon": pbrt_dragon_camera,
    "mis": mis_camera,
}
