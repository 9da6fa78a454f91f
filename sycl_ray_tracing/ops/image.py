"""Image/framebuffer utilities.

Capability parity with the reference Image class beyond raw storage
(include/image.h): per-pixel / per-area luminance (:80-101), bilinear and
nearest sampling (:104-135), and the offline gamma/range utilities from
image_io.cpp:12-95.  Everything is a pure function over [H,W,3] jnp arrays.
"""

from __future__ import annotations

import jax.numpy as jnp

from sycl_ray_tracing.ops.safe_math import luminance


def luminance_of_pixel(image: jnp.ndarray, x, y) -> jnp.ndarray:
    """Luminance of texel (x, y) (image.h:80-84)."""
    return luminance(image[y, x])


def luminance_of_area(image: jnp.ndarray, x0: int, x1: int,
                      y0: int, y1: int) -> jnp.ndarray:
    """Summed luminance over the rect [x0,x1) x [y0,y1) (image.h:86-101)."""
    return jnp.sum(luminance(image[y0:y1, x0:x1]))


def sample_nearest(image: jnp.ndarray, uv: jnp.ndarray) -> jnp.ndarray:
    """Nearest-texel sample at uv in [0,1]^2 ([...,2]) (image.h:126-135)."""
    h, w = image.shape[0], image.shape[1]
    x = jnp.clip((uv[..., 0] * w).astype(jnp.int32), 0, w - 1)
    y = jnp.clip((uv[..., 1] * h).astype(jnp.int32), 0, h - 1)
    return image[y, x]


def sample_bilinear(image: jnp.ndarray, uv: jnp.ndarray) -> jnp.ndarray:
    """Bilinear sample at uv in [0,1]^2 ([...,2]) (image.h:104-124)."""
    h, w = image.shape[0], image.shape[1]
    fx = uv[..., 0] * w - 0.5
    fy = uv[..., 1] * h - 0.5
    x0 = jnp.clip(jnp.floor(fx).astype(jnp.int32), 0, w - 1)
    y0 = jnp.clip(jnp.floor(fy).astype(jnp.int32), 0, h - 1)
    x1 = jnp.clip(x0 + 1, 0, w - 1)
    y1 = jnp.clip(y0 + 1, 0, h - 1)
    tx = jnp.clip(fx - x0, 0.0, 1.0)[..., None]
    ty = jnp.clip(fy - y0, 0.0, 1.0)[..., None]
    c00 = image[y0, x0]
    c10 = image[y0, x1]
    c01 = image[y1, x0]
    c11 = image[y1, x1]
    return (
        (1 - tx) * (1 - ty) * c00
        + tx * (1 - ty) * c10
        + (1 - tx) * ty * c01
        + tx * ty * c11
    )


def normalize_range(image: jnp.ndarray) -> jnp.ndarray:
    """Linear remap to [0,1] (reference image_io.cpp 'range' utility)."""
    lo = jnp.min(image)
    hi = jnp.max(image)
    return (image - lo) / jnp.maximum(hi - lo, 1e-12)
