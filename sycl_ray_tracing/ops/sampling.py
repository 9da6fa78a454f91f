"""Sampling primitives: ONB frames, hemisphere samplers, MIS heuristics,
triangle area sampling.

Capability parity with reference render_kernel.cpp:5-54 (branchless ONB,
uniform/cosine hemisphere), :513-518 (power heuristic) and :715-742
(uniform triangle area sampling for NEE) — vectorized over ray batches.
"""

from __future__ import annotations

import jax.numpy as jnp

from sycl_ray_tracing.ops.safe_math import cross, dot, length, safe_sqrt


def branchless_onb(n: jnp.ndarray):
    """Orthonormal basis around normals [...,3] (Duff et al. 2017,
    reference render_kernel.cpp:5-12).  Returns (tangent, bitangent)."""
    sign = jnp.where(n[..., 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + n[..., 2])
    b = n[..., 0] * n[..., 1] * a
    t = jnp.stack(
        [1.0 + sign * n[..., 0] * n[..., 0] * a, sign * b, -sign * n[..., 0]],
        axis=-1,
    )
    bt = jnp.stack([b, sign + n[..., 1] * n[..., 1] * a, -n[..., 1]], axis=-1)
    return t, bt


def to_world(n: jnp.ndarray, local_dir: jnp.ndarray) -> jnp.ndarray:
    """Rotate a Z-up local direction into the frame around normal ``n``
    (reference rotate_vector_around_normal, render_kernel.cpp:14-22)."""
    t, bt = branchless_onb(n)
    return (
        local_dir[..., 0:1] * t
        + local_dir[..., 1:2] * bt
        + local_dir[..., 2:3] * n
    )


def uniform_hemisphere(n: jnp.ndarray, u1, u2):
    """Uniform directions around normals; returns (dir, pdf)
    (reference render_kernel.cpp:24-37)."""
    phi = 2.0 * jnp.pi * u1
    root = safe_sqrt(1.0 - u2 * u2)
    local = jnp.stack([jnp.cos(phi) * root, jnp.sin(phi) * root, u2], axis=-1)
    pdf = jnp.full_like(u1, 1.0 / (2.0 * jnp.pi))
    return to_world(n, local), pdf


def cosine_hemisphere(n: jnp.ndarray, u1, u2):
    """Cosine-weighted directions; returns (dir, pdf)
    (reference render_kernel.cpp:39-54)."""
    sqrt_u2 = safe_sqrt(u2)
    phi = 2.0 * jnp.pi * u1
    cos_t = sqrt_u2
    sin_t = safe_sqrt(jnp.maximum(0.0, 1.0 - cos_t * cos_t))
    local = jnp.stack(
        [jnp.cos(phi) * sin_t, jnp.sin(phi) * sin_t, sqrt_u2], axis=-1
    )
    pdf = sqrt_u2 / jnp.pi
    return to_world(n, local), pdf


def power_heuristic(pdf_a, pdf_b):
    """Two-sample power heuristic, beta=2 (reference render_kernel.cpp:513-518).

    Computed scale-invariantly as 1/(1+(b/a)^2): the textbook a^2/(a^2+b^2)
    form overflows float32 in the BACKWARD pass for near-specular pdfs
    (d/da involves (a^2+b^2)^2 ~ 1e60).  The ratio is clipped at 1e8 —
    beyond that the weight is < 1e-16 and its gradient is numerically 0
    anyway — keeping both passes finite.  Returns 0 where pdf_a == 0.
    """
    r = jnp.clip(pdf_b / jnp.maximum(pdf_a, 1e-20), 0.0, 1e8)
    w = 1.0 / (1.0 + r * r)
    return jnp.where(pdf_a > 0.0, w, 0.0)


def sample_triangle_uniform(va, vb, vc, u1, u2):
    """Uniform area sample of triangles (square-root warp, reference
    render_kernel.cpp:721-731).  va/vb/vc: [...,3]; u1,u2: [...].

    Returns (point [...,3], unit normal [...,3], area [...])."""
    sqrt_r1 = safe_sqrt(u1)
    u = 1.0 - sqrt_r1
    v = (1.0 - u2) * sqrt_r1
    ab = vb - va
    ac = vc - va
    p = va + ab * u[..., None] + ac * v[..., None]
    n = cross(ab, ac)
    ln = length(n)
    return p, n / ln[..., None], 0.5 * ln


def triangle_area(tris: jnp.ndarray) -> jnp.ndarray:
    """Areas of triangles [...,3,3] (reference triangle.cpp:8-11)."""
    ab = tris[..., 1, :] - tris[..., 0, :]
    ac = tris[..., 2, :] - tris[..., 0, :]
    return 0.5 * length(cross(ab, ac))
