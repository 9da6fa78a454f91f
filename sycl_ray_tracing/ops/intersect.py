"""Ray/primitive intersection: vectorized Möller–Trumbore and sphere quadric,
plus the brute-force all-primitives scene intersector.

The brute-force intersector is the *oracle*: it reproduces the reference's
``intersect_scene`` (render_kernel.cpp:453-483) and serves as ground truth for
the traversal tests, in the role of the reference's recorded golden-ray
suites (include/bvh_tests.h).

Design notes: rays [R,3] against triangles [N,3,3] is evaluated as a dense
[R,N] elementwise problem — fused elementwise work with a masked argmin
reduce, no per-ray control flow.  For big scenes the BVH traversal (ops/bvh.py)
replaces the O(R*N) oracle.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from jax.ad_checkpoint import checkpoint_name

from sycl_ray_tracing.ops.safe_math import EPS, cross, dot, normalize, safe_sqrt

BIG_T = 3.0e38  # sentinel "no hit" distance

# Remat residual tag for traversal outputs.  Every acceleration-structure
# backend names its kernel outputs (prim indices, hit distances, occlusion
# flags, overflow) with this tag; the integrators remat their bounce/sample
# bodies with policy=save_only_these_names(ISECT_NAME), so the backward
# pass replays SHADING only — the traversal kernels' outputs are saved as
# residuals (tiny int32/bool/f32 [B] arrays) and the kernels themselves are
# dead code in the replay (traversal is under stop_gradient and contributes
# nothing to the VJP).  Measured round 2 without this: backward re-paid the
# full traversal twice (fwd+bwd 0.71 vs fwd 2.25 Mrays/s).
ISECT_NAME = "isect"


def name_traversal(*xs):
    """Tag traversal outputs as remat residuals (see ISECT_NAME)."""
    out = tuple(checkpoint_name(x, ISECT_NAME) for x in xs)
    return out[0] if len(out) == 1 else out


class Hit(NamedTuple):
    """SoA hit record for a batch of rays (reference hit_info.h:6-15)."""

    t: jnp.ndarray        # [R] distance, BIG_T if miss
    point: jnp.ndarray    # [R,3]
    normal: jnp.ndarray   # [R,3] geometric normal
    uv: jnp.ndarray       # [R,2] barycentrics
    prim: jnp.ndarray     # [R] primitive index (triangles first, then spheres)
    hit: jnp.ndarray      # [R] bool


def moller_trumbore(
    ray_o: jnp.ndarray,  # [R,3]
    ray_d: jnp.ndarray,  # [R,3]
    tri: jnp.ndarray,    # [...,3,3] — broadcast against rays
):
    """Möller–Trumbore with the reference's epsilon rules (triangle.h:16-60).

    Returns (t, u, v, valid) broadcast over [R, ...].  ``t`` is BIG_T where
    invalid so a plain min-reduce finds the closest hit.
    """
    va = tri[..., 0, :]
    e1 = tri[..., 1, :] - va
    e2 = tri[..., 2, :] - va

    h = cross(ray_d, e2)
    a = dot(e1, h)
    parallel = jnp.abs(a) < EPS
    f = 1.0 / jnp.where(parallel, 1.0, a)

    s = ray_o - va
    u = f * dot(s, h)
    q = cross(s, e1)
    v = f * dot(ray_d, q)
    t = f * dot(e2, q)

    valid = (
        (~parallel)
        & (u >= 0.0)
        & (u <= 1.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > EPS)
    )
    return jnp.where(valid, t, BIG_T), u, v, valid


def _mt_dense_scalar(ray_o, ray_d, tris):
    """Scalarized dense MT: rays [R,3] x tris [N,3,3] -> t [R,N].

    All arithmetic in [R,N] 2D tiles with xyz as separate broadcasts — no
    [R,N,3] intermediates, which would multiply the memory traffic.
    """
    ax, ay, az = tris[:, 0, 0], tris[:, 0, 1], tris[:, 0, 2]   # [N]
    e1x = tris[:, 1, 0] - ax
    e1y = tris[:, 1, 1] - ay
    e1z = tris[:, 1, 2] - az
    e2x = tris[:, 2, 0] - ax
    e2y = tris[:, 2, 1] - ay
    e2z = tris[:, 2, 2] - az
    dx, dy, dz = ray_d[:, 0:1], ray_d[:, 1:2], ray_d[:, 2:3]
    ox, oy, oz = ray_o[:, 0:1], ray_o[:, 1:2], ray_o[:, 2:3]

    hx = dy * e2z[None] - dz * e2y[None]                        # [R,N]
    hy = dz * e2x[None] - dx * e2z[None]
    hz = dx * e2y[None] - dy * e2x[None]
    a = e1x[None] * hx + e1y[None] * hy + e1z[None] * hz
    parallel = jnp.abs(a) < EPS
    f = 1.0 / jnp.where(parallel, 1.0, a)
    sx, sy, sz = ox - ax[None], oy - ay[None], oz - az[None]
    u = f * (sx * hx + sy * hy + sz * hz)
    qx = sy * e1z[None] - sz * e1y[None]
    qy = sz * e1x[None] - sx * e1z[None]
    qz = sx * e1y[None] - sy * e1x[None]
    v = f * (dx * qx + dy * qy + dz * qz)
    t = f * (e2x[None] * qx + e2y[None] * qy + e2z[None] * qz)
    ok = (
        (~parallel)
        & (u >= 0.0)
        & (u <= 1.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > EPS)
    )
    return jnp.where(ok, t, BIG_T)


def intersect_triangles(ray_o, ray_d, tris):
    """Closest-hit of rays [R,3] against ALL triangles [N,3,3] → Hit.

    Dense [R,N] evaluation (scalarized); closest hit via argmin over N.
    """
    t = _mt_dense_scalar(ray_o, ray_d, tris)
    best = jnp.argmin(t, axis=1)                      # [R]
    best_t = jnp.min(t, axis=1)                       # reduction, no gather
    return _finalize_tri_hit(ray_o, ray_d, tris, best, best_t)


def finalize_hit(ray_o, ray_d, tris, prim):
    """Differentiable hit record for a chosen primitive per ray.

    ONE planar row-gather ([R,9], no [R,3,3] layout copies) + scalarized
    Möller–Trumbore and normal computation — this is the hot epilogue of
    every intersector.  ``prim`` may be -1 for known misses.
    """
    n = tris.shape[0]
    best = jnp.clip(prim, 0, n - 1)
    # remat residual: the [R,9] vertex rows are saved so the backward
    # replay does not re-pay the gather (up to 0.5 ms/launch when the
    # table sits in HBM); checkpoint_name is the identity for AD, so
    # gradients w.r.t. the triangle vertices still flow through it
    tri9 = name_traversal(tris.reshape(n, 9)[best])   # [R,9]
    ax, ay, az = tri9[:, 0], tri9[:, 1], tri9[:, 2]
    e1x, e1y, e1z = tri9[:, 3] - ax, tri9[:, 4] - ay, tri9[:, 5] - az
    e2x, e2y, e2z = tri9[:, 6] - ax, tri9[:, 7] - ay, tri9[:, 8] - az
    dx, dy, dz = ray_d[:, 0], ray_d[:, 1], ray_d[:, 2]
    ox, oy, oz = ray_o[:, 0], ray_o[:, 1], ray_o[:, 2]

    hx = dy * e2z - dz * e2y
    hy = dz * e2x - dx * e2z
    hz = dx * e2y - dy * e2x
    a = e1x * hx + e1y * hy + e1z * hz
    parallel = jnp.abs(a) < EPS
    f = 1.0 / jnp.where(parallel, 1.0, a)
    sx, sy, sz = ox - ax, oy - ay, oz - az
    u = f * (sx * hx + sy * hy + sz * hz)
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    v = f * (dx * qx + dy * qy + dz * qz)
    t = f * (e2x * qx + e2y * qy + e2z * qz)
    valid = (
        (~parallel)
        & (u >= 0.0)
        & (u <= 1.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > EPS)
        & (prim >= 0)
    )
    best_t = jnp.where(valid, t, BIG_T)
    # miss lanes keep point = origin: o + d*BIG_T overflows float32 to inf,
    # and inf/NaN in masked lanes poisons gradients (0 * NaN = NaN in VJPs)
    point = ray_o + ray_d * jnp.where(valid, best_t, 0.0)[:, None]

    nx = e1y * e2z - e1z * e2y
    ny = e1z * e2x - e1x * e2z
    nz = e1x * e2y - e1y * e2x
    inv_len = 1.0 / safe_sqrt(nx * nx + ny * ny + nz * nz)
    normal = jnp.stack([nx * inv_len, ny * inv_len, nz * inv_len], axis=-1)
    return Hit(
        t=best_t,
        point=point,
        normal=normal,
        uv=jnp.stack([u, v], axis=-1),
        prim=best.astype(jnp.int32),
        hit=valid,
    )


def _finalize_tri_hit(ray_o, ray_d, tris, best, best_t):
    """Back-compat shim: hit record for the argmin winner (``best_t`` only
    gates the miss mask; the record itself is recomputed in finalize_hit)."""
    prim = jnp.where(best_t < BIG_T, best, -1)
    return finalize_hit(ray_o, ray_d, tris, prim)


def any_hit_triangles(ray_o, ray_d, tris, t_lim):
    """Occlusion against ALL triangles: True where any t in
    (EPS, t_lim) — no argmin, no hit-record finalize (shadow rays)."""
    t = _mt_dense_scalar(ray_o, ray_d, tris)
    return jnp.any(t < t_lim[:, None], axis=1)


def intersect_spheres(ray_o, ray_d, centers, radii, prim_index):
    """Closest-hit of rays [R,3] against spheres [S,3]/[S] → Hit.

    Analytic quadratic with the reference's nearest-positive-root rule
    (sphere.h:11-53).  ``prim_index`` [S] carries the sphere's global
    primitive index for material lookup (sphere.h:49).
    """
    L = ray_o[:, None, :] - centers[None]             # [R,S,3]
    b = 2.0 * dot(ray_d[:, None, :], L)
    c = dot(L, L) - (radii * radii)[None]
    delta = b * b - 4.0 * c
    sq = safe_sqrt(jnp.maximum(delta, 0.0))
    t1 = (-b - sq) * 0.5
    t2 = (-b + sq) * 0.5
    t = jnp.where(t1 > 0.0, t1, t2)                   # nearest positive root
    valid = (delta >= 0.0) & (t > 0.0)
    t = jnp.where(valid, t, BIG_T)                    # [R,S]

    best = jnp.argmin(t, axis=1)
    best_t = jnp.min(t, axis=1)                       # reduction, no gather
    hit = best_t < BIG_T
    point = ray_o + ray_d * jnp.where(hit, best_t, 0.0)[:, None]
    normal = normalize(point - centers[best])
    return Hit(
        t=best_t,
        point=point,
        normal=normal,
        uv=jnp.zeros((ray_o.shape[0], 2), ray_o.dtype),
        prim=prim_index[best].astype(jnp.int32),
        hit=hit,
    )


def merge_hits(a: Hit, b: Hit) -> Hit:
    """Elementwise closest-of-two hit records."""
    take_a = a.t <= b.t
    sel = lambda x, y: jnp.where(
        take_a.reshape(take_a.shape + (1,) * (x.ndim - take_a.ndim)), x, y
    )
    return Hit(
        t=jnp.where(take_a, a.t, b.t),
        point=sel(a.point, b.point),
        normal=sel(a.normal, b.normal),
        uv=sel(a.uv, b.uv),
        prim=jnp.where(take_a, a.prim, b.prim),
        hit=a.hit | b.hit,
    )


def miss_hit(num_rays: int, dtype=jnp.float32) -> Hit:
    """An all-miss Hit batch (identity for merge_hits)."""
    return Hit(
        t=jnp.full((num_rays,), BIG_T, dtype),
        point=jnp.zeros((num_rays, 3), dtype),
        normal=jnp.zeros((num_rays, 3), dtype),
        uv=jnp.zeros((num_rays, 2), dtype),
        prim=jnp.zeros((num_rays,), jnp.int32),
        hit=jnp.zeros((num_rays,), bool),
    )
