"""Intersection ops vs a slow per-ray numpy oracle."""

import jax.numpy as jnp
import numpy as np

from sycl_ray_tracing.ops.intersect import (
    BIG_T,
    intersect_spheres,
    intersect_triangles,
    merge_hits,
    moller_trumbore,
)


def _numpy_mt(o, d, tri, eps=1e-7):
    """Scalar Möller–Trumbore (mirrors reference triangle.h:16-60)."""
    e1 = tri[1] - tri[0]
    e2 = tri[2] - tri[0]
    h = np.cross(d, e2)
    a = np.dot(e1, h)
    if -eps < a < eps:
        return None
    f = 1.0 / a
    s = o - tri[0]
    u = f * np.dot(s, h)
    if u < 0 or u > 1:
        return None
    q = np.cross(s, e1)
    v = f * np.dot(d, q)
    if v < 0 or u + v > 1:
        return None
    t = f * np.dot(e2, q)
    if t > eps:
        return t, u, v
    return None


def test_single_triangle_hit():
    tri = jnp.array([[[0.0, 0.0, -2.0], [1.0, 0.0, -2.0], [0.0, 1.0, -2.0]]])
    o = jnp.array([[0.2, 0.2, 0.0]])
    d = jnp.array([[0.0, 0.0, -1.0]])
    hit = intersect_triangles(o, d, tri)
    assert bool(hit.hit[0])
    np.testing.assert_allclose(hit.t[0], 2.0, atol=1e-6)
    np.testing.assert_allclose(hit.point[0], [0.2, 0.2, -2.0], atol=1e-6)
    # geometric normal of CCW triangle facing +z
    np.testing.assert_allclose(hit.normal[0], [0.0, 0.0, 1.0], atol=1e-6)


def test_miss_behind_ray():
    tri = jnp.array([[[0.0, 0.0, 2.0], [1.0, 0.0, 2.0], [0.0, 1.0, 2.0]]])
    o = jnp.array([[0.2, 0.2, 0.0]])
    d = jnp.array([[0.0, 0.0, -1.0]])  # triangle is behind
    hit = intersect_triangles(o, d, tri)
    assert not bool(hit.hit[0])
    assert float(hit.t[0]) == float(np.float32(BIG_T))


def test_parallel_ray_misses():
    tri = jnp.array([[[0.0, 0.0, -2.0], [1.0, 0.0, -2.0], [0.0, 1.0, -2.0]]])
    o = jnp.array([[0.0, 0.0, 0.0]])
    d = jnp.array([[1.0, 0.0, 0.0]])  # parallel to the triangle plane
    hit = intersect_triangles(o, d, tri)
    assert not bool(hit.hit[0])


def test_random_rays_match_numpy_oracle():
    rng = np.random.default_rng(7)
    tris = rng.uniform(-1, 1, (50, 3, 3)).astype(np.float32)
    o = rng.uniform(-2, 2, (128, 3)).astype(np.float32)
    d = rng.normal(size=(128, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)

    hit = intersect_triangles(jnp.asarray(o), jnp.asarray(d), jnp.asarray(tris))
    for r in range(128):
        best_t, best_i = np.inf, -1
        for i in range(50):
            res = _numpy_mt(o[r], d[r], tris[i])
            if res and res[0] < best_t:
                best_t, best_i = res[0], i
        if best_i < 0:
            assert not bool(hit.hit[r]), f"ray {r}: false positive"
        else:
            assert bool(hit.hit[r]), f"ray {r}: false negative"
            np.testing.assert_allclose(hit.t[r], best_t, rtol=1e-4)
            assert int(hit.prim[r]) == best_i


def test_sphere_intersection():
    centers = jnp.array([[0.0, 0.0, -5.0]])
    radii = jnp.array([1.0])
    prim = jnp.array([7], jnp.int32)
    o = jnp.array([[0.0, 0.0, 0.0], [0.0, 3.0, 0.0], [0.0, 0.0, -4.5]])
    d = jnp.array([[0.0, 0.0, -1.0], [0.0, 0.0, -1.0], [0.0, 0.0, -1.0]])
    hit = intersect_spheres(o, d, centers, radii, prim)
    # front hit at t=4
    assert bool(hit.hit[0]) and abs(float(hit.t[0]) - 4.0) < 1e-5
    np.testing.assert_allclose(hit.normal[0], [0.0, 0.0, 1.0], atol=1e-5)
    assert int(hit.prim[0]) == 7
    # ray passes above the sphere
    assert not bool(hit.hit[1])
    # origin inside: nearest positive root = far side (reference sphere.h:36-44)
    assert bool(hit.hit[2]) and abs(float(hit.t[2]) - 1.5) < 1e-5


def test_merge_hits_takes_closest():
    tri = jnp.array([[[-9, -9, -3.0], [9, -9, -3.0], [0, 9, -3.0]]], jnp.float32)
    o = jnp.array([[0.0, 0.0, 0.0]])
    d = jnp.array([[0.0, 0.0, -1.0]])
    h_tri = intersect_triangles(o, d, tri)  # t=3
    h_sph = intersect_spheres(
        o, d, jnp.array([[0.0, 0.0, -2.0]]), jnp.array([0.5]),
        jnp.array([5], jnp.int32),
    )  # t=1.5
    m = merge_hits(h_tri, h_sph)
    assert abs(float(m.t[0]) - 1.5) < 1e-5 and int(m.prim[0]) == 5
    m2 = merge_hits(h_sph, h_tri)
    assert abs(float(m2.t[0]) - 1.5) < 1e-5


def test_moller_trumbore_broadcast_shape():
    tris = jnp.zeros((4, 3, 3))
    o = jnp.zeros((6, 3))
    d = jnp.ones((6, 3))
    t, u, v, valid = moller_trumbore(o[:, None, :], d[:, None, :], tris[None])
    assert t.shape == (6, 4)
