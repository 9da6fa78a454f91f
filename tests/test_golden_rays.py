"""Golden rays on the Cornell box, with hits computed in closed form.

The reference validates its BVHs against recorded rays with expected
closest-hit points at 1e-5 per-component absolute tolerance
(tests.cpp:10-14).  Here the expected points need no recording: the box's
walls are the axis-aligned planes x=-1, x=1, y=0, y=2 and z=-1
(data/cornell_box.obj), and every ray below is chosen so that its segment
to the wall stays clear of the two inner boxes and the ceiling light.  A
ray aimed at a wall point therefore hits exactly that point, on that
wall's material.  Miss rays leave through the open front (+z) side.
All three intersectors — brute force, lockstep BVH, wavefront cluster
tracer — must reproduce them.
"""

import numpy as np
import pytest

TOL = 1e-5  # reference compare_points tolerance (tests.cpp:10-14)
N_PER_WALL = 96


def _golden_data():
    """-> (hit_rays [R,6] f32, hit_points [R,3], wall names [R],
    miss_rays [M,6] f32)."""
    rng = np.random.default_rng(2024)
    n = N_PER_WALL

    def u(lo, hi, k=n):
        return rng.uniform(lo, hi, k)

    def interior(k=n):
        # above both boxes (top y=1.2), below the light (y=1.99)
        return np.stack([u(-0.5, 0.5, k), u(1.3, 1.9, k), u(0.2, 0.9, k)], 1)

    # (origins, targets on the wall, wall material, axis fixed by the wall)
    side = np.where(rng.random(n) < 0.5, -1.0, 1.0)
    groups = [
        # ceiling y=2: |x| >= 0.4 all along the segment keeps it off the
        # light quad (x in [-0.24, 0.23])
        (np.stack([side * u(0.4, 0.95), u(1.6, 1.9), u(-0.9, 0.9)], 1),
         np.stack([side * u(0.4, 0.99), np.full(n, 2.0), u(-0.99, 0.99)], 1),
         "ceiling", 1),
        (interior(),
         np.stack([u(-0.99, 0.99), u(1.3, 1.9), np.full(n, -1.0)], 1),
         "backWall", 2),
        (interior(),
         np.stack([np.full(n, -1.0), u(1.3, 1.9), u(-0.99, 0.99)], 1),
         "leftWall", 0),
        (interior(),
         np.stack([np.full(n, 1.0), u(1.3, 1.9), u(-0.99, 0.99)], 1),
         "rightWall", 0),
        # floor y=0 inside the front strip z in [0.8, 0.99], clear of both
        # boxes (short box z <= 0.75)
        (np.stack([u(-0.9, 0.9), np.full(n, 1.9), u(0.8, 0.99)], 1),
         np.stack([u(-0.99, 0.99), np.zeros(n), u(0.8, 0.99)], 1),
         "floor", 1),
    ]
    rays, pts, names = [], [], []
    for o, t, name, axis in groups:
        d = (t - o) / np.linalg.norm(t - o, axis=1, keepdims=True)
        o32, d32 = o.astype(np.float32), d.astype(np.float32)
        # closed form on the rays as stored (float32): the wall plane fixes
        # one coordinate, which gives the distance and then the other two
        o64, d64 = o32.astype(np.float64), d32.astype(np.float64)
        dist = (t[:, axis] - o64[:, axis]) / d64[:, axis]
        rays.append(np.concatenate([o32, d32], axis=1))
        pts.append(o64 + dist[:, None] * d64)
        names += [name] * n

    # misses: out through the open front (all geometry has z <= 1) ...
    mo = interior(128)
    mt = np.stack([u(-0.95, 0.95, 128), u(1.3, 1.9, 128),
                   np.full(128, 1.5)], 1)
    # ... and from the camera position, looking away from the box
    co = np.tile([[0.0, 1.0, 3.5]], (16, 1))
    ct = co + np.stack([u(-0.3, 0.3, 16), u(-0.3, 0.3, 16),
                        np.ones(16)], 1)
    o = np.concatenate([mo, co])
    d = np.concatenate([mt - mo, ct - co])
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    miss_rays = np.concatenate([o, d], axis=1).astype(np.float32)
    return (np.concatenate(rays), np.concatenate(pts), np.array(names),
            miss_rays)


@pytest.fixture(scope="module")
def golden():
    return _golden_data()


def _pad_rays(rays_o, rays_d, multiple=64):
    """Pad ray count to a friendly batch size (budgets assume batches)."""
    n = rays_o.shape[0]
    pad = (-n) % multiple
    if pad:
        rays_o = np.concatenate(
            [rays_o, np.tile(rays_o[-1:], (pad, 1))], axis=0
        )
        rays_d = np.concatenate(
            [rays_d, np.tile(rays_d[-1:], (pad, 1))], axis=0
        )
    return rays_o, rays_d, n


def _closest_t(backend, scene, rays):
    """Run one intersector; returns (t [R], prim [R]) for the given rays."""
    import jax.numpy as jnp

    o, d, n = _pad_rays(rays[:, :3], rays[:, 3:])
    o = jnp.asarray(o)
    d = jnp.asarray(d)
    if backend == "brute":
        from sycl_ray_tracing.ops.intersect import intersect_triangles

        hit = intersect_triangles(o, d, scene.triangles)
        prim = jnp.where(hit.hit, hit.prim, -1)
        return np.asarray(hit.t)[:n], np.asarray(prim)[:n]
    if backend == "bvh":
        from sycl_ray_tracing.ops.bvh import build_bvh, closest_prim

        bvh = build_bvh(np.asarray(scene.triangles))
        t, prim = closest_prim(bvh, o, d)
        return np.asarray(t)[:n], np.asarray(prim)[:n]
    if backend == "cluster":
        from sycl_ray_tracing.ops.cluster import build_clusters, closest_hit

        clusters = build_clusters(np.asarray(scene.triangles))
        t, prim, overflow = closest_hit(clusters, o, d)
        assert not bool(overflow)
        return np.asarray(t)[:n], np.asarray(prim)[:n]
    raise ValueError(backend)


@pytest.mark.parametrize("backend", ["brute", "bvh", "cluster"])
def test_golden_hit_rays(backend, cornell_scene, golden):
    """Every golden ray hits its wall at the closed-form point."""
    from sycl_ray_tracing.ops.intersect import BIG_T
    from sycl_ray_tracing.utils.obj_loader import parse_obj
    from tests.conftest import CORNELL_OBJ

    hit_rays, expected_pts, wall, _ = golden
    t, prim = _closest_t(backend, cornell_scene, hit_rays)
    assert (t < BIG_T).all(), (
        f"{backend}: {(t >= BIG_T).sum()} golden hit rays missed"
    )
    assert (prim >= 0).all()
    pts = hit_rays[:, :3] + t[:, None] * hit_rays[:, 3:]
    err = np.abs(pts - expected_pts).max(axis=1)
    bad = err > TOL
    assert not bad.any(), (
        f"{backend}: {bad.sum()}/{len(err)} golden points off; "
        f"worst {err.max():.2e}"
    )
    parsed = parse_obj(CORNELL_OBJ)
    names = np.array(parsed.material_names)[parsed.material_indices[prim]]
    np.testing.assert_array_equal(names, wall)


@pytest.mark.parametrize("backend", ["brute", "bvh", "cluster"])
def test_golden_miss_rays(backend, cornell_scene, golden):
    """Rays leaving through the open front find no intersection."""
    from sycl_ray_tracing.ops.intersect import BIG_T

    _, _, _, miss_rays = golden
    t, prim = _closest_t(backend, cornell_scene, miss_rays)
    assert (t >= BIG_T).all(), (
        f"{backend}: {(t < BIG_T).sum()} golden miss rays reported a hit"
    )
    assert (prim < 0).all()


def test_small_flat_bvh_fixture():
    """The reference's only hand-built unit fixture (tests.cpp:60-101):
    9 flat triangles stacked along -z; the axis ray from the origin must
    hit the NEAREST one at exactly (0, 0, -2) — through every backend."""
    import jax.numpy as jnp

    from sycl_ray_tracing.ops import bvh as bvh_mod
    from sycl_ray_tracing.ops import cluster as cl
    from sycl_ray_tracing.ops.intersect import intersect_triangles

    tris = np.array(
        [
            [[0, 0, -2], [2, 0, -2], [1, 1, -2]],
            [[0, 0, -3], [2, 0, -3], [1, 1, -3]],
            [[0, 0, -4], [2, 0, -4], [1, 1, -4]],
            [[0, 0, -5], [2, 0, -5], [1, 1, -5]],
            [[0, 0, -6], [2, 0, -6], [1, 1, -6]],
            [[-2, 0, -2], [0, 0, -2], [-1, 1, -2]],
            [[2, 0, -3], [4, 0, -3], [3, 1, -3]],
            [[0, -2, -4], [2, -2, -4], [1, -1, -4]],
            [[0, -2, -5], [2, -2, -5], [1, -1, -5]],
        ],
        np.float32,
    )
    o = jnp.zeros((1, 3), jnp.float32)
    d = jnp.asarray([[0.0, 0.0, -1.0]], jnp.float32)
    expected = np.array([0.0, 0.0, -2.0])

    hit = intersect_triangles(o, d, jnp.asarray(tris))
    assert bool(hit.hit[0])
    np.testing.assert_allclose(np.asarray(hit.point[0]), expected,
                               atol=1e-5)

    bvh = bvh_mod.build_bvh(tris)
    t, prim = bvh_mod.closest_prim(bvh, o, d)
    np.testing.assert_allclose(float(t[0]), 2.0, atol=1e-5)

    cs = cl.build_clusters(tris)
    t, prim, _of = cl.closest_hit(cs.with_budgets(64, 64), o, d)
    np.testing.assert_allclose(float(t[0]), 2.0, atol=1e-5)
