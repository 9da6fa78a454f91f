"""BVH vs brute-force oracle — the generalization of the reference's
golden-ray regression suites (bvh_tests.h: recorded rays + expected hits,
validated against two intersector implementations, tests.cpp:16-152)."""

import jax.numpy as jnp
import numpy as np
import pytest

from tests.conftest import CORNELL_OBJ
from sycl_ray_tracing.ops.bvh import build_bvh, closest_prim, intersect_bvh
from sycl_ray_tracing.ops.intersect import BIG_T, intersect_triangles
from sycl_ray_tracing.utils.obj_loader import parse_obj


def _random_rays(n, rng, lo=-2.0, hi=2.0):
    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d)


def _check_agreement(tris, o, d, leaf_size=4):
    bvh = build_bvh(np.asarray(tris), leaf_size=leaf_size)
    oracle = intersect_triangles(o, d, tris)
    got = intersect_bvh(bvh, tris, o, d)
    np.testing.assert_array_equal(np.asarray(got.hit), np.asarray(oracle.hit))
    m = np.asarray(oracle.hit)
    np.testing.assert_allclose(
        np.asarray(got.t)[m], np.asarray(oracle.t)[m], rtol=1e-5
    )
    # primitive ids must match except exact-tie cases (equal t)
    pm = np.asarray(got.prim)[m] == np.asarray(oracle.prim)[m]
    ties = ~pm
    if ties.any():
        tt = np.asarray(got.t)[m][ties]
        ot = np.asarray(oracle.t)[m][ties]
        np.testing.assert_allclose(tt, ot, rtol=1e-6)
    np.testing.assert_allclose(
        np.asarray(got.point)[m], np.asarray(oracle.point)[m], rtol=1e-4,
        atol=1e-5,
    )


def test_single_triangle():
    tris = jnp.array(
        [[[0.0, 0.0, -2.0], [1.0, 0.0, -2.0], [0.0, 1.0, -2.0]]]
    )
    o = jnp.array([[0.2, 0.2, 0.0], [5.0, 5.0, 0.0]])
    d = jnp.array([[0.0, 0.0, -1.0], [0.0, 0.0, -1.0]])
    _check_agreement(tris, o, d)


def test_nine_triangle_depth_scene():
    """Mirror of the reference's synthetic small_flat_bvh_tests
    (tests.cpp:60-101): parallel triangles stacked in z; nearest must win."""
    zs = [-2.0, -3.0, -4.0, -5.0, -6.0, -7.0, -8.0, -9.0, -10.0]
    tris = jnp.array(
        [
            [[-1.0, -1.0, z], [1.0, -1.0, z], [0.0, 1.0, z]]
            for z in zs
        ]
    )
    o = jnp.array([[0.0, 0.0, 0.0]])
    d = jnp.array([[0.0, 0.0, -1.0]])
    bvh = build_bvh(np.asarray(tris), leaf_size=2)
    t, prim = closest_prim(bvh, o, d)
    assert abs(float(t[0]) - 2.0) < 1e-6
    assert int(prim[0]) == 0


def test_random_soup_vs_oracle():
    rng = np.random.default_rng(0)
    tris = jnp.asarray(rng.uniform(-1, 1, (300, 3, 3)).astype(np.float32))
    o, d = _random_rays(512, rng)
    _check_agreement(tris, o, d)


@pytest.mark.parametrize("leaf_size", [1, 4, 8])
def test_leaf_sizes(leaf_size):
    rng = np.random.default_rng(3)
    tris = jnp.asarray(rng.uniform(-1, 1, (57, 3, 3)).astype(np.float32))
    o, d = _random_rays(128, rng)
    _check_agreement(tris, o, d, leaf_size=leaf_size)


def test_cornell_golden_rays():
    """Recorded-style suite on the cornell scene: rays from inside the box
    in random directions all hit (closed box); results match the oracle."""
    parsed = parse_obj(CORNELL_OBJ)
    tris = jnp.asarray(parsed.triangles)
    rng = np.random.default_rng(7)
    o = rng.uniform(-0.4, 0.4, (256, 3)).astype(np.float32) + np.array(
        [0.0, 1.0, 0.0], np.float32
    )
    d = rng.normal(size=(256, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o, d = jnp.asarray(o), jnp.asarray(d)
    _check_agreement(tris, o, d)
    # the cornell box is open on the camera side, so only most rays hit
    bvh = build_bvh(parsed.triangles)
    got = intersect_bvh(bvh, tris, o, d)
    assert np.asarray(got.hit).mean() > 0.8


def test_all_miss_rays():
    rng = np.random.default_rng(11)
    tris = jnp.asarray(rng.uniform(-1, 1, (64, 3, 3)).astype(np.float32))
    # rays far away pointing away
    o = jnp.asarray(np.full((32, 3), 100.0, np.float32))
    d = jnp.tile(jnp.array([[1.0, 0.0, 0.0]], jnp.float32), (32, 1))
    bvh = build_bvh(np.asarray(tris))
    t, prim = closest_prim(bvh, o, d)
    assert (np.asarray(prim) == -1).all()
    assert (np.asarray(t) == np.float32(BIG_T)).all()


def test_axis_aligned_rays_no_nan():
    """Axis-aligned rays hit degenerate slab divisions — must stay NaN-free."""
    tris = jnp.array(
        [[[-1.0, -1.0, -5.0], [1.0, -1.0, -5.0], [0.0, 1.0, -5.0]]]
    )
    o = jnp.array([[0.0, 0.0, 0.0], [0.0, 0.0, 0.0], [0.0, 0.0, 0.0]])
    d = jnp.array([[0.0, 0.0, -1.0], [0.0, -1.0, 0.0], [1.0, 0.0, 0.0]])
    bvh = build_bvh(np.asarray(tris))
    t, prim = closest_prim(bvh, o, d)
    assert np.isfinite(np.asarray(t)[np.asarray(prim) >= 0]).all()
    assert int(prim[0]) == 0 and int(prim[1]) == -1 and int(prim[2]) == -1


def test_large_scene_traversal_visits_less_than_brute():
    """Sanity perf property: traversal terminates and agrees on a 10k-tri
    scene (would be slow only if skip links were wrong)."""
    rng = np.random.default_rng(5)
    # clustered scene: small triangles scattered in a large volume
    centers = rng.uniform(-10, 10, (10_000, 1, 3)).astype(np.float32)
    offsets = rng.uniform(-0.05, 0.05, (10_000, 3, 3)).astype(np.float32)
    tris = jnp.asarray(centers + offsets)
    o, d = _random_rays(256, rng, -12, 12)
    _check_agreement(tris, o, d)


def test_any_hit_matches_oracle():
    """any_hit == (closest hit exists with t + eps < t_max)."""
    rng = np.random.default_rng(21)
    tris = jnp.asarray(rng.uniform(-1, 1, (200, 3, 3)).astype(np.float32))
    o, d = _random_rays(256, rng)
    bvh = build_bvh(np.asarray(tris))
    oracle = intersect_triangles(o, d, tris)
    from sycl_ray_tracing.ops.bvh import any_hit

    for tmax_val in (0.5, 2.0, 1e30):
        t_max = jnp.full((256,), tmax_val, jnp.float32)
        got = np.asarray(any_hit(bvh, o, d, t_max))
        want = np.asarray(oracle.hit & (oracle.t + 1e-4 < t_max))
        np.testing.assert_array_equal(got, want)


def test_native_sah_builder_agrees():
    """C++ binned-SAH build produces identical intersection results to both
    the numpy Morton build and the brute-force oracle."""
    from sycl_ray_tracing import native

    if not native.available():
        pytest.skip("native library not built")
    rng = np.random.default_rng(33)
    centers = rng.uniform(-5, 5, (2000, 1, 3)).astype(np.float32)
    tris = jnp.asarray(
        centers + rng.uniform(-0.1, 0.1, (2000, 3, 3)).astype(np.float32)
    )
    o, d = _random_rays(512, rng, -6, 6)
    oracle = intersect_triangles(o, d, tris)
    for method in ("sah", "morton"):
        bvh = build_bvh(np.asarray(tris), method=method)
        got = intersect_bvh(bvh, tris, o, d)
        np.testing.assert_array_equal(
            np.asarray(got.hit), np.asarray(oracle.hit), err_msg=method
        )
        m = np.asarray(oracle.hit)
        np.testing.assert_allclose(
            np.asarray(got.t)[m], np.asarray(oracle.t)[m], rtol=1e-5,
            err_msg=method,
        )


def test_native_obj_parser_agrees():
    """C++ OBJ geometry parser matches the python parser on cornell."""
    from sycl_ray_tracing import native

    if not native.available():
        pytest.skip("native library not built")
    got = native.parse_obj_geometry(CORNELL_OBJ)
    assert got is not None
    tris, mat_slots, names = got
    ref = parse_obj(CORNELL_OBJ)
    np.testing.assert_allclose(tris, ref.triangles)
    # slot names map 1:1 to usemtl order; resolve to reference material rows
    name_row = {n: i for i, n in enumerate(ref.material_names)}
    rows = np.array([name_row[n] for n in names], np.int32)
    np.testing.assert_array_equal(rows[mat_slots], ref.material_indices)
