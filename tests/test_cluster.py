"""Wavefront cluster tracer vs the brute-force oracle."""

import jax.numpy as jnp
import numpy as np
import pytest

from tests.conftest import CORNELL_OBJ
from sycl_ray_tracing.ops.cluster import (
    any_hit,
    build_clusters,
    closest_hit,
    intersect_clusters,
)
from sycl_ray_tracing.ops.intersect import BIG_T, intersect_triangles
from sycl_ray_tracing.utils.obj_loader import parse_obj


def _random_rays(n, rng, lo=-2.0, hi=2.0):
    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d)


def _check(tris, o, d, p1=None, p2=None):
    B = o.shape[0]
    cs = build_clusters(np.asarray(tris))
    cs = cs.with_budgets(p1 or B * 8, p2 or B * 16)
    oracle = intersect_triangles(o, d, tris)
    t, prim, overflow = closest_hit(cs, o, d)
    assert not bool(overflow), "pair budget overflow"
    np.testing.assert_array_equal(
        np.asarray(prim >= 0), np.asarray(oracle.hit)
    )
    m = np.asarray(oracle.hit)
    np.testing.assert_allclose(
        np.asarray(t)[m], np.asarray(oracle.t)[m], rtol=1e-5
    )
    pm = np.asarray(prim)[m] == np.asarray(oracle.prim)[m]
    if (~pm).any():  # only exact-t ties may differ
        np.testing.assert_allclose(
            np.asarray(t)[m][~pm], np.asarray(oracle.t)[m][~pm], rtol=1e-6
        )
    return cs, oracle


def test_single_triangle():
    tris = jnp.array([[[0.0, 0.0, -2.0], [1.0, 0.0, -2.0], [0.0, 1.0, -2.0]]])
    o = jnp.array([[0.2, 0.2, 0.0], [5.0, 5.0, 0.0]])
    d = jnp.array([[0.0, 0.0, -1.0], [0.0, 0.0, -1.0]])
    _check(tris, o, d)


def test_random_soup():
    rng = np.random.default_rng(0)
    tris = jnp.asarray(rng.uniform(-1, 1, (300, 3, 3)).astype(np.float32))
    o, d = _random_rays(512, rng)
    _check(tris, o, d)


def test_multi_supercluster_scene():
    """>4096 triangles forces several superclusters."""
    rng = np.random.default_rng(5)
    centers = rng.uniform(-10, 10, (10_000, 1, 3)).astype(np.float32)
    tris = jnp.asarray(
        centers + rng.uniform(-0.05, 0.05, (10_000, 3, 3)).astype(np.float32)
    )
    o, d = _random_rays(256, rng, -12, 12)
    _check(tris, o, d)


def test_cornell_rays():
    parsed = parse_obj(CORNELL_OBJ)
    tris = jnp.asarray(parsed.triangles)
    rng = np.random.default_rng(7)
    o = jnp.asarray(
        rng.uniform(-0.4, 0.4, (256, 3)).astype(np.float32)
        + np.array([0.0, 1.0, 0.0], np.float32)
    )
    d = rng.normal(size=(256, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    _check(tris, o, jnp.asarray(d))


def test_any_hit_matches_oracle():
    rng = np.random.default_rng(21)
    tris = jnp.asarray(rng.uniform(-1, 1, (200, 3, 3)).astype(np.float32))
    o, d = _random_rays(256, rng)
    cs = build_clusters(np.asarray(tris)).with_budgets(256 * 8, 256 * 16)
    oracle = intersect_triangles(o, d, tris)
    for tmax_val in (0.5, 2.0, 1e30):
        t_max = jnp.full((256,), tmax_val, jnp.float32)
        blocked, of = any_hit(cs, o, d, t_max)
        assert not bool(of)
        got = np.asarray(blocked)
        want = np.asarray(oracle.hit & (oracle.t + 1e-4 < t_max))
        np.testing.assert_array_equal(got, want)


def test_overflow_flag():
    """Tiny budgets must raise the overflow flag, not crash."""
    rng = np.random.default_rng(2)
    tris = jnp.asarray(rng.uniform(-1, 1, (300, 3, 3)).astype(np.float32))
    o, d = _random_rays(128, rng)
    cs = build_clusters(np.asarray(tris)).with_budgets(4, 4)
    _, _, overflow = closest_hit(cs, o, d)
    assert bool(overflow)


def test_intersect_clusters_hit_record():
    parsed = parse_obj(CORNELL_OBJ)
    tris = jnp.asarray(parsed.triangles)
    rng = np.random.default_rng(9)
    o, d = _random_rays(128, rng, -0.5, 0.5)
    cs = build_clusters(np.asarray(tris)).with_budgets(128 * 8, 128 * 16)
    got = intersect_clusters(cs, tris, o, d)
    oracle = intersect_triangles(o, d, tris)
    np.testing.assert_array_equal(np.asarray(got.hit), np.asarray(oracle.hit))
    m = np.asarray(oracle.hit)
    np.testing.assert_allclose(
        np.asarray(got.point)[m], np.asarray(oracle.point)[m],
        rtol=1e-4, atol=1e-5,
    )
    np.testing.assert_allclose(
        np.asarray(got.normal)[m], np.asarray(oracle.normal)[m],
        rtol=1e-4, atol=1e-5,
    )


def test_sah_order_build():
    """Clustering by the SAH builder's slot order also agrees."""
    from sycl_ray_tracing import native

    if not native.available():
        pytest.skip("native library not built")
    from sycl_ray_tracing.ops.bvh import build_bvh

    rng = np.random.default_rng(31)
    centers = rng.uniform(-5, 5, (3000, 1, 3)).astype(np.float32)
    tris_np = (
        centers + rng.uniform(-0.1, 0.1, (3000, 3, 3)).astype(np.float32)
    )
    bvh = build_bvh(tris_np, method="sah")
    # SAH leaf order: tri_order contains padding duplicates; dedupe keeping
    # first occurrence to form a permutation
    slot = np.asarray(bvh.tri_order)
    seen = np.zeros(3000, bool)
    order = []
    for s in slot:
        if not seen[s]:
            seen[s] = True
            order.append(s)
    order = np.array(order, np.int64)
    tris = jnp.asarray(tris_np)
    o, d = _random_rays(256, rng, -6, 6)
    cs = build_clusters(tris_np, order=order).with_budgets(256 * 8, 256 * 16)
    oracle = intersect_triangles(o, d, tris)
    t, prim, overflow = closest_hit(cs, o, d)
    assert not bool(overflow)
    np.testing.assert_array_equal(np.asarray(prim >= 0), np.asarray(oracle.hit))
    m = np.asarray(oracle.hit)
    np.testing.assert_allclose(
        np.asarray(t)[m], np.asarray(oracle.t)[m], rtol=1e-5
    )


def test_per_call_budgets_match_oracle():
    rng = np.random.default_rng(44)
    centers = rng.uniform(-8, 8, (5000, 1, 3)).astype(np.float32)
    tris = jnp.asarray(
        centers + rng.uniform(-0.08, 0.08, (5000, 3, 3)).astype(np.float32)
    )
    o, d = _random_rays(512, rng, -9, 9)
    cs = build_clusters(np.asarray(tris)).with_budgets(512 * 16, 512 * 32)
    oracle = intersect_triangles(o, d, tris)
    t, prim, overflow = closest_hit(cs, o, d)
    assert not bool(overflow)
    np.testing.assert_array_equal(np.asarray(prim >= 0), np.asarray(oracle.hit))
    m = np.asarray(oracle.hit)
    np.testing.assert_allclose(
        np.asarray(t)[m], np.asarray(oracle.t)[m], rtol=1e-5
    )
    for tmax_val in (1.0, 5.0, 1e30):
        t_max = jnp.full((512,), tmax_val, jnp.float32)
        blocked, of = any_hit(cs, o, d, t_max)
        assert not bool(of)
        got = np.asarray(blocked)
        want = np.asarray(oracle.hit & (oracle.t + 1e-4 < t_max))
        np.testing.assert_array_equal(got, want)


def test_deep_corridor_correct():
    """Rays crossing many clusters in depth must still find the true
    closest hit within the configured budgets."""
    rng = np.random.default_rng(45)
    # long thin corridor of clusters so rays cross many clusters in depth
    tris = []
    for z in range(40):
        block = rng.uniform(-1, 1, (70, 3, 3)).astype(np.float32)
        block[..., 2] = block[..., 2] * 0.3 - 2.0 * z
        tris.append(block)
    tris = jnp.asarray(np.concatenate(tris))
    o = jnp.asarray(
        np.stack(
            [rng.uniform(-0.5, 0.5, 128), rng.uniform(-0.5, 0.5, 128),
             np.full(128, 5.0)], axis=1
        ).astype(np.float32)
    )
    d = jnp.tile(jnp.array([[0.0, 0.0, -1.0]], jnp.float32), (128, 1))
    cs = build_clusters(np.asarray(tris)).with_budgets(128 * 64, 128 * 128)
    oracle = intersect_triangles(o, d, tris)
    t, prim, overflow = closest_hit(cs, o, d)
    assert not bool(overflow)
    m = np.asarray(oracle.hit)
    np.testing.assert_array_equal(np.asarray(prim >= 0), m)
    np.testing.assert_allclose(
        np.asarray(t)[m], np.asarray(oracle.t)[m], rtol=1e-5
    )


def test_fanout_path_matches_oracle_on_mesh():
    """The bounded-fanout fast path agrees with the oracle on a mesh-like
    scene (low children-per-supercluster density)."""
    from sycl_ray_tracing.utils.procedural import dragon_standin

    tris_np = dragon_standin(20_000)
    tris = jnp.asarray(tris_np)
    rng = np.random.default_rng(3)
    o, d = _random_rays(256, rng, -3, 3)
    cs = build_clusters(tris_np).with_budgets(256 * 16, 256 * 48)
    cs = cs.with_fanout(24)
    oracle = intersect_triangles(o, d, tris)
    t, prim, overflow = closest_hit(cs, o, d)
    assert not bool(overflow)
    np.testing.assert_array_equal(np.asarray(prim >= 0), np.asarray(oracle.hit))
    m = np.asarray(oracle.hit)
    np.testing.assert_allclose(
        np.asarray(t)[m], np.asarray(oracle.t)[m], rtol=1e-5
    )


def test_hier_candidates_match_dense_when_no_sc_overflow():
    """candidate_clusters_hier == candidate_clusters whenever no ray block
    hits more than maxs superclusters: same ids, same (quantization-
    granular) entry-t order, same overflow verdict."""
    import jax.numpy as jnp

    from sycl_ray_tracing.ops.cluster import (
        candidate_clusters,
        candidate_clusters_hier,
    )
    from sycl_ray_tracing.utils.procedural import dragon_standin

    tris = dragon_standin(150_000)
    cs = build_clusters(tris)
    rng = np.random.default_rng(5)
    B = 128
    # tight camera bundle: blocks stay within a few superclusters
    o = jnp.asarray(np.tile(np.array([[0.0, 0.2, 3.0]], np.float32),
                            (B, 1)))
    d = np.stack([
        np.linspace(-0.05, 0.05, B),
        np.linspace(-0.03, 0.03, B),
        np.full(B, -1.0),
    ], axis=1).astype(np.float32)
    d = jnp.asarray(d / np.linalg.norm(d, axis=-1, keepdims=True))
    tl = jnp.full((B,), 1e30, jnp.float32)
    maxc = 32
    cd, td, ofd = candidate_clusters(cs, o, d, tl, maxc)
    ch, th, ofh = candidate_clusters_hier(cs, o, d, tl, maxc, maxs=16,
                                          group=8)
    assert not bool(ofh) and not bool(ofd)
    # same candidate SETS in the same nearest-first order; entry-t may
    # differ only by the id-bit quantization granularity
    np.testing.assert_array_equal(np.asarray(cd), np.asarray(ch))
    mask = np.asarray(cd) >= 0
    dt = np.abs(np.asarray(td) - np.asarray(th))[mask]
    assert dt.max() <= np.maximum(np.asarray(td)[mask], 1.0).max() * 2e-3


def test_topk_extraction_matches_minrounds():
    """The approx_min_k extraction path (one fused top-k pass) must match threshold-min extraction EXACTLY on CPU (exact fallback):
    same ids in the same nearest-first order, same entry-ts, same overflow.
    Covers the subnormal-key hazard (quantized entry-t == 0 packs to a
    subnormal float; the +2^23 key bias keeps float order == int order)."""
    import jax.numpy as jnp

    from sycl_ray_tracing.ops import cluster as C
    from sycl_ray_tracing.utils.procedural import dragon_standin

    tris = dragon_standin(50_000)
    cs = C.build_clusters(tris)
    rng = np.random.default_rng(2)
    B = 512
    # surface origins: tnear == 0 (inside own cluster box) is common here
    idx = rng.integers(0, tris.shape[0], B)
    o = jnp.asarray(tris[idx].mean(axis=1))
    d = rng.normal(size=(B, 3)).astype(np.float32)
    d = jnp.asarray(d / np.linalg.norm(d, axis=-1, keepdims=True))
    tl = jnp.full((B,), 1e30, jnp.float32)
    saved = C.EXTRACT_METHOD
    try:
        C.EXTRACT_METHOD = "minrounds"
        ref = C.candidate_clusters(cs, o, d, tl, 32)
        ref_h = C.candidate_clusters_hier(cs, o, d, tl, 32, maxs=16,
                                          group=8)
        C.EXTRACT_METHOD = "topk"
        # exact=True: full recall, where topk's contract is bit-equality
        # with threshold-min (this is what certificate-consuming passes
        # request, listtrace._run)
        got = C.candidate_clusters(cs, o, d, tl, 32, exact=True)
        got_h = C.candidate_clusters_hier(cs, o, d, tl, 32, maxs=16,
                                          group=8, exact=True)
        # approx recall (exact=False) must POISON full rows — a recall
        # miss there is undetectable by counting, so their certificates
        # cannot be trusted (r5 soundness fix)
        ax = C.candidate_clusters(cs, o, d, tl, 32)
    finally:
        C.EXTRACT_METHOD = saved
    np.testing.assert_array_equal(np.asarray(ref[0]), np.asarray(got[0]))
    np.testing.assert_array_equal(np.asarray(ref[1]), np.asarray(got[1]))
    assert bool(ref[2]) == bool(got[2])
    np.testing.assert_array_equal(np.asarray(ref_h[0]), np.asarray(got_h[0]))
    full = np.asarray(ref[0])[:, -1] >= 0
    hit, _ = C._dense_cluster_mask(cs, o, C._inv_dir(d), tl)
    over = np.asarray(hit).sum(axis=1) > 32
    assert over.any()
    assert (np.asarray(ax[1])[over, -1] < 0).all(), (
        "approx extraction must poison count>maxc rows"
    )


def test_membership_certificate_matches_set_oracle():
    """_membership_cert == the set claim it encodes: covered[b] is True
    exactly when every cluster ray b hits is among its block's KEPT union
    ids (exact extraction).  Overlapping random soup + tiny maxc forces
    full unions, so both covered=True-in-a-full-block (the new
    certificates) and covered=False (genuinely dropped clusters) occur."""
    from sycl_ray_tracing.ops import cluster as C

    rng = np.random.default_rng(7)
    tris = rng.uniform(-1, 1, (2000, 3, 3)).astype(np.float32)
    cs = C.build_clusters(tris)
    B, group, maxc = 256, 32, 8
    o, d = _random_rays(B, rng)
    tl = jnp.full((B,), 1e30, jnp.float32)
    cand, ctn, of, covered = C.candidate_clusters_grouped(
        cs, o, d, tl, maxc, group, exact=True, ray_cert=True
    )
    hit, _tn = C._dense_cluster_mask(cs, o, C._inv_dir(d), tl)
    hit = np.asarray(hit)
    candn = np.asarray(cand)
    cov = np.asarray(covered)
    full = candn[:, -1] >= 0
    assert full.any(), "workload must produce full unions"
    want = np.zeros(B, bool)
    for b in range(B):
        kept = set(candn[b // group][candn[b // group] >= 0].tolist())
        mine = set(np.nonzero(hit[b])[0].tolist())
        want[b] = mine <= kept
    np.testing.assert_array_equal(cov, want)
    # the whole point: some rays in FULL blocks are certified...
    full_rays = np.repeat(full, group)
    assert (cov & full_rays).any()
    # ...and some are not (their own clusters were dropped)
    assert (~cov & full_rays).any()


def test_membership_certificate_hier_grouped():
    """Same set oracle through the supercluster-prefiltered grouped build:
    covered == (ray's global hit clusters subset of kept global ids) for
    non-SC-overflow blocks, and False everywhere a block's SC list
    truncated (those rays may be missing whole superclusters)."""
    from sycl_ray_tracing.ops import cluster as C
    from sycl_ray_tracing.utils.procedural import dragon_standin

    tris = dragon_standin(60_000)
    cs = C.build_clusters(tris)
    rng = np.random.default_rng(13)
    B, group, maxc, maxs = 256, 32, 16, 4   # tiny maxs: some sc_of blocks
    o, d = _random_rays(B, rng, -3, 3)
    # first half: a tight coherent bundle (small unions -> certifiable)
    o = np.array(o)
    d = np.array(d)
    h = B // 2
    o[:h] = np.array([0.0, 0.2, 3.0], np.float32)
    dd = np.stack([
        np.linspace(-0.02, 0.02, h),
        np.linspace(-0.01, 0.01, h),
        np.full(h, -1.0),
    ], axis=1).astype(np.float32)
    d[:h] = dd / np.linalg.norm(dd, axis=-1, keepdims=True)
    o, d = jnp.asarray(o), jnp.asarray(d)
    tl = jnp.full((B,), 1e30, jnp.float32)
    cand, ctn, of, covered = C.candidate_clusters_hier(
        cs, o, d, tl, maxc, maxs=maxs, group=group, grouped=True,
        exact=True, ray_cert=True
    )
    cov = np.asarray(covered)
    candn = np.asarray(cand)
    # oracle SC overflow per block
    m1, _ = C._dense_box_mask(cs.sc_box, o, C._inv_dir(d), tl)
    m1 = np.asarray(m1)
    nb = B // group
    sc_of = m1.reshape(nb, group, -1).any(axis=1).sum(axis=1) > maxs
    hit, _tn = C._dense_cluster_mask(cs, o, C._inv_dir(d), tl)
    hit = np.asarray(hit)
    for b in range(B):
        blk = b // group
        if sc_of[blk]:
            assert not cov[b]
            continue
        kept = set(candn[blk][candn[blk] >= 0].tolist())
        mine = set(np.nonzero(hit[b])[0].tolist())
        assert cov[b] == (mine <= kept)
    assert sc_of.any(), "workload must exercise the SC-overflow poisoning"
    assert cov.any() and not cov.all()
