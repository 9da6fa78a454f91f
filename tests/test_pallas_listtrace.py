"""List tracer (Pallas kernels) vs the brute-force oracle.

Runs the kernels in Pallas's interpreter on the CPU (conftest sets
listtrace.INTERPRET); tests/test_gpu.py runs the compiled kernels on the
card.  Capability parity: flattened-BVH traversal closest/any-hit
(flattened_bvh.cpp:10-58), rebuilt as candidate lists + a list kernel.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from sycl_ray_tracing.ops.cluster import BIG_T, build_clusters
from sycl_ray_tracing.ops.intersect import intersect_triangles
from sycl_ray_tracing.ops.pallas.listtrace import (
    any_hit,
    closest_hit,
    intersect_list,
    supports,
)


def _random_rays(n, rng, lo=-2.0, hi=2.0):
    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d)


@pytest.mark.parametrize("share", [False, True])
@pytest.mark.parametrize("n_tris,n_rays", [(40, 64), (500, 300), (2000, 257)])
def test_closest_hit_matches_oracle(n_tris, n_rays, share):
    rng = np.random.default_rng(n_tris)
    tris_np = rng.uniform(-1, 1, (n_tris, 3, 3)).astype(np.float32)
    tris = jnp.asarray(tris_np)
    cs = build_clusters(tris_np)
    assert supports(cs)
    o, d = _random_rays(n_rays, rng)
    oracle = intersect_triangles(o, d, tris)
    t, prim, overflow = closest_hit(cs, o, d, share=share)
    assert not bool(overflow)
    m = np.asarray(oracle.hit)
    np.testing.assert_array_equal(np.asarray(prim >= 0), m)
    np.testing.assert_array_equal(
        np.asarray(prim)[m], np.asarray(oracle.prim)[m]
    )
    np.testing.assert_allclose(
        np.asarray(t)[m], np.asarray(oracle.t)[m], rtol=1e-4, atol=1e-6
    )


@pytest.mark.parametrize("share", [False, True])
def test_any_hit_matches_oracle(share):
    rng = np.random.default_rng(3)
    tris_np = rng.uniform(-1, 1, (400, 3, 3)).astype(np.float32)
    cs = build_clusters(tris_np)
    o, d = _random_rays(256, rng)
    oracle = intersect_triangles(o, d, jnp.asarray(tris_np))
    m = np.asarray(oracle.hit)
    for tm in (0.5, 2.0, 1e30):
        t_max = jnp.full((256,), tm, jnp.float32)
        got, _of = any_hit(cs, o, d, t_max, share=share)
        want = m & (np.asarray(oracle.t) + 1e-4 < tm)
        np.testing.assert_array_equal(np.asarray(got), want)


@pytest.mark.parametrize("share", [False, True])
def test_golden_rays_through_list_tracer(cornell_scene, share):
    """The closed-form golden rays (tests/test_golden_rays.py) through the
    kernel."""
    from tests.test_golden_rays import _golden_data

    hit_rays, expected_pts, _wall, miss_rays = _golden_data()
    tris = np.asarray(cornell_scene.triangles)
    cs = build_clusters(tris)
    o = jnp.asarray(hit_rays[:, :3])
    d = jnp.asarray(hit_rays[:, 3:])
    t, prim, _of = closest_hit(cs, o, d, share=share)
    t = np.asarray(t)
    assert (t < BIG_T).all()
    pts = hit_rays[:, :3] + t[:, None] * hit_rays[:, 3:]
    assert np.abs(pts - expected_pts).max() < 1e-5
    t_m, prim_m, _of = closest_hit(
        cs, jnp.asarray(miss_rays[:, :3]), jnp.asarray(miss_rays[:, 3:]),
        share=share,
    )
    assert (np.asarray(t_m) >= BIG_T).all()
    assert (np.asarray(prim_m) < 0).all()


@pytest.mark.parametrize("share", [False, True])
def test_mesh_scene_matches_oracle(share):
    from sycl_ray_tracing.utils.procedural import dragon_standin

    tris_np = dragon_standin(8_000)
    tris = jnp.asarray(tris_np)
    cs = build_clusters(tris_np)
    rng = np.random.default_rng(11)
    o, d = _random_rays(512, rng, -3, 3)
    oracle = intersect_triangles(o, d, tris)
    t, prim, of, res = closest_hit(cs, o, d, share=share,
                                   with_resolved=True)
    m = np.asarray(oracle.hit)
    r = np.asarray(res)
    if not bool(of):
        assert r.all()
    # exactness contract: certified rays match the oracle exactly; only
    # uncertified rays (random 32-ray unions can overflow maxc in share
    # mode — flagged) may drop hits
    assert r.mean() > 0.9
    mr = m & r
    np.testing.assert_array_equal(np.asarray(prim >= 0)[r], m[r])
    np.testing.assert_allclose(
        np.asarray(t)[mr], np.asarray(oracle.t)[mr], rtol=1e-4, atol=1e-6
    )


def test_auto_backend_resolves_to_list():
    """intersect="auto" must select the list tracer on a GPU whenever the
    clustered scene fits its packing — like the reference's USE_BVH
    default-on (render_kernel.h:13) — and degrade cleanly when the scene
    exceeds the list tracer's limits."""
    import dataclasses

    from sycl_ray_tracing.models.pathtracer import _resolve_backend
    from sycl_ray_tracing.utils.procedural import dragon_scene

    scene = dragon_scene(n_tris=4_000, build_accel=True)
    assert supports(scene.clusters)
    assert _resolve_backend(scene, "auto", platform="gpu") == "list"
    # elsewhere auto takes the XLA tracer (the list kernels compile only
    # for a GPU)
    assert _resolve_backend(scene, "auto", platform="cpu") == "cluster"
    # oversized scene (faked cap breach): auto/list degrade to cluster
    big = scene.with_clusters(
        dataclasses.replace(
            scene.clusters,
            cl_tris=jnp.zeros((9000, scene.clusters.cl_tris.shape[1]),
                              jnp.float32),
        )
    )
    assert _resolve_backend(big, "auto", platform="gpu") == "cluster"
    assert _resolve_backend(big, "list") == "cluster"
    # no clusters at all: fall back to bvh/brute
    none = scene.with_clusters(None)
    assert _resolve_backend(none, "auto", platform="gpu") in ("bvh", "brute")


def test_overflow_flag_when_maxc_too_small():
    """The overflow flag is HONEST: it fires iff some live ray's answer is
    uncertified (a certificate-proven frame reports False even when
    candidate lists filled up)."""
    from sycl_ray_tracing.utils.procedural import dragon_standin

    tris_np = dragon_standin(8_000)
    cs = build_clusters(tris_np)
    rng = np.random.default_rng(9)
    o, d = _random_rays(256, rng, -3, 3)
    # maxc=1 on a dense mesh: rays crossing >1 cluster box whose best hit
    # lies past the first cluster's entry-t cannot certify
    t, p, overflow, resolved = closest_hit(cs, o, d, maxc=1,
                                           with_resolved=True)
    r = np.asarray(resolved)
    assert not r.all()                      # the workload genuinely fails
    assert bool(overflow)                   # ... and the flag says so
    # flag == any(~resolved): the contract main.py's regrow relies on
    assert bool(overflow) == bool((~r).any())
    # deep lists: everything certifies, flag goes quiet
    t2, p2, of2, res2 = closest_hit(cs, o, d, maxc=48, with_resolved=True)
    assert np.asarray(res2).all()
    assert not bool(of2)


def test_share_escalation_is_exact():
    """Share mode + escalation = exact: random incoherent rays (whose
    32-ray block unions badly overflow any maxc — the round-3 blocker)
    must now match the brute oracle ray-for-ray, because every
    uncertified ray is re-run through a per-ray pass.
    """
    from sycl_ray_tracing.utils.procedural import dragon_standin

    tris_np = dragon_standin(12_000)
    tris = jnp.asarray(tris_np)
    cs = build_clusters(tris_np)
    rng = np.random.default_rng(31)
    o, d = _random_rays(512, rng, -3, 3)
    oracle = intersect_triangles(o, d, tris)
    t, prim, of, res = closest_hit(cs, o, d, share=True,
                                   with_resolved=True)
    m = np.asarray(oracle.hit)
    r = np.asarray(res)
    # escalation must certify (nearly) everything this workload throws
    assert r.mean() > 0.99
    np.testing.assert_array_equal(np.asarray(prim >= 0)[r], m[r])
    mr = m & r
    np.testing.assert_array_equal(
        np.asarray(prim)[mr], np.asarray(oracle.prim)[mr]
    )
    np.testing.assert_allclose(
        np.asarray(t)[mr], np.asarray(oracle.t)[mr], rtol=1e-4, atol=1e-6
    )
    # the honest flag mirrors the certificates exactly
    assert bool(of) == bool((~r).any())

    # any-hit: blocked answers are certain even without certificates
    tmax = jnp.full((512,), 2.0, jnp.float32)
    blocked, _of2 = any_hit(cs, o, d, tmax, share=True)
    want = m & (np.asarray(oracle.t) + 1e-4 < 2.0)
    np.testing.assert_array_equal(np.asarray(blocked), want)


def test_list_maxc_regrow_restores_exactness():
    """The overflow auto-regrow contract main.py relies on: a render at a too-shallow candidate depth flags overflow;
    regrowing ClusterScene.list_maxc (the list backend's REAL knob, not
    the p1/p2 pair budgets the tracer ignores) yields a certified,
    brute-exact render."""
    import jax

    from sycl_ray_tracing.models import pathtracer
    from sycl_ray_tracing.models.camera import pbrt_dragon_camera
    from sycl_ray_tracing.utils.config import RenderConfig
    from sycl_ray_tracing.utils.procedural import dragon_scene

    # no sky + 2 bounces: keeps the interpret-mode kernel-compile count
    # low (the full suite in one process trips an upstream XLA-CPU
    # backend_compile segfault, pytest.ini)
    scene = dragon_scene(n_tris=3_000, with_sky=False)
    cam = pbrt_dragon_camera()
    key = jax.random.PRNGKey(5)

    def frame(s, backend):
        cfg = RenderConfig(width=16, height=16, samples=1, bounces=2,
                           intersect=backend, tile_rays=None,
                           estimator="shared")
        return pathtracer.render(s, cam, cfg, key, with_aux=True)

    # force uncertified rays: candidate depth 1
    shallow = scene.with_clusters(scene.clusters.with_list_maxc(1))
    img1, aux1 = frame(shallow, "list")
    assert bool(aux1["overflow"])
    # regrown depth: certified, flag quiet, matches brute exactly
    deep = scene.with_clusters(scene.clusters.with_list_maxc(64))
    img2, aux2 = frame(deep, "list")
    assert not bool(aux2["overflow"])
    ref, _ = frame(scene, "brute")
    np.testing.assert_allclose(np.asarray(img2), np.asarray(ref),
                               rtol=2e-4, atol=2e-5)


def test_hit_record_finalize():
    rng = np.random.default_rng(5)
    tris_np = rng.uniform(-1, 1, (200, 3, 3)).astype(np.float32)
    tris = jnp.asarray(tris_np)
    cs = build_clusters(tris_np)
    o, d = _random_rays(128, rng)
    of = []
    hit = intersect_list(cs, tris, o, d, of)
    oracle = intersect_triangles(o, d, tris)
    np.testing.assert_array_equal(np.asarray(hit.hit), np.asarray(oracle.hit))
    m = np.asarray(oracle.hit)
    np.testing.assert_allclose(
        np.asarray(hit.point)[m], np.asarray(oracle.point)[m],
        rtol=1e-4, atol=1e-5,
    )
    assert len(of) == 1


def test_mask_bucketing_matches_unmasked_on_live_lanes():
    """Dead-lane pruning (mask + bucketed grids): live lanes return the
    same hits as an unmasked run; dead lanes report clean misses."""
    from sycl_ray_tracing.utils.procedural import dragon_standin

    tris_np = dragon_standin(4_000)
    cs = build_clusters(tris_np)
    rng = np.random.default_rng(21)
    B = 512
    idx = rng.integers(0, tris_np.shape[0], B)
    o = jnp.asarray(
        tris_np[idx].mean(axis=1)
        + rng.normal(0, 0.05, (B, 3)).astype(np.float32)
    )
    d = rng.normal(size=(B, 3)).astype(np.float32)
    d = jnp.asarray(d / np.linalg.norm(d, axis=-1, keepdims=True))
    for live_frac in (0.1, 0.6):
        mask = jnp.asarray(rng.random(B) < live_frac)
        t_m, p_m, _ = closest_hit(cs, o, d, mask=mask)
        t_u, p_u, _ = closest_hit(cs, o, d)
        m = np.asarray(mask)
        np.testing.assert_array_equal(np.asarray(p_m)[m],
                                      np.asarray(p_u)[m])
        np.testing.assert_allclose(np.asarray(t_m)[m],
                                   np.asarray(t_u)[m], rtol=1e-6)
        assert (np.asarray(p_m)[~m] == -1).all()
        assert (np.asarray(t_m)[~m] >= BIG_T).all()

        tmax = jnp.full((B,), 2.0)
        b_m, _ = any_hit(cs, o, d, tmax, mask=mask)
        b_u, _ = any_hit(cs, o, d, tmax)
        np.testing.assert_array_equal(np.asarray(b_m)[m],
                                      np.asarray(b_u)[m])
        assert not np.asarray(b_m)[~m].any()


@pytest.mark.parametrize("share", [False, True])
def test_multi_query_mixed_anyhit(share):
    """Fused queries with any-hit flags: occlusion answers stay exact even
    though flagged rays may early-exit once blocked."""
    from sycl_ray_tracing.ops.pallas.listtrace import (
        multi_query,
        packed_to_prim,
    )
    from sycl_ray_tracing.utils.procedural import dragon_standin

    tris_np = dragon_standin(4_000)
    tris = jnp.asarray(tris_np)
    cs = build_clusters(tris_np)
    rng = np.random.default_rng(7)
    B = 256
    o, d = _random_rays(B, rng, -3, 3)
    o2, d2 = _random_rays(B, rng, -3, 3)
    tmax = jnp.full((B,), 2.5, jnp.float32)
    res, _of = multi_query(
        cs,
        [
            (o, d, None, None, False),           # closest-hit
            (o2, d2, tmax - 1e-4, None, True),   # occlusion, early-exit
        ],
        share=share,
    )
    oracle = intersect_triangles(o, d, tris)
    t, prim = packed_to_prim(cs, *res[0])
    m = np.asarray(oracle.hit)
    np.testing.assert_array_equal(np.asarray(prim >= 0), m)
    np.testing.assert_allclose(
        np.asarray(t)[m], np.asarray(oracle.t)[m], rtol=1e-4, atol=1e-6
    )
    oracle2 = intersect_triangles(o2, d2, tris)
    want_blocked = np.asarray(oracle2.hit) & (
        np.asarray(oracle2.t) + 1e-4 < 2.5
    )
    np.testing.assert_array_equal(np.asarray(res[1][1] >= 0), want_blocked)


@pytest.mark.parametrize("share", [False, True])
def test_large_scene_beyond_2048_clusters(share):
    """Scenes past 2048 clusters (262k tris) run the list path: the
    13-bit candidate-id packing holds the ~870k-tri flagship scale.
    300k tris = 2344
    clusters exercises the >11-bit id path against the brute oracle."""
    from sycl_ray_tracing.utils.procedural import dragon_standin

    tris_np = dragon_standin(300_000)
    tris = jnp.asarray(tris_np)
    cs = build_clusters(tris_np)
    assert cs.num_clusters > 2048
    assert supports(cs)
    # camera-like bundle; exactness contract: every ray the tracer
    # CERTIFIES as resolved must match the oracle exactly — overflow may
    # drop hits only on uncertified rays (the knot stand-in's depth
    # complexity makes block unions exceed any fixed maxc; overflow is
    # the flagged, certified-degradation condition by design)
    rng = np.random.default_rng(13)
    n = 256
    o = jnp.asarray(
        np.tile(np.array([[0.0, 0.3, 3.5]], np.float32), (n, 1))
    )
    gx, gy = np.meshgrid(np.linspace(-0.7, 0.7, 16),
                         np.linspace(-0.6, 0.4, 16))
    d = np.stack(
        [gx.ravel(), gy.ravel(), np.full(n, -1.0)], axis=1
    ).astype(np.float32)
    d += rng.normal(0, 0.01, d.shape).astype(np.float32)
    d = jnp.asarray(d / np.linalg.norm(d, axis=-1, keepdims=True))
    oracle = intersect_triangles(o, d, tris)
    t, prim, of, resolved = closest_hit(cs, o, d, maxc=64, share=share,
                                        with_resolved=True)
    m = np.asarray(oracle.hit)
    r = np.asarray(resolved)
    assert m.sum() > n // 2      # the bundle actually hits the mesh
    # rays must still certify even if some overflow (this 16x16 bundle is
    # ~5 deg between rays — far sparser than real pixels, so share-mode
    # 32-ray unions overflow more than a real render's would)
    assert r.mean() > (0.3 if share else 0.6)
    if not bool(of):
        assert r.all()
    mr = m & r
    np.testing.assert_array_equal(np.asarray(prim >= 0)[r], m[r])
    np.testing.assert_array_equal(
        np.asarray(prim)[mr], np.asarray(oracle.prim)[mr]
    )
    np.testing.assert_allclose(
        np.asarray(t)[mr], np.asarray(oracle.t)[mr], rtol=1e-4, atol=1e-6
    )


def test_membership_cert_sound_without_escalation():
    """Certificate soundness with escalation OFF: every ray the tracer
    marks resolved must match the brute oracle exactly — including rays
    in FULL union blocks, which only the per-ray MEMBERSHIP certificate
    (cluster._membership_cert) can certify.  Also pins that the main pass
    uses EXACT extraction, so a full block's certificates can never be
    poisoned by an approx-recall miss.

    The any-hit half is the perf-critical case: unblocked occlusion rays
    with t_lim=BIG can never satisfy the distance certificate in a full
    block (tmin == t_lim > ctn_last), so any resolved=True there proves
    the membership certificate fired — and must agree with the oracle."""
    import sycl_ray_tracing.ops.pallas.listtrace as L
    from sycl_ray_tracing.utils.procedural import dragon_standin

    tris_np = dragon_standin(12_000)
    tris = jnp.asarray(tris_np)
    cs = build_clusters(tris_np)
    rng = np.random.default_rng(17)
    B = 512
    o, d = _random_rays(B, rng, -3, 3)
    oracle = intersect_triangles(o, d, tris)
    m = np.asarray(oracle.hit)

    # closest-hit without escalation, 16-slot unions (forces full ones):
    # certified rays are bit-true vs the oracle
    tl = jnp.full((B,), BIG_T, jnp.float32)
    t, packed, res, of = L._run(cs, o, d, tl, 16, any_hit=False,
                                share=True, escalate=False)
    t, prim = L.packed_to_prim(cs, t, packed)
    r = np.asarray(res)
    assert r.any() and not r.all()          # workload exercises both
    assert bool(of)                         # honest flag: uncertified rays
    np.testing.assert_array_equal(np.asarray(prim >= 0)[r], m[r])
    mr = m & r
    np.testing.assert_array_equal(
        np.asarray(prim)[mr], np.asarray(oracle.prim)[mr]
    )
    np.testing.assert_allclose(
        np.asarray(t)[mr], np.asarray(oracle.t)[mr], rtol=1e-4, atol=1e-6
    )

    # any-hit with unbounded t_lim: unblocked+resolved can only come from
    # the membership certificate; each one must truly be a miss
    t2, packed2, res2, of2 = L._run(
        cs, o, d, tl, 16, any_hit=True, share=True, escalate=False
    )
    blocked = np.asarray(packed2 >= 0)
    r2 = np.asarray(res2)
    unb_cert = r2 & ~blocked
    assert unb_cert.any(), "membership certificate never fired"
    np.testing.assert_array_equal(blocked[r2], m[r2])
