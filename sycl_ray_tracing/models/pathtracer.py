"""The path-tracing integrator: a wavefront over flat ray batches.

Redesign of the reference's per-pixel recursive loop
(render_kernel.cpp:75-181):

  * the bounce loop is a ``lax.scan`` carrying {ray, throughput, radiance,
    alive} for a whole batch of rays — per-ray control flow (the reference's
    BOUNCE/MISSED/TERMINATED state machine, :96-161) becomes alive-masks
  * the sample loop is a ``lax.scan`` with linear HDR accumulation
  * RNG is counter-based threefry keyed (pixel-batch, sample, bounce,
    purpose) — replayable in the backward pass, replacing stateful xorshift
    (xorshift.h:10-31, seeded :77-82)

Semantics preserved per bounce (reference :96-161):
  * emissive-triangle NEE with two-sided power-heuristic MIS (:633-713)
  * env-map NEE with two-sided MIS (:569-631)
  * GGX-importance-sampled continuation; throughput *= brdf*cos/pdf (:137)
  * kill on black brdf / degenerate pdf (:130-135)
  * continuation origin offset 1e-4 * normal (:139)
  * emission added only at bounce 0 (:126-127)
  * env radiance on miss only for primary rays (:146-158)
  * no Russian roulette

The whole function is differentiable w.r.t. scene materials, env-map texels
and camera pose.  Sampled directions are differentiable too (reparameterized
gradients); pdfs in MIS weights are kept differentiable so jax.grad equals
the finite difference of this very program at matched seeds.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from sycl_ray_tracing.models.camera import Camera
from sycl_ray_tracing.models.scene import Scene
from sycl_ray_tracing.ops import envmap as env_ops
from sycl_ray_tracing.ops.brdf import (
    cook_torrance_eval,
    cook_torrance_pdf,
    ggx_importance_sample,
)
from sycl_ray_tracing.ops.intersect import (
    Hit,
    finalize_hit,
    intersect_spheres,
    intersect_triangles,
    merge_hits,
)
from sycl_ray_tracing.ops.safe_math import RAY_OFFSET, dot
from sycl_ray_tracing.ops.sampling import power_heuristic, sample_triangle_uniform
from sycl_ray_tracing.utils.config import RenderConfig

# Remat policy for the bounce/sample scan bodies: save traversal outputs
# (tagged ISECT_NAME by every backend — ops/intersect.py name_traversal) as
# residuals so the backward pass replays SHADING ONLY.  Traversal is under
# stop_gradient and contributes nothing to the VJP; without this policy the
# replay would re-run the intersection kernels.
_REMAT_POLICY = jax.checkpoint_policies.save_only_these_names("isect")


def _remat(body):
    return jax.checkpoint(body, prevent_cse=False, policy=_REMAT_POLICY)


# Use the block-shared list kernel for trace_shared's PRIMARY rays (always
# coherent); None falls back to the list tracer's own default.
PRIMARY_SHARE = True

# purpose tags for key folding — one stream per random decision
_JITTER = 0
_LIGHT = 1       # light pick + area sample (3 uniforms)
_NEE_BRDF = 2    # GGX sample for the light-MIS brdf term (2)
_ENV = 3         # env CDF row/col (2)
_ENV_BRDF = 4    # GGX sample for the env-MIS brdf term (2)
_CONT = 5        # GGX sample for the continuation ray (2)


def _uniforms(key, bounce, tag, shape):
    k = jax.random.fold_in(jax.random.fold_in(key, bounce), tag)
    return jax.random.uniform(k, shape, jnp.float32)


def _resolve_backend(scene: Scene, backend: str,
                     platform: str | None = None) -> str:
    """"auto" picks the fastest structure the scene and the device allow:
    on a GPU, the list tracer whenever the clustered scene fits its
    packing (ops/pallas/listtrace.py, about 3-4x faster than the XLA
    cluster tracer on the dragon frames, PERF.md); elsewhere, or past that
    limit, the XLA cluster tracer (the list kernels compile only for a
    GPU); without clusters the lockstep BVH, then brute force — like the
    reference's USE_BVH default-on (render_kernel.h:13).  An explicit
    "list" on a scene past the list tracer's limit degrades to the
    cluster tracer instead of raising."""
    from sycl_ray_tracing.ops.pallas.listtrace import supports

    if backend == "auto":
        if platform is None:
            platform = jax.default_backend()
        if scene.clusters is not None:
            backend = "list" if platform == "gpu" else "cluster"
        elif scene.bvh is not None:
            backend = "bvh"
        else:
            backend = "brute"
    if backend == "list":
        if scene.clusters is None or not supports(scene.clusters):
            backend = "cluster" if scene.clusters is not None else "brute"
    return backend


def intersect_scene(scene: Scene, ray_o, ray_d, backend: str = "auto",
                    of: list | None = None, mask=None,
                    list_share=None) -> Hit:
    """Closest-hit dispatch (reference INTERSECT_SCENE,
    render_kernel.cpp:504-511): list tracer, wavefront clusters, lockstep
    BVH, or brute-force triangles, plus brute-force spheres (:485-502).  Sphere hits get primitive index N + sphere_id.

    ``of``: optional overflow collector — cluster-backend pair-budget
    overflow flags are appended so the render API can report them instead
    of silently dropping hits.
    ``mask``: optional [B] bool — False lanes are dead paths whose result
    is unused; backends that support pruning (list) return a miss for
    them at ~zero cost, others just ignore the hint."""
    backend = _resolve_backend(scene, backend)
    if backend == "list":
        from sycl_ray_tracing.ops.pallas.listtrace import intersect_list

        hit = intersect_list(scene.clusters, scene.triangles, ray_o, ray_d,
                             of, mask=mask, share=list_share)
    elif backend == "cluster":
        from sycl_ray_tracing.ops.cluster import intersect_clusters

        hit = intersect_clusters(
            scene.clusters, scene.triangles, ray_o, ray_d, of
        )
    elif backend == "bvh":
        from sycl_ray_tracing.ops.bvh import intersect_bvh

        hit = intersect_bvh(scene.bvh, scene.triangles, ray_o, ray_d)
    else:
        hit = intersect_triangles(ray_o, ray_d, scene.triangles)
    if scene.num_spheres > 0:
        n = scene.num_triangles
        sphere_prim = n + jnp.arange(scene.num_spheres, dtype=jnp.int32)
        s_hit = intersect_spheres(
            ray_o, ray_d, scene.sphere_centers, scene.sphere_radii, sphere_prim
        )
        hit = merge_hits(hit, s_hit)
    return hit


def _merge_sphere_occlusion(scene: Scene, ray_o, ray_d, t_max, blocked):
    """OR in sphere occlusion (brute-force, like the reference's sphere
    loop in intersect_scene, render_kernel.cpp:485-502) with the same
    1e-4 shadow slack the triangle paths use."""
    if scene.num_spheres == 0:
        return blocked
    n = scene.num_triangles
    sphere_prim = n + jnp.arange(scene.num_spheres, dtype=jnp.int32)
    s_hit = intersect_spheres(
        ray_o, ray_d, scene.sphere_centers, scene.sphere_radii, sphere_prim
    )
    return blocked | (s_hit.hit & (s_hit.t + 1e-4 < t_max))


def occluded(scene: Scene, ray_o, ray_d, t_max=None, backend: str = "auto",
             of: list | None = None, mask=None):
    """Shadow-ray test with the reference's t_max - 1e-4 slack
    (evaluate_shadow_ray, render_kernel.cpp:744-759).  ``t_max=None`` means
    "blocked at any distance" (env-map MIS rays).  Uses the cheap any-hit
    BVH walk when available — shadow rays don't need the closest hit."""
    from sycl_ray_tracing.ops.intersect import BIG_T as _BIG

    if t_max is None:
        t_max = jnp.full(ray_o.shape[:1], _BIG, ray_o.dtype)
    backend = _resolve_backend(scene, backend)
    o_ng = jax.lax.stop_gradient(ray_o)
    d_ng = jax.lax.stop_gradient(ray_d)
    t_ng = jax.lax.stop_gradient(t_max)
    if backend == "list":
        from sycl_ray_tracing.ops.pallas.listtrace import (
            any_hit as list_any,
        )

        blocked, overflow = list_any(scene.clusters, o_ng, d_ng, t_ng,
                                     mask=mask)
        if of is not None:
            of.append(overflow)
    elif backend == "cluster":
        from sycl_ray_tracing.ops.cluster import any_hit as cluster_any

        blocked, overflow = cluster_any(scene.clusters, o_ng, d_ng, t_ng)
        if of is not None:
            of.append(overflow)
    elif backend == "bvh":
        from sycl_ray_tracing.ops.bvh import any_hit

        blocked = any_hit(scene.bvh, o_ng, d_ng, t_ng)
    else:
        # brute backend: dense any-hit (no argmin / hit-record finalize)
        from sycl_ray_tracing.ops.intersect import any_hit_triangles

        blocked = any_hit_triangles(ray_o, ray_d, scene.triangles,
                                    t_max - 1e-4)
    return _merge_sphere_occlusion(scene, ray_o, ray_d, t_max, blocked)


def _material_of_prim(scene: Scene, prim):
    """Material row for a primitive index ([0,N) triangles, [N,N+S) spheres)."""
    n = scene.num_triangles
    tri_mat = scene.material_indices[jnp.clip(prim, 0, n - 1)]
    if scene.num_spheres > 0:
        sph_mat = scene.sphere_material[
            jnp.clip(prim - n, 0, scene.num_spheres - 1)
        ]
        return jnp.where(prim < n, tri_mat, sph_mat)
    return tri_mat


def _sample_lights_nee(scene, backend, hit, view, diffuse, metal, rough, key, bounce,
                       of=None, live=None, ggx_bug=False):
    """Direct lighting from emissive triangles, both MIS terms
    (reference sample_light_sources, render_kernel.cpp:633-713).
    ``live``: optional [B] mask of lanes whose result is consumed — dead
    lanes' scene queries are pruned (see intersect_scene)."""
    if live is None:
        live = hit.hit
    B = hit.t.shape[0]
    num_lights = scene.num_lights
    radiance = jnp.zeros((B, 3), jnp.float32)
    if num_lights == 0:
        return radiance

    u = _uniforms(key, bounce, _LIGHT, (B, 3))

    # --- light-sample term ---
    pick = jnp.minimum((u[:, 0] * num_lights).astype(jnp.int32), num_lights - 1)
    light_tri_idx = scene.emissive_indices[pick]
    tri = scene.triangles[light_tri_idx]                       # [B,3,3]
    lp, ln, area = sample_triangle_uniform(
        tri[:, 0], tri[:, 1], tri[:, 2], u[:, 1], u[:, 2]
    )
    pdf_area = 1.0 / jnp.maximum(num_lights * area, 1e-12)

    origin = hit.point + hit.normal * RAY_OFFSET
    to_light = lp - origin
    dist = jnp.linalg.norm(to_light, axis=-1)
    wi = to_light / jnp.maximum(dist, 1e-12)[..., None]

    cos_light = jnp.maximum(0.0, dot(ln, -wi))
    front = cos_light > 0.0
    cos_surf = dot(hit.normal, wi)
    shadowed = occluded(scene, origin, wi, dist, backend, of,
                        mask=live & hit.hit & front & (cos_surf > 0.0))

    # sanitize masked lanes BEFORE arithmetic: a cos_light ~ 0 lane makes
    # light_pdf explode; even though the contribution is where-masked out,
    # inf/NaN intermediates poison the backward pass (NaN*0 = NaN)
    light_pdf = pdf_area * dist * dist / jnp.maximum(cos_light, 1e-6)
    light_pdf = jnp.where(front, light_pdf, 1.0)
    light_emission = scene.materials.emission[
        _material_of_prim(scene, light_tri_idx)
    ]
    brdf = cook_torrance_eval(diffuse, metal, rough, wi, view, hit.normal)
    brdf_pdf = cook_torrance_pdf(rough, view, wi, hit.normal)
    mis_w = power_heuristic(light_pdf, brdf_pdf)
    contrib = (
        light_emission
        * (cos_surf * mis_w / jnp.maximum(light_pdf, 1e-12))[..., None]
        * brdf
    )
    ok = hit.hit & front & (~shadowed) & (brdf_pdf != 0.0) & (cos_surf > 0.0)
    radiance = radiance + jnp.where(ok[..., None], contrib, 0.0)

    # --- brdf-sample term: did a GGX-sampled ray hit an emitter? ---
    ub = _uniforms(key, bounce, _NEE_BRDF, (B, 2))
    brdf_s, wi_s, pdf_s = ggx_importance_sample(
        diffuse, metal, rough, view, hit.normal, ub[:, 0], ub[:, 1],
        reference_bug=ggx_bug,
    )
    origin_s = hit.point + hit.normal * 1e-5  # reference uses 1e-5 here (:684)
    h2 = intersect_scene(
        scene, origin_s, wi_s, backend, of,
        mask=live & hit.hit & (pdf_s > 0.0) & jnp.any(brdf_s > 0.0, axis=-1),
    )
    n_tris = scene.num_triangles
    cos_at_light = jnp.maximum(0.0, dot(h2.normal, -wi_s))
    hit_mat = _material_of_prim(scene, h2.prim)
    hit_emission = scene.materials.emission[hit_mat]
    is_emitter = jnp.any(hit_emission > 0.0, axis=-1) & (h2.prim < n_tris)

    from sycl_ray_tracing.ops.sampling import triangle_area

    light_area2 = triangle_area(scene.triangles[jnp.clip(h2.prim, 0, n_tris - 1)])
    # h2.t is the BIG_T sentinel on miss — squaring it overflows float32 to
    # inf and NaN-poisons the backward pass; sanitize missed lanes first
    t2_safe = jnp.where(h2.hit, h2.t, 1.0)
    light_pdf2 = (t2_safe * t2_safe) / jnp.maximum(
        light_area2 * cos_at_light, 1e-6
    )
    light_pdf2 = jnp.where(h2.hit & (cos_at_light > 0.0), light_pdf2, 1.0)
    mis_w2 = power_heuristic(pdf_s, light_pdf2)
    cos_surf2 = dot(hit.normal, wi_s)
    contrib2 = (
        brdf_s
        * hit_emission
        * (cos_surf2 * mis_w2 / jnp.maximum(pdf_s, 1e-12))[..., None]
    )
    ok2 = (
        hit.hit
        & h2.hit
        & is_emitter
        & (cos_at_light > 0.0)
        & (pdf_s > 0.0)
        & jnp.any(brdf_s > 0.0, axis=-1)
    )
    return radiance + jnp.where(ok2[..., None], contrib2, 0.0)


def _sample_env_nee(scene, backend, hit, view, diffuse, metal, rough, key, bounce,
                    of=None, live=None, ggx_bug=False):
    """Direct lighting from the environment map, both MIS terms
    (reference sample_environment_map, render_kernel.cpp:569-631).
    ``live``: optional consumed-lane mask (see _sample_lights_nee)."""
    if live is None:
        live = hit.hit
    B = hit.t.shape[0]
    radiance = jnp.zeros((B, 3), jnp.float32)
    if scene.env_map is None:
        return radiance
    sampler = scene.env_map

    # --- env-sample term ---
    u = _uniforms(key, bounce, _ENV, (B, 2))
    wi, env_rad, env_pdf, _ = env_ops.sample(sampler, u[:, 0], u[:, 1])
    cos_term = dot(hit.normal, wi)
    origin = hit.point + hit.normal * RAY_OFFSET
    blocked = occluded(scene, origin, wi, None, backend, of,
                       mask=live & hit.hit & (cos_term > 0.0))
    brdf = cook_torrance_eval(diffuse, metal, rough, wi, view, hit.normal)
    brdf_pdf = cook_torrance_pdf(rough, view, wi, hit.normal)
    mis_w = power_heuristic(env_pdf, brdf_pdf)
    contrib = (
        brdf * env_rad * (cos_term * mis_w / jnp.maximum(env_pdf, 1e-12))[..., None]
    )
    ok = hit.hit & (cos_term > 0.0) & (~blocked) & (env_pdf > 0.0)
    radiance = radiance + jnp.where(ok[..., None], contrib, 0.0)

    # --- brdf-sample term ---
    ub = _uniforms(key, bounce, _ENV_BRDF, (B, 2))
    brdf_s, wi_s, pdf_s = ggx_importance_sample(
        diffuse, metal, rough, view, hit.normal, ub[:, 0], ub[:, 1],
        reference_bug=ggx_bug,
    )
    cos_s = jnp.maximum(0.0, dot(hit.normal, wi_s))
    origin_s = hit.point + hit.normal * 1e-5  # reference offset (:615)
    blocked_s = occluded(
        scene, origin_s, wi_s, None, backend, of,
        mask=live & hit.hit & (pdf_s > 0.0) & (cos_s > 0.0),
    )
    env_rad_s = env_ops.eval_direction(sampler.image, wi_s)
    env_pdf_s = env_ops.pdf_of_direction(sampler, wi_s)
    mis_w_s = power_heuristic(pdf_s, env_pdf_s)
    contrib_s = (
        brdf_s * env_rad_s * (cos_s * mis_w_s / jnp.maximum(pdf_s, 1e-12))[..., None]
    )
    ok_s = hit.hit & (pdf_s > 0.0) & (cos_s > 0.0) & (~blocked_s)
    return radiance + jnp.where(ok_s[..., None], contrib_s, 0.0)


def trace(scene: Scene, ray_o, ray_d, key, bounces: int,
          backend: str = "auto", nee: bool = True, with_aux: bool = False,
          ggx_bug: bool = False, remat: bool = True):
    """Trace one path per ray; returns radiance [B,3].

    Vectorized equivalent of the reference bounce loop
    (render_kernel.cpp:96-161).

    ``nee=False`` selects the naive BRDF-sampling-only estimator (emission
    gathered at EVERY bounce, env at every miss, no NEE/MIS) — an unbiased
    estimator of the same integral, used by the test suite to statistically
    validate the MIS weights.
    """
    B = ray_o.shape[0]

    def bounce_body(carry, bounce):
        ray_o, ray_d, throughput, radiance, alive, overflow = carry
        of = []

        hit = intersect_scene(scene, ray_o, ray_d, backend, of, mask=alive)
        live_hit = alive & hit.hit

        mat_idx = _material_of_prim(scene, hit.prim)
        emission, diffuse, metal, rough = scene.materials.lookup(mat_idx)
        view = -ray_d

        if nee:
            # emission only on primary hits (reference :126-127)
            radiance = radiance + jnp.where(
                (live_hit & (bounce == 0))[..., None], emission, 0.0
            )

            # direct lighting (NEE + MIS), masked to live hits
            direct = _sample_lights_nee(
                scene, backend, hit, view, diffuse, metal, rough, key,
                bounce, of, live=live_hit, ggx_bug=ggx_bug
            ) + _sample_env_nee(
                scene, backend, hit, view, diffuse, metal, rough, key,
                bounce, of, live=live_hit, ggx_bug=ggx_bug
            )
            radiance = radiance + jnp.where(
                live_hit[..., None], direct * throughput, 0.0
            )

            # env on miss, primary rays only (reference :146-158)
            if scene.env_map is not None:
                sky = env_ops.eval_direction(scene.env_map.image, ray_d)
                miss_primary = alive & (~hit.hit) & (bounce == 0)
                radiance = radiance + jnp.where(
                    miss_primary[..., None], sky * throughput, 0.0
                )
        else:
            # naive estimator: gather emission wherever the path lands.
            # One-sided for secondary hits, to match the support of the NEE
            # MIS terms (both require a front-facing emitter); primary hits
            # count both sides like the reference's bounce-0 rule (:126-127).
            front = dot(hit.normal, -ray_d) > 0.0
            gather = live_hit & ((bounce == 0) | front)
            radiance = radiance + jnp.where(
                gather[..., None], emission * throughput, 0.0
            )
            if scene.env_map is not None:
                sky = env_ops.eval_direction(scene.env_map.image, ray_d)
                miss = alive & (~hit.hit)
                radiance = radiance + jnp.where(
                    miss[..., None], sky * throughput, 0.0
                )

        # continuation: GGX importance sample (reference :121-141).
        # naive mode uses cosine-hemisphere sampling instead: same integral,
        # but with healthy pdfs in ALL directions — GGX-only sampling makes
        # diffuse transport a one-in-thousands firefly event, useless as a
        # statistical cross-check (and the reason the reference's own
        # low-roughness walls get almost no indirect light).
        uc = _uniforms(key, bounce, _CONT, (B, 2))
        if nee:
            brdf_c, wi_c, pdf_c = ggx_importance_sample(
                diffuse, metal, rough, view, hit.normal, uc[:, 0], uc[:, 1],
                reference_bug=ggx_bug,
            )
        else:
            from sycl_ray_tracing.ops.sampling import cosine_hemisphere

            wi_c, pdf_c = cosine_hemisphere(hit.normal, uc[:, 0], uc[:, 1])
            brdf_c = cook_torrance_eval(
                diffuse, metal, rough, wi_c, view, hit.normal
            )
        ok_c = (
            live_hit
            & (pdf_c >= 1e-8)
            & jnp.isfinite(pdf_c)
            & jnp.any(brdf_c > 0.0, axis=-1)
        )
        cos_c = jnp.maximum(0.0, dot(wi_c, hit.normal))
        new_tp = throughput * brdf_c * (cos_c / jnp.maximum(pdf_c, 1e-12))[..., None]
        throughput = jnp.where(ok_c[..., None], new_tp, throughput)

        new_o = hit.point + hit.normal * RAY_OFFSET
        ray_o = jnp.where(ok_c[..., None], new_o, ray_o)
        ray_d = jnp.where(ok_c[..., None], wi_c, ray_d)
        alive = ok_c

        for f in of:
            overflow = overflow | f
        return (ray_o, ray_d, throughput, radiance, alive, overflow), None

    init = (
        ray_o,
        ray_d,
        jnp.ones((B, 3), jnp.float32),
        jnp.zeros((B, 3), jnp.float32),
        jnp.ones((B,), bool),
        jnp.zeros((), bool),
    )
    body = bounce_body
    if remat:
        body = _remat(bounce_body)
    (ray_o, ray_d, throughput, radiance, alive, overflow), _ = jax.lax.scan(
        body, init, jnp.arange(bounces), length=bounces
    )
    if with_aux:
        return radiance, {"overflow": overflow}
    return radiance


def trace_shared(scene: Scene, ray_o, ray_d, key, bounces: int,
                 backend: str = "auto", with_aux: bool = False,
                 ggx_bug: bool = False, remat: bool = True):
    """Shared-sample wavefront integrator: the fast estimator.

    Per bounce: ONE GGX importance sample serves the light-MIS brdf term,
    the env-MIS brdf term AND the continuation ray; the continuation's
    closest-hit doubles as the emitter/miss query for both MIS terms.
    Scene queries per bounce: 1 closest-hit + 2 any-hit (vs the reference's
    5 full traversals, render_kernel.cpp:96-161 + SURVEY.md §3.2).

    Each MIS term remains individually unbiased — sharing one sample across
    terms correlates them without biasing their expectations; the sum still
    estimates the same integral as `trace` (validated statistically in
    tests/test_integrator.py).
    """
    B = ray_o.shape[0]
    backend = _resolve_backend(scene, backend)
    num_lights = scene.num_lights
    has_env = scene.env_map is not None
    n_tris = scene.num_triangles

    # Per-trace packed tables (built ONCE, outside the bounce scan):
    # per-bounce state fetches go through single wide row-gathers instead
    # of many narrow ones.
    mats = scene.materials
    mat_packed = jnp.concatenate(
        [mats.emission, mats.diffuse, mats.metalness[:, None],
         mats.roughness[:, None]], axis=1
    )                                                    # [M,8]

    # SLOT SHADING (list backend): hits come back as packed (cluster, lane)
    # winners, so material/area resolution goes through [K2,128] tables
    # ALIGNED with the kernel's slot layout instead of the per-PRIMITIVE
    # [N,8]/[N,4] tables.  The material id rides in bits 20..30 of the
    # tri-index word: ONE gather resolves prim AND material (the reference
    # resolves material via hit_info.primitive_index,
    # render_kernel.cpp:109-111).
    fuse = (backend == "list" and scene.clusters is not None
            and mats.count <= (1 << 11))
    if fuse:
        from sycl_ray_tracing.ops.pallas.listtrace import multi_query

        cs = scene.clusters
        if scene.slot_packed is not None:
            slot_packed = scene.slot_packed              # [K2,T] i32
        else:
            idx = cs.cl_tri_idx
            vs = idx >= 0
            ci = jnp.clip(idx, 0, n_tris - 1)
            matid = scene.material_indices[ci]
            slot_packed = jnp.where(vs, idx, 0) | (
                jnp.where(vs, matid, 0) << 20
            )
        areas_tab = scene.tri_areas
        if num_lights > 0 and areas_tab is None:
            from sycl_ray_tracing.ops.sampling import triangle_area

            areas_tab = triangle_area(scene.triangles)

        _T = cs.cl_tri_idx.shape[1]

        def slot_lookup(packed):
            """packed winner -> (prim, material id, area): one [K2,T] i32
            gather (packed = cluster*T + lane) + one 1-D area gather.

            The gathered values are tagged as remat residuals
            (ISECT_NAME): they are traversal-derived and the bounce/sample
            replay would otherwise pay the gathers again."""
            from sycl_ray_tracing.ops.intersect import name_traversal

            win = jnp.maximum(packed, 0)
            sp = name_traversal(slot_packed[win // _T, win % _T])
            prim = jnp.where(packed >= 0, sp & 0xFFFFF, -1)
            if num_lights > 0:
                area = name_traversal(
                    areas_tab[jnp.clip(prim, 0, n_tris - 1)]
                )
            else:
                area = jnp.zeros(packed.shape, jnp.float32)
            return prim, sp >> 20, area

        def sphere_merge_mid(tri_hit, tri_mid, s_hit):
            smid = scene.sphere_material[
                jnp.clip(s_hit.prim - n_tris, 0, scene.num_spheres - 1)
            ]
            return jnp.where(tri_hit.t <= s_hit.t, tri_mid, smid)
    else:
        # per-primitive material rows (triangles, then spheres)
        prim_rows = mat_packed[scene.material_indices]       # [N,8]
        if scene.num_spheres > 0:
            prim_rows = jnp.concatenate(
                [prim_rows, mat_packed[scene.sphere_material]], axis=0
            )

        def lookup_prim(prim):
            rows = prim_rows[jnp.clip(prim, 0, prim_rows.shape[0] - 1)]
            return rows[:, 0:3], rows[:, 3:6], rows[:, 6], rows[:, 7]

    if num_lights > 0:
        # light rows: 9 vertex floats + 3 emission floats
        light_rows = jnp.concatenate(
            [
                scene.triangles[scene.emissive_indices].reshape(-1, 9),
                mats.emission[
                    scene.material_indices[scene.emissive_indices]
                ],
            ],
            axis=1,
        )                                                # [K,12]
        if not fuse:
            areas = scene.tri_areas
            if areas is None:
                from sycl_ray_tracing.ops.sampling import triangle_area

                areas = triangle_area(scene.triangles)
            # emitter rows for the MIS brdf term: emission3 + area1
            emitter_rows = jnp.concatenate(
                [mats.emission[scene.material_indices], areas[:, None]],
                axis=1,
            )                                            # [N,4]

    of0 = []
    # primaries are COHERENT (dense pixel bundles): the block-shared list
    # kernel amortizes each candidate tile load over the whole block there,
    # where unions stay near the per-ray list size (unlike bounce rays —
    # docs/ARCHITECTURE.md 2c).
    mid0 = jnp.zeros((B,), jnp.int32)
    if fuse:
        res0, ovf0 = multi_query(
            cs, [(ray_o, ray_d, None, None, False)], share=PRIMARY_SHARE
        )
        of0.append(ovf0)
        prim0, mid0, _ = slot_lookup(res0[0][1])
        hit0 = finalize_hit(ray_o, ray_d, scene.triangles, prim0)
        if scene.num_spheres > 0:
            sphere_prim = n_tris + jnp.arange(scene.num_spheres,
                                              dtype=jnp.int32)
            s0 = intersect_spheres(
                ray_o, ray_d, scene.sphere_centers, scene.sphere_radii,
                sphere_prim,
            )
            mid0 = sphere_merge_mid(hit0, mid0, s0)
            hit0 = merge_hits(hit0, s0)
    else:
        hit0 = intersect_scene(scene, ray_o, ray_d, backend, of0,
                               list_share=PRIMARY_SHARE)

    def _bounce_core(bounce, ray_o, ray_d, hit, mid, throughput, radiance,
                     alive):
        """One bounce over the wavefront.  Returns the updated per-ray
        state plus the bounce's overflow flag."""
        W = ray_o.shape[0]
        of = []
        live_hit = alive & hit.hit

        if fuse:
            rows = mat_packed[mid]                       # tiny-table gather
            emission, diffuse, metal, rough = (
                rows[:, 0:3], rows[:, 3:6], rows[:, 6], rows[:, 7]
            )
        else:
            emission, diffuse, metal, rough = lookup_prim(hit.prim)
        view = -ray_d

        # emission only on primary hits (reference :126-127).  The
        # primary-miss env lookup (:146-158) is HOISTED out of the scan —
        # it only fires at bounce 0, so it seeds the radiance init instead
        # of costing a [B] texel gather every bounce.
        radiance = radiance + jnp.where(
            (live_hit & (bounce == 0))[..., None], emission, 0.0
        )

        origin = hit.point + hit.normal * RAY_OFFSET

        # --- ONE GGX sample for all brdf-sampled estimators this bounce ---
        uc = _uniforms(key, bounce, _CONT, (W, 2))
        brdf_s, wi_s, pdf_s = ggx_importance_sample(
            diffuse, metal, rough, view, hit.normal, uc[:, 0], uc[:, 1],
            reference_bug=ggx_bug,
        )
        cos_s = jnp.maximum(0.0, dot(hit.normal, wi_s))
        # continuation viability is known BEFORE tracing: dead lanes are
        # masked out of the sweep (list backend skips their blocks)
        cont_ok = (
            live_hit
            & (pdf_s >= 1e-8)
            & jnp.isfinite(pdf_s)
            & jnp.any(brdf_s > 0.0, axis=-1)
        )
        # --- light/env sample geometry BEFORE any scene query, so the
        # list backend can FUSE the bounce's continuation closest-hit and
        # NEE shadow rays into ONE sort+candidate-build+kernel launch ---
        if num_lights > 0:
            u = _uniforms(key, bounce, _LIGHT, (W, 3))
            pick = jnp.minimum(
                (u[:, 0] * num_lights).astype(jnp.int32), num_lights - 1
            )
            lr = light_rows[pick]                      # ONE [B,12] gather
            lp, ln, area = sample_triangle_uniform(
                lr[:, 0:3], lr[:, 3:6], lr[:, 6:9], u[:, 1], u[:, 2]
            )
            light_emission = lr[:, 9:12]
            pdf_area = 1.0 / jnp.maximum(num_lights * area, 1e-12)
            to_light = lp - origin
            dist = jnp.linalg.norm(to_light, axis=-1)
            wi_l = to_light / jnp.maximum(dist, 1e-12)[..., None]
            cos_light = jnp.maximum(0.0, dot(ln, -wi_l))
            front = cos_light > 0.0
            cos_surf = dot(hit.normal, wi_l)
            light_mask = live_hit & front & (cos_surf > 0.0)
        if has_env:
            sampler = scene.env_map
            u_e = _uniforms(key, bounce, _ENV, (W, 2))
            wi_e, env_rad, env_pdf, _ = env_ops.sample(
                sampler, u_e[:, 0], u_e[:, 1]
            )
            cos_e = dot(hit.normal, wi_e)
            env_mask = live_hit & (cos_e > 0.0)

        if fuse:
            from sycl_ray_tracing.ops.cluster import (
                SHADOW_EPS as _SH_EPS,
            )

            # shadow queries are flagged any-hit: the kernel's tail guard
            # retires them as soon as they are blocked (reference shadow
            # rays are cheap by design, render_kernel.cpp:744-759)
            queries = [(origin, wi_s, None, cont_ok, False)]
            if num_lights > 0:
                queries.append(
                    (origin, wi_l, dist - _SH_EPS, light_mask, True)
                )
            if has_env:
                queries.append((origin, wi_e, None, env_mask, True))
            res, ovf = multi_query(scene.clusters, queries)
            of.append(ovf)
            prim_c, mid2, area2 = slot_lookup(res[0][1])
            h2 = finalize_hit(origin, wi_s, scene.triangles, prim_c)
            if num_lights > 0:
                shadowed = res[1][1] >= 0
            if has_env:
                blocked = res[-1][1] >= 0
            if scene.num_spheres > 0:
                # merge brute-force sphere hits/occlusion, exactly like
                # the unfused dispatch (reference intersect_scene's sphere
                # loop, render_kernel.cpp:485-502)
                sphere_prim = n_tris + jnp.arange(scene.num_spheres,
                                                  dtype=jnp.int32)
                s_hit = intersect_spheres(
                    origin, wi_s, scene.sphere_centers,
                    scene.sphere_radii, sphere_prim,
                )
                mid2 = sphere_merge_mid(h2, mid2, s_hit)
                h2 = merge_hits(h2, s_hit)
                if num_lights > 0:
                    shadowed = _merge_sphere_occlusion(
                        scene, origin, wi_l, dist, shadowed
                    )
                if has_env:
                    from sycl_ray_tracing.ops.intersect import (
                        BIG_T as _BIG,
                    )

                    blocked = _merge_sphere_occlusion(
                        scene, origin, wi_e,
                        jnp.full((W,), _BIG, origin.dtype), blocked,
                    )
        else:
            mid2 = mid
            h2 = intersect_scene(scene, origin, wi_s, backend, of,
                                 mask=cont_ok)  # closest-hit #1
            if num_lights > 0:
                shadowed = occluded(scene, origin, wi_l, dist, backend,
                                    of, mask=light_mask)
            if has_env:
                blocked = occluded(scene, origin, wi_e, None, backend, of,
                                   mask=env_mask)

        direct = jnp.zeros((W, 3), jnp.float32)

        # --- light NEE: light-sample term (any-hit #1) ---
        if num_lights > 0:
            light_pdf = pdf_area * dist * dist / jnp.maximum(cos_light, 1e-6)
            light_pdf = jnp.where(front, light_pdf, 1.0)
            brdf_l = cook_torrance_eval(
                diffuse, metal, rough, wi_l, view, hit.normal
            )
            brdf_pdf_l = cook_torrance_pdf(rough, view, wi_l, hit.normal)
            mis_w = power_heuristic(light_pdf, brdf_pdf_l)
            ok = front & (~shadowed) & (brdf_pdf_l != 0.0) & (cos_surf > 0.0)
            direct = direct + jnp.where(
                ok[..., None],
                light_emission
                * (cos_surf * mis_w / jnp.maximum(light_pdf, 1e-12))[..., None]
                * brdf_l,
                0.0,
            )

            # --- light NEE: brdf-sample term via the SHARED sample/h2 ---
            if fuse:
                # slot tables already resolved emission/area with the
                # [K2,T] gathers above (mid2/area2)
                hit_emission = mat_packed[mid2][:, 0:3]
                light_area2 = area2
            else:
                er = emitter_rows[jnp.clip(h2.prim, 0, n_tris - 1)]
                hit_emission = er[:, 0:3]
                light_area2 = er[:, 3]
            cos_at_light = jnp.maximum(0.0, dot(h2.normal, -wi_s))
            is_emitter = jnp.any(hit_emission > 0.0, axis=-1) & (
                h2.prim < n_tris
            )
            t2_safe = jnp.where(h2.hit, h2.t, 1.0)
            light_pdf2 = (t2_safe * t2_safe) / jnp.maximum(
                light_area2 * cos_at_light, 1e-6
            )
            light_pdf2 = jnp.where(
                h2.hit & (cos_at_light > 0.0), light_pdf2, 1.0
            )
            mis_w2 = power_heuristic(pdf_s, light_pdf2)
            ok2 = (
                h2.hit
                & is_emitter
                & (cos_at_light > 0.0)
                & (pdf_s > 0.0)
                & jnp.any(brdf_s > 0.0, axis=-1)
            )
            direct = direct + jnp.where(
                ok2[..., None],
                brdf_s
                * hit_emission
                * (cos_s * mis_w2 / jnp.maximum(pdf_s, 1e-12))[..., None],
                0.0,
            )

        # --- env NEE: env-sample term (any-hit #2) ---
        if has_env:
            brdf_e = cook_torrance_eval(
                diffuse, metal, rough, wi_e, view, hit.normal
            )
            brdf_pdf_e = cook_torrance_pdf(rough, view, wi_e, hit.normal)
            mis_we = power_heuristic(env_pdf, brdf_pdf_e)
            ok_e = (cos_e > 0.0) & (~blocked) & (env_pdf > 0.0)
            direct = direct + jnp.where(
                ok_e[..., None],
                brdf_e
                * env_rad
                * (cos_e * mis_we / jnp.maximum(env_pdf, 1e-12))[..., None],
                0.0,
            )

            # --- env NEE: brdf-sample term via the SHARED sample/h2 ---
            env_rad_s = env_ops.eval_direction(sampler.image, wi_s)
            env_pdf_s = env_ops.pdf_of_direction(sampler, wi_s)
            mis_ws = power_heuristic(pdf_s, env_pdf_s)
            ok_s = (~h2.hit) & cont_ok & (cos_s > 0.0)
            direct = direct + jnp.where(
                ok_s[..., None],
                brdf_s
                * env_rad_s
                * (cos_s * mis_ws / jnp.maximum(pdf_s, 1e-12))[..., None],
                0.0,
            )

        radiance = radiance + jnp.where(
            live_hit[..., None], direct * throughput, 0.0
        )

        # --- continuation on the SAME sample; h2 is the next bounce's hit ---
        ok_c = cont_ok
        new_tp = throughput * brdf_s * (
            cos_s / jnp.maximum(pdf_s, 1e-12)
        )[..., None]
        throughput = jnp.where(ok_c[..., None], new_tp, throughput)
        ray_o = jnp.where(ok_c[..., None], origin, ray_o)
        ray_d = jnp.where(ok_c[..., None], wi_s, ray_d)
        alive = ok_c
        ovf = jnp.zeros((), bool)
        for f in of:
            ovf = ovf | f
        return ray_o, ray_d, h2, mid2, throughput, radiance, alive, ovf

    of_init = jnp.zeros((), bool)
    for f in of0:
        of_init = of_init | f
    # hoisted primary-miss env radiance (reference :146-158): bounce-0
    # throughput is 1 and only bounce 0 reads the sky, so it seeds the
    # accumulator instead of costing a texel gather per bounce
    rad_init = jnp.zeros((B, 3), jnp.float32)
    if has_env:
        sky0 = env_ops.eval_direction(scene.env_map.image, ray_d)
        rad_init = jnp.where((~hit0.hit)[..., None], sky0, 0.0)

    def bounce_body(carry, bounce):
        ray_o, ray_d, hit, mid, tp, rad, alive, overflow = carry
        ray_o, ray_d, h2, mid2, tp, rad, alive, ovf = _bounce_core(
            bounce, ray_o, ray_d, hit, mid, tp, rad, alive
        )
        return (ray_o, ray_d, h2, mid2, tp, rad, alive, overflow | ovf), None

    init = (
        ray_o,
        ray_d,
        hit0,
        mid0,
        jnp.ones((B, 3), jnp.float32),
        rad_init,
        jnp.ones((B,), bool),
        of_init,
    )
    body = bounce_body
    if remat:
        body = _remat(bounce_body)
    carry, _ = jax.lax.scan(body, init, jnp.arange(bounces), length=bounces)
    if with_aux:
        return carry[5], {"overflow": carry[7]}
    return carry[5]


def render_rays(scene: Scene, camera: Camera, px, py,
                width: int, height: int, key, samples: int, bounces: int,
                backend: str = "auto", nee: bool = True,
                estimator: str = "parity", samples_per_pass: int = 1,
                max_radiance=None, with_aux: bool = False,
                ggx_bug: bool = False, remat: bool = True):
    """Average ``samples`` jittered paths per pixel; returns HDR [B,3].

    Jitter matches the reference: uniform in [c-0.5, c+0.5) around pixel
    centers (render_kernel.cpp:88-89).

    ``samples_per_pass`` batches that many samples' rays into one wavefront
    per scan step (bigger batches amortize per-op overheads on small
    scenes; the estimator is unchanged — streams are keyed per sample).
    """
    B = px.shape[0]
    P = max(1, samples_per_pass)
    if samples % P != 0:
        raise ValueError("samples must divide by samples_per_pass")
    if P == 1:
        px_rep, py_rep = px, py
    else:
        px_rep = jnp.tile(px, P)
        py_rep = jnp.tile(py, P)

    def sample_body(carry, s):
        accum, overflow = carry
        ks = jax.random.fold_in(key, s)
        uj = _uniforms(ks, 0, _JITTER, (B * P, 2))
        jx = px_rep + 0.5 + uj[:, 0] - 1.0
        jy = py_rep + 0.5 + uj[:, 1] - 1.0
        ro, rd = camera.generate_rays(jx, jy, width, height)
        if estimator == "shared" and nee:
            rad, aux = trace_shared(scene, ro, rd, ks, bounces, backend,
                                    with_aux=True, ggx_bug=ggx_bug,
                                    remat=remat)
        else:
            rad, aux = trace(scene, ro, rd, ks, bounces, backend, nee,
                             with_aux=True, ggx_bug=ggx_bug, remat=remat)
        if max_radiance is not None:
            # per-sample firefly clamp (biased, like all production clamps)
            rad = jnp.minimum(rad, max_radiance)
        if P > 1:
            rad = rad.reshape(P, B, 3).sum(axis=0)
        return (accum + rad, overflow | aux["overflow"]), None

    # Path-replay backward (SURVEY §7.6): with ``remat`` the backward pass
    # REPLAYS each sample's (and bounce's) forward from its counter-derived
    # RNG keys instead of storing scan intermediates — O(1 sample) live
    # memory for the whole render graph, at ~2x forward FLOPs.  Exactness
    # relies on the keyed-uniform design (_uniforms folds (sample, bounce,
    # purpose)): recomputation reproduces identical sample streams.
    # A length-1 sample scan (the 1 spp/iter bench workload) skips the
    # sample-level remat: it would buy no memory (there is exactly one
    # sample's worth of bounce-scan residuals either way) and costs one
    # full forward replay of the whole bounce scan in the backward.
    sbody = sample_body
    if remat and (samples // P) > 1:
        sbody = _remat(sample_body)
    (accum, overflow), _ = jax.lax.scan(
        sbody,
        (jnp.zeros((B, 3), jnp.float32), jnp.zeros((), bool)),
        jnp.arange(samples // P),
    )
    if with_aux:
        return accum / samples, {"overflow": overflow}
    return accum / samples


def render(scene: Scene, camera: Camera, config: RenderConfig, key,
           with_aux: bool = False):
    """Full-frame render -> linear HDR image [H,W,3].

    Row 0 is the BOTTOM of the image (world +y up, reference NDC convention
    render_kernel.cpp:56-73); PNG export flips (utils/png.py).

    ``with_aux=True`` additionally returns {"overflow": bool} — True when a
    cluster-tracer pair budget overflowed anywhere in the frame (hits may
    have been dropped; re-render with bigger budgets, see main.py).
    """
    W, H = config.width, config.height
    if config.debug_pixel is not None:
        x0, y0 = config.debug_pixel
        px = jnp.array([float(x0)], jnp.float32)
        py = jnp.array([float(y0)], jnp.float32)
        hdr, aux = render_rays(
            scene, camera, px, py, W, H, key, config.samples, config.bounces,
            config.intersect, True, config.estimator, config.samples_per_pass,
            config.max_radiance, with_aux=True,
            ggx_bug=(config.ggx_sampler == "reference"),
            remat=config.remat,
        )
        if with_aux:
            return hdr.reshape(1, 1, 3), aux
        return hdr.reshape(1, 1, 3)
    ys, xs = jnp.meshgrid(
        jnp.arange(H, dtype=jnp.float32),
        jnp.arange(W, dtype=jnp.float32),
        indexing="ij",
    )
    px = xs.reshape(-1)
    py = ys.reshape(-1)
    B = W * H

    tile = config.tile_rays
    if tile is None or tile >= B:
        hdr, aux = render_rays(
            scene, camera, px, py, W, H, key, config.samples, config.bounces,
            config.intersect, True, config.estimator, config.samples_per_pass,
            config.max_radiance, with_aux=True,
            ggx_bug=(config.ggx_sampler == "reference"),
            remat=config.remat,
        )
        if with_aux:
            return hdr.reshape(H, W, 3), aux
        return hdr.reshape(H, W, 3)

    # wavefront tiling: bound the cluster tracer's pair-expansion transients
    # (one tile program, sequentially mapped — compile once)
    n_tiles = -(-B // tile)
    pad = n_tiles * tile - B
    px = jnp.pad(px, (0, pad)).reshape(n_tiles, tile)
    py = jnp.pad(py, (0, pad)).reshape(n_tiles, tile)

    def do_tile(args):
        tpx, tpy, tidx = args
        k = jax.random.fold_in(key, tidx)
        return render_rays(
            scene, camera, tpx, tpy, W, H, k, config.samples, config.bounces,
            config.intersect, True, config.estimator, config.samples_per_pass,
            config.max_radiance, with_aux=True,
            ggx_bug=(config.ggx_sampler == "reference"),
            remat=config.remat,
        )

    hdr, aux = jax.lax.map(do_tile, (px, py, jnp.arange(n_tiles)))
    hdr = hdr.reshape(n_tiles * tile, 3)
    aux = {"overflow": jnp.any(aux["overflow"])}
    if with_aux:
        return hdr[:B].reshape(H, W, 3), aux
    return hdr[:B].reshape(H, W, 3)
