"""Integrator correctness.

The key statistical test: the MIS/NEE estimator and the naive
BRDF-sampling-only estimator are both unbiased for the same integral, so at
high sample counts their images must agree — this validates every MIS weight,
pdf conversion and shadow-ray rule at once (a statistical stand-in for
the reference's golden-image eyeballing, README.md:6-13).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sycl_ray_tracing.models import pathtracer
from sycl_ray_tracing.models.camera import cornell_box_camera
from sycl_ray_tracing.utils.config import RenderConfig


def _render(scene, cfg, key, nee=True):
    cam = cornell_box_camera()
    W, H = cfg.width, cfg.height
    ys, xs = jnp.meshgrid(
        jnp.arange(H, dtype=jnp.float32),
        jnp.arange(W, dtype=jnp.float32),
        indexing="ij",
    )
    hdr = pathtracer.render_rays(
        scene, cam, xs.reshape(-1), ys.reshape(-1), W, H, key,
        cfg.samples, cfg.bounces, cfg.intersect, nee,
    )
    return hdr.reshape(H, W, 3)


def test_cornell_render_sane(cornell_scene, rng_key):
    cfg = RenderConfig(width=32, height=32, samples=8, bounces=3)
    img = np.asarray(_render(cornell_scene, cfg, rng_key))
    assert img.shape == (32, 32, 3)
    assert np.isfinite(img).all()
    assert (img >= 0).all()
    assert img.mean() > 0.05  # scene is lit


def test_light_visible_and_walls_colored(cornell_scene, rng_key):
    cfg = RenderConfig(width=48, height=48, samples=16, bounces=2)
    img = np.asarray(_render(cornell_scene, cfg, rng_key))
    # ceiling light (emission 100) must appear in the top rows of the frame
    # (row 0 = bottom)
    assert img.max() > 50.0
    bright_rows = np.argwhere(img.max(axis=(1, 2)) > 50.0)[:, 0]
    assert bright_rows.min() > 24, "light should be in the upper half"
    # left third redder than green, right third greener than red (color bleed)
    left = img[10:38, :16]
    right = img[10:38, 32:]
    assert left[..., 0].mean() > left[..., 1].mean()
    assert right[..., 1].mean() > right[..., 0].mean()


def test_deterministic_same_key(cornell_scene, rng_key):
    cfg = RenderConfig(width=16, height=16, samples=2, bounces=2)
    a = np.asarray(_render(cornell_scene, cfg, rng_key))
    b = np.asarray(_render(cornell_scene, cfg, rng_key))
    np.testing.assert_array_equal(a, b)


def test_different_keys_differ(cornell_scene):
    cfg = RenderConfig(width=16, height=16, samples=2, bounces=2)
    a = np.asarray(_render(cornell_scene, cfg, jax.random.PRNGKey(0)))
    b = np.asarray(_render(cornell_scene, cfg, jax.random.PRNGKey(1)))
    assert np.abs(a - b).max() > 1e-4


@pytest.mark.slow
def test_mis_nee_matches_naive_estimator(cornell_scene):
    """MIS+NEE and naive BRDF-sampling must converge to the same image.

    Path-length support: NEE at bounce i adds light paths of i+2 segments,
    so nee(bounces=B) covers paths up to B+1 segments — compare against
    naive(bounces=B+1) which covers the same set.

    Materials are clamped to roughness >= 0.4: cornell's near-specular
    dielectric walls (roughness 0.01, metalness 0) make the naive
    estimator's diffuse-transport variance astronomically large (the GGX
    NDF sampler — the reference's design — practically never samples the
    diffuse lobe), so a finite-spp cross-check is only meaningful on
    moderately rough materials.
    """
    import dataclasses as _dc

    mats = cornell_scene.materials
    rough = _dc.replace(mats, roughness=jnp.maximum(mats.roughness, 0.4))
    scene = cornell_scene.with_materials(rough)
    cfg_nee = RenderConfig(width=24, height=24, samples=96, bounces=3)
    cfg_naive = RenderConfig(width=24, height=24, samples=768, bounces=4)
    img_nee = np.asarray(
        _render(scene, cfg_nee, jax.random.PRNGKey(5), nee=True)
    )
    img_naive = np.asarray(
        _render(scene, cfg_naive, jax.random.PRNGKey(9), nee=False)
    )
    # the naive estimator's per-pixel variance at feasible spp is large
    # (small bright light); compare 6x6 block means and the global mean,
    # excluding direct-light pixels where both have huge variance
    def blocks(x):
        m = np.where(x < 5.0, x, 0.0)
        return m.reshape(4, 6, 4, 6, 3).mean(axis=(1, 3))

    a, b = blocks(img_nee), blocks(img_naive)
    rel = np.abs(a - b) / (a + b + 0.05)
    assert rel.mean() < 0.10, (rel.mean(), a.mean(), b.mean())
    ga, gb = a.mean(), b.mean()
    assert abs(ga - gb) / (ga + gb) < 0.05, (ga, gb)


def test_bounces_add_energy(cornell_scene, rng_key):
    """More bounces => more light (indirect illumination accumulates)."""
    cfg1 = RenderConfig(width=24, height=24, samples=32, bounces=1)
    cfg3 = RenderConfig(width=24, height=24, samples=32, bounces=4)
    m1 = np.asarray(_render(cornell_scene, cfg1, rng_key)).mean()
    m3 = np.asarray(_render(cornell_scene, cfg3, rng_key)).mean()
    assert m3 > m1 * 1.05


def test_debug_pixel_mode(cornell_scene, rng_key):
    cfg = RenderConfig(
        width=32, height=32, samples=4, bounces=2, debug_pixel=(16, 16)
    )
    cam = cornell_box_camera()
    img = pathtracer.render(cornell_scene, cam, cfg, rng_key)
    assert img.shape == (1, 1, 3)
    assert np.isfinite(np.asarray(img)).all()


def test_env_map_lights_scene(cornell_scene, test_env_map, rng_key):
    """Adding an env map adds energy through the cornell box's open side."""
    lit = cornell_scene.with_env_map(jnp.asarray(test_env_map))
    cfg = RenderConfig(width=24, height=24, samples=8, bounces=2)
    base = np.asarray(_render(cornell_scene, cfg, rng_key)).mean()
    with_env = np.asarray(_render(lit, cfg, rng_key)).mean()
    assert with_env > base


def test_shared_estimator_matches_parity(cornell_scene):
    """The shared-sample wavefront estimator (1 closest + 2 any-hit per
    bounce) must agree with the reference-structure estimator (5 queries)
    in expectation."""
    import dataclasses as _dc

    mats = cornell_scene.materials
    scene = cornell_scene.with_materials(
        _dc.replace(mats, roughness=jnp.maximum(mats.roughness, 0.3))
    )
    cam = cornell_box_camera()
    W = H = 16
    ys, xs = jnp.meshgrid(
        jnp.arange(H, dtype=jnp.float32),
        jnp.arange(W, dtype=jnp.float32),
        indexing="ij",
    )
    px, py = xs.reshape(-1), ys.reshape(-1)

    a = np.asarray(pathtracer.render_rays(
        scene, cam, px, py, W, H, jax.random.PRNGKey(3), 128, 3,
        "brute", True, "shared",
    ))
    b = np.asarray(pathtracer.render_rays(
        scene, cam, px, py, W, H, jax.random.PRNGKey(7), 128, 3,
        "brute", True, "parity",
    ))
    mask = (a < 5) & (b < 5)
    rel = np.abs(a - b) / (a + b + 0.1)
    assert rel[mask].mean() < 0.12, rel[mask].mean()
    ga, gb = a[mask].mean(), b[mask].mean()
    assert abs(ga - gb) / (ga + gb) < 0.04, (ga, gb)


def test_cluster_backend_matches_brute(cornell_scene, rng_key):
    """Rendering with the wavefront cluster backend reproduces the
    brute-force image exactly (same estimator, same RNG)."""
    scene = cornell_scene.build_acceleration(num_rays_hint=1024)
    cfg_b = RenderConfig(width=16, height=16, samples=4, bounces=2,
                         intersect="brute", tile_rays=None)
    cfg_c = RenderConfig(width=16, height=16, samples=4, bounces=2,
                         intersect="cluster", tile_rays=None)
    cam = cornell_box_camera()
    a = np.asarray(pathtracer.render(scene, cam, cfg_b, rng_key))
    b = np.asarray(pathtracer.render(scene, cam, cfg_c, rng_key))
    np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


def test_tiled_render_matches_untiled(cornell_scene):
    """Ray tiling changes only RNG stream assignment, not the estimator."""
    cfg_t = RenderConfig(width=16, height=16, samples=32, bounces=2,
                         tile_rays=64)
    cfg_u = RenderConfig(width=16, height=16, samples=32, bounces=2,
                         tile_rays=None)
    cam = cornell_box_camera()
    a = np.asarray(pathtracer.render(cornell_scene, cam, cfg_t,
                                     jax.random.PRNGKey(0)))
    b = np.asarray(pathtracer.render(cornell_scene, cam, cfg_u,
                                     jax.random.PRNGKey(1)))
    assert a.shape == b.shape == (16, 16, 3)
    assert np.isfinite(a).all()
    mask = (a < 5) & (b < 5)
    rel = np.abs(a - b) / (a + b + 0.2)
    assert rel[mask].mean() < 0.25  # MC noise at 32 spp


def test_firefly_clamp(cornell_scene, rng_key):
    cfg = RenderConfig(width=16, height=16, samples=4, bounces=2,
                       max_radiance=2.0, tile_rays=None)
    cam = cornell_box_camera()
    img = np.asarray(pathtracer.render(cornell_scene, cam, cfg, rng_key))
    assert img.max() <= 2.0 + 1e-5
    assert img.mean() > 0.05


def test_render_surfaces_cluster_overflow(cornell_scene, rng_key):
    """A render whose cluster pair budgets overflow must REPORT it via the
    aux output (never silently drop hits) — and generous budgets must not."""
    import dataclasses as _dc

    from sycl_ray_tracing.ops.cluster import build_clusters
    from sycl_ray_tracing.utils.config import RenderConfig

    tris = np.asarray(cornell_scene.triangles)
    cfg = RenderConfig(width=8, height=8, samples=2, bounces=2,
                       intersect="cluster")
    cam = cornell_box_camera()

    tiny = cornell_scene.with_clusters(build_clusters(tris).with_budgets(4, 4))
    _, aux = pathtracer.render(tiny, cam, cfg, rng_key, with_aux=True)
    assert bool(aux["overflow"])

    roomy = cornell_scene.with_clusters(
        build_clusters(tris).with_budgets(8 * 8 * 4, 8 * 8 * 4)
    )
    img, aux = pathtracer.render(roomy, cam, cfg, rng_key, with_aux=True)
    assert not bool(aux["overflow"])
    assert np.isfinite(np.asarray(img)).all()


def test_fused_list_path_with_spheres_matches_brute(test_env_map):
    """Scenes WITH spheres now take the fused list path too: the shared
    estimator through backend='list' (fused 3-query + sphere merge) must
    match backend='brute' bitwise-tightly at the same key — identical
    estimator and RNG streams, both intersectors exact."""
    import numpy as np

    from sycl_ray_tracing.models.scene import make_materials, make_scene
    from sycl_ray_tracing.utils.procedural import dragon_standin

    tris = dragon_standin(2_000)
    mats = make_materials(
        emission=[(1.0, 0.0, 1.0), (0, 0, 0), (6.0, 6.0, 6.0)],
        diffuse=[(0, 0, 0), (0.7, 0.6, 0.5), (0, 0, 0)],
        metalness=[0.0, 0.3, 0.0],
        roughness=[1.0, 0.5, 1.0],
    )
    # emissive panel above + two spheres in the scene
    lp = 1.0
    panel = np.array(
        [[[-lp, 3.0, -lp], [lp, 3.0, -lp], [lp, 3.0, lp]],
         [[-lp, 3.0, -lp], [lp, 3.0, lp], [-lp, 3.0, lp]]], np.float32)
    all_tris = np.concatenate([tris, panel], 0)
    mat_idx = np.concatenate(
        [np.full(tris.shape[0], 1, np.int32), np.full(2, 2, np.int32)])
    scene = make_scene(
        all_tris, mat_idx, mats,
        sphere_centers=np.array([[1.5, 0.0, 0.0], [-1.2, 0.5, 0.8]],
                                np.float32),
        sphere_radii=np.array([0.5, 0.35], np.float32),
        sphere_material=np.array([1, 1], np.int32),
        env_map_image=test_env_map,
    )
    scene = scene.build_acceleration(num_rays_hint=256)

    from sycl_ray_tracing.models.camera import pbrt_dragon_camera

    cam = pbrt_dragon_camera()
    cfg_kw = dict(width=8, height=8, samples=2, bounces=3, tile_rays=None)
    from sycl_ray_tracing.utils.config import RenderConfig

    key = jax.random.PRNGKey(3)
    imgs = {}
    for backend in ("brute", "list"):
        cfg = RenderConfig(intersect=backend, estimator="shared", **cfg_kw)
        imgs[backend] = np.asarray(
            pathtracer.render(scene, cam, cfg, key)
        )
    assert np.isfinite(imgs["list"]).all()
    assert imgs["list"].mean() > 1e-4
    np.testing.assert_allclose(imgs["list"], imgs["brute"],
                               rtol=2e-4, atol=1e-5)
