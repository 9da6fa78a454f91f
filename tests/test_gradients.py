"""Differentiability: AD gradients vs finite differences at matched seeds —
the BASELINE.json gradient-correctness metric (pixel gradients w.r.t.
material roughness/metalness/albedo, env-map texels, camera pose)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sycl_ray_tracing.models import pathtracer
from sycl_ray_tracing.models.camera import Camera, cornell_box_camera
from sycl_ray_tracing.ops import transform as T
from sycl_ray_tracing.utils.config import RenderConfig

CFG = RenderConfig(width=12, height=12, samples=4, bounces=2)


def _render_mean(scene, cam, key):
    """Scalar probe: mean of a small render (smooth function of params)."""
    W, H = CFG.width, CFG.height
    ys, xs = jnp.meshgrid(
        jnp.arange(H, dtype=jnp.float32),
        jnp.arange(W, dtype=jnp.float32),
        indexing="ij",
    )
    hdr = pathtracer.render_rays(
        scene, cam, xs.reshape(-1), ys.reshape(-1), W, H, key,
        CFG.samples, CFG.bounces,
    )
    return jnp.mean(hdr)


def _fd_vs_ad(param_to_scalar, x0, eps, rtol, atol=1e-6):
    """Central finite difference vs jax.grad on the SAME traced program."""
    g_ad = float(jax.grad(param_to_scalar)(x0))
    f_p = float(param_to_scalar(x0 + eps))
    f_m = float(param_to_scalar(x0 - eps))
    g_fd = (f_p - f_m) / (2 * eps)
    assert np.isfinite(g_ad), "AD gradient not finite"
    np.testing.assert_allclose(g_ad, g_fd, rtol=rtol, atol=atol)
    return g_ad


@pytest.fixture(scope="module")
def key():
    return jax.random.PRNGKey(123)


def test_grad_roughness(cornell_scene, key):
    cam = cornell_box_camera()
    mats = cornell_scene.materials

    def f(r_shift):
        # multiplicative shift: keeps FD symmetric (an additive shift with a
        # clip is one-sided for materials sitting exactly at the clamp)
        new = dataclasses.replace(mats, roughness=mats.roughness * (1.0 + r_shift))
        return _render_mean(cornell_scene.with_materials(new), cam, key)

    g = _fd_vs_ad(f, jnp.float32(0.0), 2e-3, rtol=2e-2, atol=5e-4)
    assert g != 0.0


def test_grad_albedo(cornell_scene, key):
    cam = cornell_box_camera()
    mats = cornell_scene.materials

    def f(shift):
        new = dataclasses.replace(mats, diffuse=mats.diffuse * (1.0 + shift))
        return _render_mean(cornell_scene.with_materials(new), cam, key)

    g = _fd_vs_ad(f, jnp.float32(0.0), 1e-3, rtol=1e-2)
    assert g > 0.0  # brighter albedo -> brighter image


def test_grad_emission(cornell_scene, key):
    cam = cornell_box_camera()
    mats = cornell_scene.materials

    def f(shift):
        new = dataclasses.replace(
            mats, emission=mats.emission * (1.0 + shift)
        )
        return _render_mean(cornell_scene.with_materials(new), cam, key)

    g = _fd_vs_ad(f, jnp.float32(0.0), 1e-3, rtol=1e-2)
    assert g > 0.0


def test_grad_metalness(cornell_scene, key):
    cam = cornell_box_camera()
    mats = cornell_scene.materials

    def f(shift):
        new = dataclasses.replace(
            mats, metalness=jnp.clip(mats.metalness + shift, 0.0, 1.0)
        )
        return _render_mean(cornell_scene.with_materials(new), cam, key)

    # metalness clamp makes this one-sided for the metal box; use pure shift
    def f2(shift):
        new = dataclasses.replace(mats, metalness=mats.metalness * (1 + shift))
        return _render_mean(cornell_scene.with_materials(new), cam, key)

    _fd_vs_ad(f2, jnp.float32(0.0), 2e-3, rtol=5e-2, atol=5e-4)


def test_grad_env_texels(cornell_scene, test_env_map, key):
    cam = cornell_box_camera()
    base = jnp.asarray(test_env_map)

    def f(scale):
        scene = cornell_scene.with_env_map(base * (1.0 + scale))
        return _render_mean(scene, cam, key)

    g = _fd_vs_ad(f, jnp.float32(0.0), 1e-3, rtol=2e-2)
    assert g > 0.0  # brighter sky -> brighter image


def test_grad_camera_pose(cornell_scene, key):
    """Gradient w.r.t. a camera translation parameter."""

    def f(dz):
        m = T.compose(T.translation(0.0, 1.0, 3.5 + dz),
                      jnp.diag(jnp.array([1.0, 1.0, -1.0, 1.0])))
        cam = Camera(view_matrix=m, fov_dist=jnp.float32(1.0 / np.tan(np.radians(22.5))))
        return _render_mean(cornell_scene, cam, key)

    # camera motion crosses visibility boundaries on some pixels; mean over
    # few pixels is still smooth almost everywhere — use small eps
    _fd_vs_ad(f, jnp.float32(0.0), 1e-3, rtol=0.1, atol=2e-3)


@pytest.mark.parametrize("backend", ["brute", "bvh", "cluster", "list"])
def test_grad_through_accel_backends(cornell_scene, key, backend):
    """FD-vs-AD through EVERY intersector — the accelerated backends use the
    stop_gradient + finalize_hit recompute recipe (ops/bvh.py intersect_bvh,
    ops/cluster.py intersect_clusters), which is the path every big-scene
    gradient takes and needs its own FD pin."""
    import numpy as np_

    from sycl_ray_tracing.ops.bvh import build_bvh
    from sycl_ray_tracing.ops.cluster import build_clusters

    tris = np_.asarray(cornell_scene.triangles)
    scene = cornell_scene
    if backend == "bvh":
        scene = scene.with_bvh(build_bvh(tris))
    elif backend in ("cluster", "list"):
        nrays = CFG.width * CFG.height
        scene = scene.with_clusters(
            build_clusters(tris).with_budgets(nrays * 2, nrays * 2)
        )
    cam = cornell_box_camera()
    mats = scene.materials

    def f(shift):
        new = dataclasses.replace(mats, diffuse=mats.diffuse * (1.0 + shift))
        s = scene.with_materials(new)
        W, H = CFG.width, CFG.height
        ys, xs = jnp.meshgrid(
            jnp.arange(H, dtype=jnp.float32),
            jnp.arange(W, dtype=jnp.float32),
            indexing="ij",
        )
        hdr = pathtracer.render_rays(
            s, cam, xs.reshape(-1), ys.reshape(-1), W, H, key,
            CFG.samples, CFG.bounces, backend=backend,
        )
        return jnp.mean(hdr)

    g = _fd_vs_ad(f, jnp.float32(0.0), 1e-3, rtol=1e-2)
    assert g > 0.0


def test_backends_agree_forward(cornell_scene, key):
    """The three backends produce the SAME image bit-for-bit-close at equal
    seeds (they differ only in how the closest hit is found)."""
    import numpy as np_

    from sycl_ray_tracing.ops.bvh import build_bvh
    from sycl_ray_tracing.ops.cluster import build_clusters

    tris = np_.asarray(cornell_scene.triangles)
    nrays = CFG.width * CFG.height
    scene = cornell_scene.with_bvh(build_bvh(tris)).with_clusters(
        build_clusters(tris).with_budgets(nrays * 2, nrays * 2)
    )
    cam = cornell_box_camera()
    imgs = {
        b: np_.asarray(_render_mean_backend(scene, cam, key, b))
        for b in ("brute", "bvh", "cluster", "list")
    }
    np_.testing.assert_allclose(imgs["bvh"], imgs["brute"], rtol=1e-4,
                                atol=1e-5)
    np_.testing.assert_allclose(imgs["cluster"], imgs["brute"], rtol=1e-4,
                                atol=1e-5)
    np_.testing.assert_allclose(imgs["list"], imgs["brute"], rtol=1e-4,
                                atol=1e-5)


def _render_mean_backend(scene, cam, key, backend):
    W, H = CFG.width, CFG.height
    ys, xs = jnp.meshgrid(
        jnp.arange(H, dtype=jnp.float32),
        jnp.arange(W, dtype=jnp.float32),
        indexing="ij",
    )
    # remat=False: the checkpoint-wrapped interpret-mode Pallas program
    # segfaults the XLA CPU compiler when compiled late in a long test
    # process (upstream compiler bug; GPU compiles are unaffected).
    # Replay-backward correctness has its own dedicated test below.
    return pathtracer.render_rays(
        scene, cam, xs.reshape(-1), ys.reshape(-1), W, H, key,
        CFG.samples, CFG.bounces, backend=backend, remat=False,
    )


def test_grad_is_nonzero_per_texel(cornell_scene, test_env_map, key):
    """Per-texel env gradients: scattered, finite, and non-negative for an
    L1 brightness probe."""
    cam = cornell_box_camera()
    base = jnp.asarray(test_env_map)

    def f(img):
        return _render_mean(cornell_scene.with_env_map(img), cam, key)

    g = np.asarray(jax.grad(f)(base))
    assert np.isfinite(g).all()
    assert (g >= -1e-8).all()
    assert (g > 0).any()


def test_remat_backward_matches_stored(cornell_scene, key):
    """Path-replay backward (jax.checkpoint over the sample/bounce scans,
    SURVEY §7.6): gradients are IDENTICAL to the store-everything autodiff
    — recomputation replays the same counter-derived RNG streams."""
    import dataclasses as _dc

    cam = cornell_box_camera()
    mats = cornell_scene.materials
    W = H = 8

    def f(shift, remat):
        new = _dc.replace(mats, diffuse=mats.diffuse * (1.0 + shift))
        s = cornell_scene.with_materials(new)
        ys, xs = jnp.meshgrid(
            jnp.arange(H, dtype=jnp.float32),
            jnp.arange(W, dtype=jnp.float32),
            indexing="ij",
        )
        hdr = pathtracer.render_rays(
            s, cam, xs.reshape(-1), ys.reshape(-1), W, H, key,
            4, 3, estimator="shared", remat=remat,
        )
        return jnp.mean(hdr)

    g_remat = jax.grad(lambda x: f(x, True))(jnp.float32(0.0))
    g_store = jax.grad(lambda x: f(x, False))(jnp.float32(0.0))
    assert np.isfinite(g_remat) and g_remat > 0
    np.testing.assert_allclose(np.asarray(g_remat), np.asarray(g_store),
                               rtol=1e-5)


def test_list_backend_agrees_with_env_map(cornell_scene, test_env_map, key):
    """The fused per-bounce query path with an ENV MAP (3 query sets:
    continuation + light shadow + env shadow) matches brute exactly."""
    import numpy as np_

    from sycl_ray_tracing.ops.cluster import build_clusters

    tris = np_.asarray(cornell_scene.triangles)
    nrays = CFG.width * CFG.height
    scene = cornell_scene.with_env_map(test_env_map).with_clusters(
        build_clusters(tris).with_budgets(nrays * 2, nrays * 2)
    )
    cam = cornell_box_camera()
    imgs = {
        b: np_.asarray(_render_mean_backend(scene, cam, key, b))
        for b in ("brute", "list")
    }
    np_.testing.assert_allclose(imgs["list"], imgs["brute"], rtol=1e-4,
                                atol=1e-5)


def test_remat_off_matches_remat_on(cornell_scene):
    """RenderConfig.remat=False (store scan residuals) must produce the
    same forward image and the same gradients as the path-replay default
    — it only changes what the backward stores vs recomputes."""
    import dataclasses as _dc

    import jax
    import jax.numpy as jnp
    import numpy as np

    from sycl_ray_tracing.models import pathtracer
    from sycl_ray_tracing.models.camera import cornell_box_camera
    from sycl_ray_tracing.utils.config import RenderConfig

    cam = cornell_box_camera()
    key = jax.random.PRNGKey(13)

    def run(remat):
        cfg = RenderConfig(width=8, height=8, samples=2, bounces=2,
                           tile_rays=None, remat=remat)

        def loss(d):
            mats = _dc.replace(
                cornell_scene.materials,
                diffuse=cornell_scene.materials.diffuse * d,
            )
            s = cornell_scene.with_materials(mats)
            return jnp.mean(pathtracer.render(s, cam, cfg, key))

        v, g = jax.value_and_grad(loss)(jnp.float32(1.0))
        return float(v), float(g)

    v1, g1 = run(True)
    v0, g0 = run(False)
    np.testing.assert_allclose(v0, v1, rtol=1e-6)
    np.testing.assert_allclose(g0, g1, rtol=1e-4, atol=1e-8)
