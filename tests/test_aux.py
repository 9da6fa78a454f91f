"""Aux subsystems: progressive/checkpoint rendering, denoiser, image utils,
VNDF sampler, env-map bin splitting."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sycl_ray_tracing.models.camera import cornell_box_camera
from sycl_ray_tracing.models.progressive import (
    ProgressiveRenderer,
    ProgressiveState,
)
from sycl_ray_tracing.ops.brdf import ggx_vndf_sample
from sycl_ray_tracing.ops.image import (
    luminance_of_area,
    normalize_range,
    sample_bilinear,
    sample_nearest,
)
from sycl_ray_tracing.ops.envmap import importance_split
from sycl_ray_tracing.utils.config import RenderConfig
from sycl_ray_tracing.utils.denoise import denoise


def test_progressive_checkpoint_resume(cornell_scene, tmp_path):
    cfg = RenderConfig(width=12, height=12, samples=8, bounces=2,
                       tile_rays=None)
    cam = cornell_box_camera()
    ckpt = str(tmp_path / "state.npz")

    # uninterrupted
    r1 = ProgressiveRenderer(cornell_scene, cam, cfg, seed=5,
                             samples_per_batch=2)
    img_full = r1.run()

    # interrupted after 2 batches, then resumed from the checkpoint
    r2 = ProgressiveRenderer(cornell_scene, cam, cfg, seed=5,
                             samples_per_batch=2)
    r2.step()
    r2.step()
    r2.state.save(ckpt)
    r3 = ProgressiveRenderer.resume(cornell_scene, cam, cfg, ckpt,
                                    samples_per_batch=2)
    img_resumed = r3.run()

    np.testing.assert_allclose(img_resumed, img_full, rtol=1e-5, atol=1e-6)
    assert r3.state.samples_done == 8


def test_progressive_state_roundtrip(tmp_path):
    st = ProgressiveState(
        hdr_sum=np.random.default_rng(0).normal(size=(4, 4, 3)).astype(
            np.float32
        ),
        samples_done=6,
        seed=3,
        overflow=True,
    )
    p = str(tmp_path / "s.npz")
    st.save(p)
    back = ProgressiveState.load(p)
    np.testing.assert_array_equal(back.hdr_sum, st.hdr_sum)
    assert back.samples_done == 6 and back.seed == 3
    assert back.overflow is True


def test_progressive_threads_overflow(cornell_scene):
    """A cluster-backend progressive render with starved pair budgets must
    surface the overflow flag in its state instead of silently accumulating
    an image with dropped hits."""
    from sycl_ray_tracing.ops.cluster import build_clusters

    scene = cornell_scene.with_clusters(
        build_clusters(np.asarray(cornell_scene.triangles),
                       p1_budget=2, p2_budget=2)
    )
    cfg = RenderConfig(width=8, height=8, samples=2, bounces=2,
                       tile_rays=None, intersect="cluster")
    r = ProgressiveRenderer(scene, cornell_box_camera(), cfg, seed=0,
                            samples_per_batch=2)
    r.step()
    assert r.state.overflow is True


def test_denoise_reduces_noise_keeps_edges():
    rng = np.random.default_rng(0)
    H = W = 64
    clean = np.zeros((H, W, 3), np.float32)
    clean[:, W // 2:] = 1.0  # step edge
    noisy = clean + rng.normal(0, 0.15, clean.shape).astype(np.float32)
    out = np.asarray(denoise(jnp.asarray(noisy), iterations=3))
    # noise reduced on flat regions
    flat_err_in = np.abs(noisy[:, : W // 2 - 4] - 0.0).mean()
    flat_err_out = np.abs(out[:, : W // 2 - 4] - 0.0).mean()
    assert flat_err_out < flat_err_in * 0.6
    # edge preserved: means of the two halves stay far apart
    assert out[:, : W // 2 - 2].mean() < 0.25
    assert out[:, W // 2 + 2:].mean() > 0.75


def test_denoise_blend_zero_is_identity():
    rng = np.random.default_rng(1)
    img = jnp.asarray(rng.uniform(0, 2, (16, 16, 3)).astype(np.float32))
    out = denoise(img, blend=0.0)
    np.testing.assert_allclose(out, img, atol=1e-6)


def test_image_sampling():
    img = jnp.arange(12.0).reshape(2, 2, 3)
    uv = jnp.array([[0.25, 0.25], [0.75, 0.75]])
    nearest = sample_nearest(img, uv)
    np.testing.assert_allclose(nearest[0], img[0, 0])
    np.testing.assert_allclose(nearest[1], img[1, 1])
    # bilinear at the exact center = average of all four texels
    center = sample_bilinear(img, jnp.array([[0.5, 0.5]]))
    np.testing.assert_allclose(center[0], img.reshape(4, 3).mean(0), rtol=1e-6)


def test_luminance_area_and_range():
    img = jnp.ones((4, 4, 3))
    total = float(luminance_of_area(img, 0, 4, 0, 4))
    assert abs(total - 16.0) < 1e-4
    r = normalize_range(jnp.array([[[2.0, 4.0, 6.0]]]))
    assert float(r.min()) == 0.0 and float(r.max()) == 1.0


def test_vndf_sample_valid_and_pdf_positive():
    key = jax.random.PRNGKey(0)
    B = 8192
    n = jnp.tile(jnp.array([[0.0, 0.0, 1.0]]), (B, 1))
    v = jnp.tile(jnp.array([[0.4, 0.1, 0.91]]), (B, 1))
    v = v / jnp.linalg.norm(v, axis=-1, keepdims=True)
    u = jax.random.uniform(key, (B, 2))
    h, pdf = ggx_vndf_sample(jnp.full((B,), 0.5), v, n, u[:, 0], u[:, 1])
    # microfacet normals are unit, above the surface, and v.h > 0
    np.testing.assert_allclose(
        np.linalg.norm(np.asarray(h), axis=-1), 1.0, atol=1e-5
    )
    assert float(jnp.min(jnp.sum(h * n, axis=-1))) > 0.0
    assert float(jnp.min(jnp.sum(h * v, axis=-1))) > -1e-6
    assert float(jnp.min(pdf)) > 0.0
    # VNDF identity: E[ <v,h> / pdf ] over samples = projected area / ...
    # weaker check: mean reciprocal pdf is finite and positive
    assert np.isfinite(float(jnp.mean(1.0 / pdf)))


def test_importance_split_covers_image(test_env_map):
    bins = importance_split(test_env_map, min_bin_area=16,
                            min_bin_radiance=50.0)
    # bins tile the whole image exactly
    area = sum((x1 - x0) * (y1 - y0) for x0, x1, y0, y1 in bins)
    h, w = test_env_map.shape[:2]
    assert area == h * w
    # the sun region gets smaller bins than the average
    sun_bins = [
        b for b in bins
        if b[0] <= 21 < b[1] and b[2] <= 9 < b[3]
    ]
    assert sun_bins
    sun_area = (sun_bins[0][1] - sun_bins[0][0]) * (
        sun_bins[0][3] - sun_bins[0][2]
    )
    assert sun_area < area / len(bins)


def test_metrics_module():
    from sycl_ray_tracing.utils.metrics import RenderMetrics

    m = RenderMetrics()
    with m.phase("build"):
        pass
    x = m.timed("render", lambda: jnp.ones((8, 8)) * 2.0)
    assert float(x[0, 0]) == 2.0
    m.count("rays", 1e6)
    rep = m.report()
    assert "time/render" in rep and rep["count/rays"] == 1e6
    assert "Mrays_per_s" in rep
    assert isinstance(m.dump(), str)


def test_distributed_single_host():
    from sycl_ray_tracing.parallel.distributed import (
        global_mesh,
        initialize,
        is_coordinator,
        process_info,
    )

    initialize()  # no-op single host
    assert is_coordinator()
    info = process_info()
    assert info["process_count"] == 1 and info["global_devices"] == 8
    mesh = global_mesh(sample_axis=2)
    assert mesh.shape["data"] == 4 and mesh.shape["sample"] == 2


@pytest.mark.slow
def test_cli_checkpoint_resume(tmp_path):
    """main.py --checkpoint: interrupted render resumes to the identical
    image an uninterrupted run produces (counter RNG replay)."""
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = repo
    env["JAX_PLATFORMS"] = "cpu"
    args = [sys.executable, "-u", os.path.join(repo, "main.py"),
            os.path.join(repo, "data", "cornell_box.obj"),
            "--w=16", "--h=16", "--samples=4", "--bounces=2",
            "--camera=cornell", "--checkpoint-batch=2"]

    def run(extra, cwd):
        return subprocess.run(args + extra, env=env, cwd=cwd,
                              capture_output=True, timeout=420)

    d1 = tmp_path / "one"
    d1.mkdir()
    r = run([f"--checkpoint={tmp_path}/a.npz"], d1)
    assert r.returncode == 0, r.stdout.decode()[-800:]

    from sycl_ray_tracing.models.progressive import ProgressiveState

    # "interrupted" run: render only the first half, then resume it
    d2 = tmp_path / "two"
    d2.mkdir()
    r = run([f"--checkpoint={tmp_path}/b.npz", "--samples=2"], d2)
    assert r.returncode == 0
    b = ProgressiveState.load(f"{tmp_path}/b.npz")
    assert b.samples_done == 2
    # resume b to 4 samples
    d3 = tmp_path / "three"
    d3.mkdir()
    r = run([f"--checkpoint={tmp_path}/b.npz"], d3)
    assert r.returncode == 0, r.stdout.decode()[-800:]
    b4 = ProgressiveState.load(f"{tmp_path}/b.npz")
    a4 = ProgressiveState.load(f"{tmp_path}/a.npz")
    assert b4.samples_done == a4.samples_done == 4
    np.testing.assert_allclose(b4.hdr_sum, a4.hdr_sum, rtol=1e-6)
