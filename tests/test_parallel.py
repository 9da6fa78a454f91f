"""Sharding: sharded render executes on an 8-device mesh, matches the
single-device estimator statistically, and the distributed train step
produces finite psum'd gradients."""

import jax
import jax.numpy as jnp
import numpy as np

from sycl_ray_tracing.models import pathtracer
from sycl_ray_tracing.models.camera import cornell_box_camera
from sycl_ray_tracing.parallel.mesh import best_sample_axis, make_mesh
from sycl_ray_tracing.parallel.render import make_train_step, render_sharded
from sycl_ray_tracing.utils.config import RenderConfig


def test_eight_devices_available():
    assert len(jax.devices()) == 8, "conftest must force 8 CPU devices"


def test_mesh_shapes():
    m = make_mesh(8, sample_axis=2)
    assert m.shape["data"] == 4 and m.shape["sample"] == 2
    assert best_sample_axis(8, 16) == 8
    assert best_sample_axis(8, 4) == 4
    assert best_sample_axis(8, 3) == 1


def test_sharded_render_runs_and_is_finite(cornell_scene, rng_key):
    cfg = RenderConfig(width=16, height=16, samples=8, bounces=2)
    mesh = make_mesh(8, sample_axis=2)
    img = render_sharded(cornell_scene, cornell_box_camera(), cfg, rng_key, mesh)
    a = np.asarray(img)
    assert a.shape == (16, 16, 3)
    assert np.isfinite(a).all() and (a >= 0).all()
    assert a.mean() > 0.05


def test_sharded_matches_unsharded_statistically(cornell_scene):
    """Same estimator, different RNG streams: images agree to MC noise."""
    cfg = RenderConfig(width=16, height=16, samples=32, bounces=2)
    mesh = make_mesh(8, sample_axis=4)
    cam = cornell_box_camera()
    a = np.asarray(
        render_sharded(cornell_scene, cam, cfg, jax.random.PRNGKey(1), mesh)
    )
    b = np.asarray(pathtracer.render(cornell_scene, cam, cfg, jax.random.PRNGKey(2)))
    mask = (a < 5) & (b < 5)  # exclude the emitter pixels
    rel = np.abs(a - b) / (a + b + 0.2)
    assert rel[mask].mean() < 0.15, rel[mask].mean()


def test_data_only_mesh(cornell_scene, rng_key):
    cfg = RenderConfig(width=8, height=8, samples=4, bounces=2)
    mesh = make_mesh(8, sample_axis=1)
    img = render_sharded(cornell_scene, cornell_box_camera(), cfg, rng_key, mesh)
    assert np.isfinite(np.asarray(img)).all()


def test_train_step_grads(cornell_scene, test_env_map, rng_key):
    cfg = RenderConfig(width=8, height=8, samples=8, bounces=2)
    mesh = make_mesh(8, sample_axis=2)
    scene = cornell_scene.with_env_map(jnp.asarray(test_env_map))
    step = make_train_step(scene, cfg, mesh, optimize_env=True)

    import dataclasses

    ys, xs = jnp.meshgrid(
        jnp.arange(cfg.height, dtype=jnp.float32),
        jnp.arange(cfg.width, dtype=jnp.float32),
        indexing="ij",
    )
    # guess = perturbed materials; target = true materials (rendered inside
    # the step under common random numbers)
    guess = dataclasses.replace(
        scene.materials, diffuse=jnp.clip(scene.materials.diffuse + 0.2, 0, 1)
    )
    loss, grads = step(
        guess, scene.env_map.image, scene.materials, scene.env_map.image,
        cornell_box_camera(), xs.reshape(-1), ys.reshape(-1), rng_key,
    )
    assert np.isfinite(float(loss))
    assert float(loss) > 0.0
    g_mats, g_env = grads
    for leaf in jax.tree.leaves(g_mats):
        assert np.isfinite(np.asarray(leaf)).all()
    assert np.isfinite(np.asarray(g_env)).all()
    total = sum(float(jnp.sum(jnp.abs(l))) for l in jax.tree.leaves(g_mats))
    assert total > 0.0
    # at the true parameters the common-random-numbers loss is exactly 0
    loss0, _ = step(
        scene.materials, scene.env_map.image, scene.materials,
        scene.env_map.image, cornell_box_camera(),
        xs.reshape(-1), ys.reshape(-1), rng_key,
    )
    assert float(loss0) < 1e-6


def test_sharded_render_list_backend():
    """The list backend (what auto picks on GPUs) inside shard_map on the
    8-device mesh: the kernels (interpreted here) compose with
    pixel/sample sharding — the structure a multi-card dragon render
    runs."""
    from sycl_ray_tracing.utils.procedural import dragon_scene
    from sycl_ray_tracing.models.camera import pbrt_dragon_camera

    scene = dragon_scene(n_tris=2_000, with_sky=True, sky_res=(16, 32))
    cfg = RenderConfig(width=8, height=8, samples=2, bounces=2,
                       intersect="list", estimator="shared")
    mesh = make_mesh(8, sample_axis=2)
    img = render_sharded(scene, pbrt_dragon_camera(), cfg,
                         jax.random.PRNGKey(0), mesh)
    img = np.asarray(img)
    assert img.shape == (8, 8, 3)
    assert np.isfinite(img).all()
    assert img.mean() > 1e-4
