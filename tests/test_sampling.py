"""Sampling primitives: ONB orthonormality, hemisphere pdfs, MIS heuristic,
triangle area sampling."""

import jax
import jax.numpy as jnp
import numpy as np

from sycl_ray_tracing.ops.sampling import (
    branchless_onb,
    cosine_hemisphere,
    power_heuristic,
    sample_triangle_uniform,
    to_world,
    triangle_area,
    uniform_hemisphere,
)


def test_onb_orthonormal():
    rng = np.random.default_rng(0)
    n = rng.normal(size=(256, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    t, b = branchless_onb(jnp.asarray(n))
    t, b = np.asarray(t), np.asarray(b)
    np.testing.assert_allclose(np.linalg.norm(t, axis=-1), 1.0, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(b, axis=-1), 1.0, atol=1e-5)
    np.testing.assert_allclose((t * n).sum(-1), 0.0, atol=1e-5)
    np.testing.assert_allclose((b * n).sum(-1), 0.0, atol=1e-5)
    np.testing.assert_allclose((t * b).sum(-1), 0.0, atol=1e-5)


def test_to_world_z_gives_normal():
    n = jnp.array([[0.6, -0.48, 0.64]])
    n = n / jnp.linalg.norm(n)
    w = to_world(n, jnp.array([[0.0, 0.0, 1.0]]))
    np.testing.assert_allclose(w, n, atol=1e-6)


def test_uniform_hemisphere_stays_above():
    key = jax.random.PRNGKey(0)
    n = jnp.tile(jnp.array([[0.0, 1.0, 0.0]]), (4096, 1))
    u = jax.random.uniform(key, (4096, 2))
    d, pdf = uniform_hemisphere(n, u[:, 0], u[:, 1])
    assert float(jnp.min(jnp.sum(d * n, axis=-1))) >= -1e-5
    np.testing.assert_allclose(pdf, 1.0 / (2 * np.pi))


def test_cosine_hemisphere_mean_cos():
    """E[cos theta] = 2/3 under cosine-weighted sampling."""
    key = jax.random.PRNGKey(1)
    B = 100_000
    n = jnp.tile(jnp.array([[0.0, 0.0, 1.0]]), (B, 1))
    u = jax.random.uniform(key, (B, 2))
    d, pdf = cosine_hemisphere(n, u[:, 0], u[:, 1])
    np.testing.assert_allclose(float(jnp.mean(d[:, 2])), 2.0 / 3.0, atol=5e-3)
    np.testing.assert_allclose(pdf, d[:, 2] / np.pi, atol=1e-5)


def test_power_heuristic_values():
    np.testing.assert_allclose(power_heuristic(1.0, 1.0), 0.5)
    np.testing.assert_allclose(power_heuristic(2.0, 1.0), 0.8)
    assert float(power_heuristic(0.0, 0.0)) == 0.0  # guarded corner
    # weights sum to 1
    a, b = 0.7, 2.3
    np.testing.assert_allclose(
        power_heuristic(a, b) + power_heuristic(b, a), 1.0, atol=1e-6
    )


def test_triangle_area():
    tri = jnp.array([[[0.0, 0.0, 0.0], [2.0, 0.0, 0.0], [0.0, 2.0, 0.0]]])
    np.testing.assert_allclose(triangle_area(tri), [2.0])


def test_triangle_sample_inside_and_uniform():
    key = jax.random.PRNGKey(2)
    B = 50_000
    a = jnp.tile(jnp.array([[0.0, 0.0, 0.0]]), (B, 1))
    b = jnp.tile(jnp.array([[1.0, 0.0, 0.0]]), (B, 1))
    c = jnp.tile(jnp.array([[0.0, 1.0, 0.0]]), (B, 1))
    u = jax.random.uniform(key, (B, 2))
    p, n, area = sample_triangle_uniform(a, b, c, u[:, 0], u[:, 1])
    np.testing.assert_allclose(area, 0.5, atol=1e-6)
    np.testing.assert_allclose(n[:, 2], 1.0, atol=1e-6)
    x, y = np.asarray(p[:, 0]), np.asarray(p[:, 1])
    assert (x >= -1e-6).all() and (y >= -1e-6).all() and (x + y <= 1 + 1e-5).all()
    # uniformity: mean of a barycentric coordinate is 1/3
    np.testing.assert_allclose(x.mean(), 1.0 / 3.0, atol=5e-3)
    np.testing.assert_allclose(y.mean(), 1.0 / 3.0, atol=5e-3)
    # half the samples fall in x+y < ~0.707 triangle half-area split
    assert abs((x + y < np.sqrt(0.5)).mean() - 0.5) < 1e-2
