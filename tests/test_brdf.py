"""BRDF correctness: NDF normalization, sampler/pdf consistency,
energy conservation, reciprocity."""

import jax
import jax.numpy as jnp
import numpy as np

from sycl_ray_tracing.ops.brdf import (
    cook_torrance_eval,
    cook_torrance_pdf,
    ggx_importance_sample,
    ggx_ndf,
    lambertian_brdf,
)


def test_lambertian_value():
    np.testing.assert_allclose(
        lambertian_brdf(jnp.array([0.5, 0.25, 1.0])),
        np.array([0.5, 0.25, 1.0]) / np.pi,
    )


def test_ggx_ndf_normalizes():
    """∫ D(h) cos(theta) dω = 1 over the hemisphere."""
    for rough in (0.2, 0.5, 1.0):
        alpha = rough * rough
        n = 512
        theta = (jnp.arange(n) + 0.5) / n * (jnp.pi / 2)
        d = ggx_ndf(jnp.asarray(alpha), jnp.cos(theta))
        integrand = d * jnp.cos(theta) * jnp.sin(theta) * 2 * jnp.pi
        integral = float(jnp.sum(integrand) * (jnp.pi / 2 / n))
        assert abs(integral - 1.0) < 2e-2, f"rough={rough}: {integral}"


def test_importance_sample_matches_pdf_histogram():
    """The fraction of GGX samples falling in a solid-angle cap must match
    the integral of the returned pdf — this is exactly the consistency the
    reference violates (render_kernel.cpp:404 vs :445, see ops/brdf.py)."""
    key = jax.random.PRNGKey(0)
    B = 200_000
    normal = jnp.tile(jnp.array([[0.0, 0.0, 1.0]]), (B, 1))
    view = jnp.tile(
        jnp.array([[0.0, jnp.sin(0.3), jnp.cos(0.3)]]), (B, 1)
    )
    diffuse = jnp.ones((B, 3)) * 0.5
    metal = jnp.zeros((B,))
    rough = jnp.full((B,), 0.5)
    u = jax.random.uniform(key, (B, 2))
    _, wi, pdf = ggx_importance_sample(
        diffuse, metal, rough, view, normal, u[:, 0], u[:, 1]
    )
    ok = pdf > 0
    # empirical density of directions with cos(theta_out) in [0.8, 0.9]
    cos_out = wi[:, 2]
    band = ok & (cos_out > 0.8) & (cos_out < 0.9)
    frac = float(jnp.sum(band)) / B
    # expected = mean over band samples of (1/pdf) weighting... simpler:
    # importance-sampling identity: E[1{band}] ≈ ∫_band pdf dω, and
    # E[1{band}/pdf] ≈ solid angle of band = 2π(0.9-0.8)
    est_solid_angle = float(jnp.sum(jnp.where(band, 1.0 / pdf, 0.0))) / B
    true_solid_angle = 2 * np.pi * (0.9 - 0.8)
    assert abs(est_solid_angle - true_solid_angle) / true_solid_angle < 0.05, (
        frac,
        est_solid_angle,
        true_solid_angle,
    )


def test_pdf_function_matches_sampler_pdf():
    """cook_torrance_pdf(view, sampled_dir) must equal the pdf returned by
    the sampler for the same direction."""
    key = jax.random.PRNGKey(3)
    B = 4096
    normal = jnp.tile(jnp.array([[0.0, 0.0, 1.0]]), (B, 1))
    view = jnp.tile(jnp.array([[0.3, 0.1, 0.95]]), (B, 1))
    view = view / jnp.linalg.norm(view, axis=-1, keepdims=True)
    rough = jnp.full((B,), 0.4)
    u = jax.random.uniform(key, (B, 2))
    _, wi, pdf = ggx_importance_sample(
        jnp.ones((B, 3)), jnp.zeros((B,)), rough, view, normal, u[:, 0], u[:, 1]
    )
    pdf2 = cook_torrance_pdf(rough, view, wi, normal)
    ok = pdf > 1e-6
    err = jnp.where(ok, jnp.abs(pdf - pdf2) / jnp.maximum(pdf, 1e-6), 0.0)
    assert float(jnp.max(err)) < 1e-3


def test_white_furnace_upper_bound():
    """Energy conservation: ∫ f cos dω <= 1 for a white dielectric."""
    key = jax.random.PRNGKey(1)
    B = 100_000
    normal = jnp.tile(jnp.array([[0.0, 0.0, 1.0]]), (B, 1))
    view = jnp.tile(jnp.array([[0.0, 0.0, 1.0]]), (B, 1))
    for rough in (0.3, 0.7, 1.0):
        u = jax.random.uniform(jax.random.fold_in(key, int(rough * 10)), (B, 2))
        brdf, wi, pdf = ggx_importance_sample(
            jnp.ones((B, 3)),
            jnp.zeros((B,)),
            jnp.full((B,), rough),
            view,
            normal,
            u[:, 0],
            u[:, 1],
        )
        cos = jnp.maximum(wi[:, 2], 0.0)
        est = brdf[:, 0] * cos / jnp.maximum(pdf, 1e-12)
        total = float(jnp.mean(jnp.where(pdf > 0, est, 0.0)))
        assert total < 1.05, f"rough={rough}: energy {total}"
        assert total > 0.2, f"rough={rough}: energy suspiciously low {total}"


def test_helmholtz_reciprocity():
    """f(wi, wo) == f(wo, wi)."""
    n = jnp.array([[0.0, 0.0, 1.0]])
    wi = jnp.array([[0.5, 0.2, 0.84]])
    wi = wi / jnp.linalg.norm(wi)
    wo = jnp.array([[-0.3, 0.4, 0.87]])
    wo = wo / jnp.linalg.norm(wo)
    d = jnp.array([[0.7, 0.6, 0.5]])
    m = jnp.array([0.3])
    r = jnp.array([0.45])
    f1 = cook_torrance_eval(d, m, r, wi, wo, n)
    f2 = cook_torrance_eval(d, m, r, wo, wi, n)
    np.testing.assert_allclose(f1, f2, rtol=1e-5)


def test_grads_finite():
    """No NaN gradients through eval or sampling at tricky configs."""

    def loss(rough):
        n = jnp.array([[0.0, 0.0, 1.0]])
        v = jnp.array([[0.0, 0.0, 1.0]])  # normal incidence: NoH ~= 1 corner
        brdf, wi, pdf = ggx_importance_sample(
            jnp.ones((1, 3)), jnp.zeros((1,)), rough, v, n,
            jnp.array([0.5]), jnp.array([0.5]),
        )
        return jnp.sum(brdf) + jnp.sum(wi) + jnp.sum(pdf)

    for r in (0.01, 0.5, 1.0):
        g = jax.grad(lambda x: loss(jnp.full((1,), x)))(r)
        assert np.isfinite(float(g)), f"rough={r}"
