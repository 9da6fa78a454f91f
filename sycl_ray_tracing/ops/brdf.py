"""Cook–Torrance BRDF: evaluation, pdf, and GGX-NDF importance sampling.

Capability parity with reference render_kernel.cpp:
  * GGX normal distribution (:223-233), Schlick Fresnel (:218-221),
    Smith/Schlick-GGX masking with k = alpha/2 (:235-245)
  * metalness workflow F0 = 0.04*(1-m) + m*base (:284)
  * kD = (1-m)*(1-F) diffuse + specular F*D*G/(4 NoV NoL) (:291-297)
  * pdf = D*NoH / (4 VoH) (:247-258)
  * NDF importance sampling theta = acos(sqrt((1-u)/(u*(a^2-1)+1))) with
    below-surface rejection (:392-451)
  * lambertian_brdf (:213-216)

All functions are batched over [...]-shaped inputs and fully differentiable
(safe-math guarded) w.r.t. material parameters.

Material parameters are passed as a dict-like SoA:
  diffuse [...,3], metalness [...], roughness [...].
"""

from __future__ import annotations

import jax.numpy as jnp

from sycl_ray_tracing.ops.safe_math import dot, normalize, safe_sqrt
from sycl_ray_tracing.ops.sampling import to_world


def lambertian_brdf(diffuse):
    """diffuse/pi (reference render_kernel.cpp:213-216)."""
    return diffuse / jnp.pi


def fresnel_schlick(f0, voh):
    """Schlick approximation (reference render_kernel.cpp:218-221)."""
    return f0 + (1.0 - f0) * jnp.power(jnp.clip(1.0 - voh, 0.0, 1.0), 5.0)[..., None]


def ggx_ndf(alpha, noh):
    """GGX/Trowbridge-Reitz D with the reference's NoH<=0.999999 clamp
    (render_kernel.cpp:223-233)."""
    noh = jnp.minimum(noh, 0.999999)
    a2 = alpha * alpha
    b = noh * noh * (a2 - 1.0) + 1.0
    return a2 / (jnp.pi * b * b)


def _g1_schlick_ggx(k, d):
    return d / (d * (1.0 - k) + k)


def ggx_smith_g(alpha, nov, nol):
    """Smith masking-shadowing, Schlick-GGX G1 with k = alpha/2
    (reference render_kernel.cpp:235-245)."""
    k = alpha / 2.0
    return _g1_schlick_ggx(k, nol) * _g1_schlick_ggx(k, nov)


def cook_torrance_eval(diffuse, metalness, roughness, to_light, view, normal):
    """BRDF value [...,3] for given directions (render_kernel.cpp:260-301).

    ``view`` points away from the surface toward the camera (-ray.direction),
    ``to_light`` away from the surface toward the light.
    """
    h = normalize(view + to_light)
    nov = jnp.maximum(0.0, dot(normal, view))
    nol = jnp.maximum(0.0, dot(normal, to_light))
    noh = jnp.maximum(0.0, dot(normal, h))
    voh = jnp.maximum(0.0, dot(h, view))

    alpha = roughness * roughness
    f0 = 0.04 * (1.0 - metalness)[..., None] + metalness[..., None] * diffuse
    f = fresnel_schlick(f0, voh)
    d = ggx_ndf(alpha, noh)
    g = ggx_smith_g(alpha, nov, nol)

    kd = (1.0 - metalness)[..., None] * (1.0 - f)
    diffuse_part = kd * diffuse / jnp.pi
    denom = jnp.maximum(4.0 * nov * nol, 1e-8)
    specular_part = f * (d * g / denom)[..., None]

    valid = (nov > 0.0) & (nol > 0.0) & (noh > 0.0)
    return jnp.where(valid[..., None], diffuse_part + specular_part, 0.0)


def cook_torrance_pdf(roughness, view, to_light, normal):
    """NDF-sampling pdf D*NoH/(4 VoH) (render_kernel.cpp:247-258)."""
    h = normalize(view + to_light)
    alpha = roughness * roughness
    voh = jnp.maximum(0.0, dot(view, h))
    noh = jnp.maximum(0.0, dot(normal, h))
    d = ggx_ndf(alpha, noh)
    return jnp.where(voh > 0.0, d * noh / jnp.maximum(4.0 * voh, 1e-8), 0.0)


def ggx_vndf_sample(roughness, view, normal, u1, u2):
    """Visible-normal (VNDF) GGX sampling via the spherical-cap method
    (Dupuy & Benyoub 2023).  Capability parity with the reference's unused
    alternative sampler (render_kernel.cpp:303-370); returns
    (microfacet_normal [...,3], pdf [...]).

    pdf = G1(view) * D(h) * max(0, v.h) / v.n — the standard VNDF density.
    """
    from sycl_ray_tracing.ops.sampling import branchless_onb

    alpha = roughness * roughness
    # express view in the local frame of the surface normal
    t, b = branchless_onb(normal)
    v_local = jnp.stack(
        [dot(view, t), dot(view, b), dot(view, normal)], axis=-1
    )
    # warp view to the hemisphere configuration
    vs = normalize(
        jnp.stack(
            [v_local[..., 0] * alpha, v_local[..., 1] * alpha,
             v_local[..., 2]], axis=-1
        )
    )
    # sample a spherical cap in (-vs.z, 1]
    phi = 2.0 * jnp.pi * u1
    z = 1.0 - u2 - u2 * vs[..., 2]
    sin_t = safe_sqrt(jnp.clip(1.0 - z * z, 0.0, 1.0))
    c = jnp.stack([sin_t * jnp.cos(phi), sin_t * jnp.sin(phi), z], axis=-1)
    h_std = c + vs
    # warp back to the ellipsoid configuration
    h_local = normalize(
        jnp.stack(
            [h_std[..., 0] * alpha, h_std[..., 1] * alpha,
             jnp.maximum(h_std[..., 2], 1e-6)], axis=-1
        )
    )
    h = (
        h_local[..., 0:1] * t
        + h_local[..., 1:2] * b
        + h_local[..., 2:3] * normal
    )

    nov = jnp.maximum(dot(normal, view), 1e-6)
    noh = jnp.maximum(0.0, dot(normal, h))
    voh = jnp.maximum(0.0, dot(view, h))
    a2 = alpha * alpha
    lam = safe_sqrt(a2 + (1.0 - a2) * nov * nov) + nov
    g1 = 2.0 * nov / lam
    # VNDF density over microfacet normals: D_v(h) = G1 D(h) <v,h> / <v,n>
    pdf = g1 * ggx_ndf(alpha, noh) * voh / jnp.maximum(nov, 1e-6)
    return h, pdf


def ggx_importance_sample(diffuse, metalness, roughness, view, normal, u1,
                          u2, reference_bug: bool = False):
    """Sample a GGX microfacet normal, reflect, and evaluate in one call
    (reference cook_torrance_brdf_importance_sample, render_kernel.cpp:392-451).

    Returns (brdf [...,3], direction [...,3], pdf [...]).
    brdf and pdf are zero where the sampled microfacet normal fell below the
    surface (:409-411) or any of NoV/NoL/NoH was non-positive.

    ``reference_bug=True`` replicates the reference's sampler verbatim
    (render_kernel.cpp:404): it takes acos of the cos^2 expression WITHOUT
    the square root, so the sampled distribution does not match the
    pdf D*NoH/(4*VoH) it divides by — a biased estimator, kept only so the
    parity suite can compare images against the reference binary
    bug-for-bug.  Default is the corrected inversion, which matches
    cook_torrance_pdf exactly.
    """
    alpha = roughness * roughness
    phi = 2.0 * jnp.pi * u1
    # Standard GGX-NDF inversion: cos^2(theta) = (1-u)/(u*(alpha^2-1)+1).
    cos2 = (1.0 - u2) / (u2 * (alpha * alpha - 1.0) + 1.0)
    if reference_bug:
        cos_theta = jnp.clip(cos2, 0.0, 1.0)
        sin_theta = safe_sqrt(jnp.maximum(0.0, 1.0 - cos_theta * cos_theta))
    else:
        cos_theta = safe_sqrt(jnp.clip(cos2, 0.0, 1.0))
        sin_theta = safe_sqrt(jnp.maximum(0.0, 1.0 - cos2))
    local_h = jnp.stack(
        [jnp.cos(phi) * sin_theta, jnp.sin(phi) * sin_theta, cos_theta],
        axis=-1,
    )
    h = to_world(normal, local_h)
    above = dot(h, normal) >= 0.0

    to_light = normalize(2.0 * dot(h, view)[..., None] * h - view)

    nov = jnp.maximum(0.0, dot(normal, view))
    nol = jnp.maximum(0.0, dot(normal, to_light))
    noh = jnp.maximum(0.0, dot(normal, h))
    voh = jnp.maximum(0.0, dot(h, view))
    valid = above & (nov > 0.0) & (nol > 0.0) & (noh > 0.0)

    d = ggx_ndf(alpha, noh)
    f0 = 0.04 * (1.0 - metalness)[..., None] + metalness[..., None] * diffuse
    f = fresnel_schlick(f0, voh)
    g = ggx_smith_g(alpha, nov, nol)

    kd = (1.0 - metalness)[..., None] * (1.0 - f)
    diffuse_part = kd * diffuse / jnp.pi
    denom = jnp.maximum(4.0 * nov * nol, 1e-8)
    specular_part = f * (d * g / denom)[..., None]

    pdf = d * noh / jnp.maximum(4.0 * voh, 1e-8)
    brdf = jnp.where(valid[..., None], diffuse_part + specular_part, 0.0)
    pdf = jnp.where(valid, pdf, 0.0)
    return brdf, to_light, pdf
