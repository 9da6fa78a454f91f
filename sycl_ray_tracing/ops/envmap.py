"""Equirectangular environment map: lookup, luminance CDF, importance sampling.

Capability parity with the reference:
  * direction -> lat/long texel lookup (render_kernel.cpp:520-530)
  * flat luminance prefix-sum CDF over all texels (utils.cpp:126-142)
  * CDF inversion (render_kernel.cpp:532-567) — here a *separable*
    row/column CDF inverted by DENSE compare-and-count against the
    VMEM-resident tables (exactly searchsorted side="right", but one
    fused VPU reduction instead of a log2(H)-step binary search whose
    every step is a full gather pass; the reference's flat-CDF row search
    via the last column is an approximation of the same marginal;
    SURVEY.md §7.5)
  * pdf = (lum/total) * W*H / (2 pi^2 sin(theta)) (render_kernel.cpp:594-595)

The sampled-direction convention matches the reference exactly
(render_kernel.cpp:586): dir = (-sin(t)cos(p), -cos(t), -sin(t)sin(p)).

Differentiable w.r.t. the env-map texels: radiance lookups are gathers
(gradients scatter into texels); the CDF/pdf path is detached by design
(stop_gradient) — that is the detached-sampling estimator, unbiased for
texel gradients.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from sycl_ray_tracing.ops.safe_math import luminance, safe_asin


COL_BLK = 32  # column-CDF block width for the two-level inversion


class EnvMapSampler(NamedTuple):
    """Precomputed sampling tables for an equirect env map [H,W,3].

    ``cond_blk``/``cond_fine`` are the two-level form of ``cond_cdf`` for
    the column inversion: the dense [B,W] row-gather + compare-count
    streamed W*4 bytes per ray (134 MB/launch at W=1024 — bandwidth-bound,
    ~0.4 ms/launch, r5 profile); the block tables cut that by W/COL_BLK
    while producing bit-identical counts (elements <= target form a prefix
    of the nondecreasing row, so #full-blocks + in-block count equals the
    dense count exactly)."""

    image: jnp.ndarray        # [H,W,3] radiance texels (differentiable)
    row_cdf: jnp.ndarray      # [H] inclusive prefix sum of row luminance sums
    cond_cdf: jnp.ndarray     # [H,W] inclusive prefix sums within each row
    total: jnp.ndarray        # [] total luminance
    cond_blk: jnp.ndarray     # [H,NB] block-end cdf (NB = ceil(W/COL_BLK))
    cond_fine: jnp.ndarray    # [H*NB, COL_BLK] blocked cdf, pad=+inf


def build_sampler(image) -> EnvMapSampler:
    """Build separable CDF tables.  The tables are detached — sampling
    *locations* carry no gradient, texel radiance does.

    Concrete (non-traced) inputs take a pure-numpy path: building the CDF
    eagerly on an accelerator would dispatch many tiny ops; inside jit the
    jnp path fuses into the surrounding computation as usual.
    """
    import numpy as np

    if not isinstance(image, jax.core.Tracer):
        img_np = np.asarray(image, np.float32)
        lum = (
            0.3086 * img_np[..., 0]
            + 0.6094 * img_np[..., 1]
            + 0.0820 * img_np[..., 2]
        )
        cond_cdf = np.cumsum(lum, axis=1, dtype=np.float32)
        row_cdf = np.cumsum(cond_cdf[:, -1], dtype=np.float32)
        total = np.maximum(row_cdf[-1], 1e-12)
        h, w = lum.shape
        blk = min(COL_BLK, w)
        nb = -(-w // blk)
        pad = nb * blk - w
        fine = np.pad(cond_cdf, ((0, 0), (0, pad)),
                      constant_values=np.inf).reshape(h * nb, blk)
        cblk = fine.reshape(h, nb, blk)[:, :, -1]
        cblk = np.where(np.isinf(cblk),
                        cond_cdf[:, -1:].repeat(nb, 1), cblk)
        return EnvMapSampler(
            image=jnp.asarray(img_np),
            row_cdf=jnp.asarray(row_cdf),
            cond_cdf=jnp.asarray(cond_cdf),
            total=jnp.asarray(total, jnp.float32),
            cond_blk=jnp.asarray(cblk.astype(np.float32)),
            cond_fine=jnp.asarray(fine.astype(np.float32)),
        )

    lum = jax.lax.stop_gradient(luminance(image))             # [H,W]
    cond_cdf = jnp.cumsum(lum, axis=1)                        # [H,W]
    row_sums = cond_cdf[:, -1]                                # [H]
    row_cdf = jnp.cumsum(row_sums)                            # [H]
    total = jnp.maximum(row_cdf[-1], 1e-12)
    h, w = lum.shape
    blk = min(COL_BLK, w)
    nb = -(-w // blk)
    pad = nb * blk - w
    fine = jnp.pad(cond_cdf, ((0, 0), (0, pad)),
                   constant_values=jnp.inf).reshape(h * nb, blk)
    cblk = fine.reshape(h, nb, blk)[:, :, -1]
    cblk = jnp.where(jnp.isinf(cblk),
                     jnp.repeat(cond_cdf[:, -1:], nb, axis=1), cblk)
    return EnvMapSampler(image=image, row_cdf=row_cdf, cond_cdf=cond_cdf,
                         total=total, cond_blk=cblk, cond_fine=fine)


def eval_direction(image: jnp.ndarray, direction: jnp.ndarray) -> jnp.ndarray:
    """Nearest-texel lat/long lookup for directions [...,3]
    (reference render_kernel.cpp:520-530).

    The gathered texels are tagged as remat residuals (same "isect" name
    the traversal outputs use) so the integrators' bounce/sample replay
    reads the saved [B,3] rows instead of re-paying the ~0.23 ms/launch
    HBM gather; checkpoint_name is the identity for AD, so texel
    gradients still scatter into ``image`` in the backward."""
    from jax.ad_checkpoint import checkpoint_name

    h, w = image.shape[0], image.shape[1]
    u = 0.5 + jnp.arctan2(direction[..., 2], direction[..., 0]) / (2.0 * jnp.pi)
    v = 0.5 + safe_asin(direction[..., 1]) / jnp.pi
    x = jnp.clip((u * w).astype(jnp.int32), 0, w - 1)
    y = jnp.clip((v * h).astype(jnp.int32), 0, h - 1)
    return checkpoint_name(image[y, x], "isect")


def texel_coords_of_direction(shape, direction):
    """(x, y) integer texel coords of directions (for pdf evaluation)."""
    h, w = shape
    u = 0.5 + jnp.arctan2(direction[..., 2], direction[..., 0]) / (2.0 * jnp.pi)
    v = 0.5 + safe_asin(direction[..., 1]) / jnp.pi
    x = jnp.clip((u * w).astype(jnp.int32), 0, w - 1)
    y = jnp.clip((v * h).astype(jnp.int32), 0, h - 1)
    return x, y


def sample(sampler: EnvMapSampler, u_row, u_col):
    """Importance-sample texels proportional to luminance.

    u_row, u_col: uniforms [...].  Returns (direction [...,3],
    radiance [...,3], pdf [...], sin_theta [...]).
    """
    h, w = sampler.image.shape[0], sampler.image.shape[1]

    # Dense compare-and-count instead of jnp.searchsorted: XLA lowers
    # searchsorted to a log2(H)-step unrolled binary search, each step a
    # full gather pass over the batch.  The [B,H] broadcast compare
    # against the small [H] table fuses into one reduction and is exactly
    # searchsorted(side="right").
    y = jnp.sum(
        sampler.row_cdf <= (u_row * sampler.total)[..., None], axis=-1
    ).astype(jnp.int32)
    y = jnp.clip(y, 0, h - 1)

    # ONE [H,2] pair-row gather for (cdf[y-1], cdf[y]) instead of two
    # scalar gathers
    pairs = jnp.stack(
        [jnp.concatenate([jnp.zeros((1,), sampler.row_cdf.dtype),
                          sampler.row_cdf[:-1]]),
         sampler.row_cdf], axis=1,
    )                                                   # [H,2]
    pr = pairs[y]
    row_lo = pr[..., 0]
    row_sum = jnp.maximum(pr[..., 1] - row_lo, 1e-12)
    # TWO-LEVEL column inversion (bit-identical to the dense
    # compare-and-count over cond_cdf[y], see EnvMapSampler): count full
    # blocks by their end-cdf, then count within the boundary block —
    # elements <= target form a prefix of the nondecreasing row, so
    # blk*COL_BLK + in-block count == the dense count exactly, at
    # 1/(W/COL_BLK) of the gather bandwidth.
    target = u_col * row_sum
    nb = sampler.cond_blk.shape[1]
    blk_w = sampler.cond_fine.shape[1]
    cb = sampler.cond_blk[y]                         # [...,NB]
    blk = jnp.sum(cb <= target[..., None], axis=-1).astype(jnp.int32)
    blk = jnp.clip(blk, 0, nb - 1)
    cf = sampler.cond_fine[y * nb + blk]             # [...,COL_BLK]
    x = blk * blk_w + jnp.sum(
        cf <= target[..., None], axis=-1
    ).astype(jnp.int32)
    x = jnp.clip(x, 0, w - 1)

    # Spherical direction at texel center-ish (reference uses texel corner,
    # u=x/W, v=y/H — replicated: render_kernel.cpp:576-579)
    u = x.astype(jnp.float32) / w
    v = y.astype(jnp.float32) / h
    phi = u * 2.0 * jnp.pi
    theta = v * jnp.pi
    sin_t = jnp.sin(theta)
    cos_t = jnp.cos(theta)
    direction = jnp.stack(
        [-sin_t * jnp.cos(phi), -cos_t, -sin_t * jnp.sin(phi)], axis=-1
    )

    from jax.ad_checkpoint import checkpoint_name

    radiance = checkpoint_name(sampler.image[y, x], "isect")
    pdf = pdf_of_texel(sampler, x, y, sin_t)
    return direction, radiance, pdf, sin_t


def _searchsorted_rows(cdf_rows, values):
    """Per-row searchsorted: cdf_rows [...,W], values [...] -> idx [...]."""
    return jnp.sum(cdf_rows <= values[..., None], axis=-1).astype(jnp.int32)


def pdf_of_texel(sampler: EnvMapSampler, x, y, sin_theta):
    """Solid-angle pdf of picking texel (x,y):
    (lum/total) * W*H / (2 pi^2 sin(theta)) (render_kernel.cpp:594-595)."""
    from jax.ad_checkpoint import checkpoint_name

    h, w = sampler.image.shape[0], sampler.image.shape[1]
    lum = jax.lax.stop_gradient(luminance(sampler.image[y, x]))
    # residual-tagged (detached anyway): skip the replay re-gather
    lum = checkpoint_name(lum, "isect")
    pdf = (lum / sampler.total) * (w * h)
    return pdf / jnp.maximum(2.0 * jnp.pi * jnp.pi * sin_theta, 1e-8)


def importance_split(image, min_bin_area: int, min_bin_radiance: float):
    """Hierarchical radiance-bin splitting of an env map.

    Capability parity with the reference's alternative (unused) env-map
    importance structure (Utils::importance_split_skysphere,
    utils.cpp:197-247): recursively halve the image along its longer axis
    until a bin's summed luminance or area falls under the thresholds.
    Host-side numpy; returns a list of (x0, x1, y0, y1) bins.
    """
    import numpy as np

    img = np.asarray(image, np.float32)
    lum = (
        0.3086 * img[..., 0] + 0.6094 * img[..., 1] + 0.0820 * img[..., 2]
    )
    integral = lum.cumsum(axis=0).cumsum(axis=1)

    def area_lum(x0, x1, y0, y1):
        a = integral[y1 - 1, x1 - 1]
        b = integral[y0 - 1, x1 - 1] if y0 > 0 else 0.0
        c = integral[y1 - 1, x0 - 1] if x0 > 0 else 0.0
        d = integral[y0 - 1, x0 - 1] if (x0 > 0 and y0 > 0) else 0.0
        return a - b - c + d

    out = []
    stack = [(0, img.shape[1], 0, img.shape[0])]
    while stack:
        x0, x1, y0, y1 = stack.pop()
        rad = area_lum(x0, x1, y0, y1)
        # NOTE the reference computes area as vertical_extent^2
        # (utils.cpp:201) — an obvious slip; true area is used here
        if (
            rad <= min_bin_radiance
            or (x1 - x0) * (y1 - y0) <= min_bin_area
            or (x1 - x0) < 2
            and (y1 - y0) < 2
        ):
            out.append((x0, x1, y0, y1))
            continue
        if (y1 - y0) >= (x1 - x0):
            ym = y0 + (y1 - y0) // 2
            stack.append((x0, x1, y0, ym))
            stack.append((x0, x1, ym, y1))
        else:
            xm = x0 + (x1 - x0) // 2
            stack.append((x0, xm, y0, y1))
            stack.append((xm, x1, y0, y1))
    return out


def pdf_of_direction(sampler: EnvMapSampler, direction):
    """pdf of a given world direction under luminance sampling, for MIS of
    BRDF-sampled env rays (reference render_kernel.cpp:617-623).

    NOTE: the reference computes sin(theta) there from acos(dir.z) — using the
    *z* component even though its mapping uses y as the polar axis
    (render_kernel.cpp:618).  We use the actual polar angle (y axis) so the
    two MIS pdf evaluations are consistent with each other.
    """
    x, y = texel_coords_of_direction(
        (sampler.image.shape[0], sampler.image.shape[1]), direction
    )
    sin_theta = jnp.sqrt(jnp.maximum(1.0 - direction[..., 1] ** 2, 1e-12))
    return pdf_of_texel(sampler, x, y, sin_theta)
