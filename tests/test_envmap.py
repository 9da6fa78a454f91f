"""Environment map: lookup round-trip, CDF sampling distribution, pdf."""

import jax
import jax.numpy as jnp
import numpy as np

from sycl_ray_tracing.ops import envmap


def test_eval_direction_picks_expected_texel(test_env_map):
    img = jnp.asarray(test_env_map)
    # direction convention (render_kernel.cpp:586): texel (x,y) maps to
    # dir = (-sin(t)cos(p), -cos(t), -sin(t)sin(p)), p=2πx/W, t=πy/H
    h, w = img.shape[:2]
    for (x, y) in [(5, 10), (30, 20), (60, 3)]:
        phi = x / w * 2 * np.pi
        theta = y / h * np.pi
        d = jnp.array(
            [
                [-np.sin(theta) * np.cos(phi),
                 -np.cos(theta),
                 -np.sin(theta) * np.sin(phi)]
            ],
            jnp.float32,
        )
        val = envmap.eval_direction(img, d)
        np.testing.assert_allclose(val[0], img[y, x], rtol=1e-5)


def test_sampling_proportional_to_luminance(test_env_map):
    sampler = envmap.build_sampler(jnp.asarray(test_env_map))
    key = jax.random.PRNGKey(0)
    B = 200_000
    u = jax.random.uniform(key, (B, 2))
    _, rad, pdf, _ = envmap.sample(sampler, u[:, 0], u[:, 1])
    # the bright 'sun' patch (rows 8:11, cols 20:24 at 50.0) holds most of
    # the total luminance — sampling must concentrate there
    lum = np.asarray(
        0.3086 * rad[:, 0] + 0.6094 * rad[:, 1] + 0.0820 * rad[:, 2]
    )
    sun_frac_samples = (lum > 10.0).mean()
    lum_img = np.asarray(sampler.row_cdf)[-1]
    sun_lum = 50.0 * (0.3086 + 0.6094 + 0.0820) * 3 * 4
    expected = sun_lum / lum_img
    assert abs(sun_frac_samples - expected) < 0.02, (sun_frac_samples, expected)


def test_pdf_integrates_to_one(test_env_map):
    """MC estimate of ∫ pdf dω via importance sampling: E[1] = 1."""
    sampler = envmap.build_sampler(jnp.asarray(test_env_map))
    key = jax.random.PRNGKey(1)
    B = 100_000
    u = jax.random.uniform(key, (B, 2))
    d, _, pdf, sin_t = envmap.sample(sampler, u[:, 0], u[:, 1])
    # estimate total solid angle: E[1/pdf] should be ~4π
    est = float(jnp.mean(1.0 / jnp.maximum(pdf, 1e-12)))
    assert abs(est - 4 * np.pi) / (4 * np.pi) < 0.05, est


def test_pdf_of_direction_matches_sample_pdf(test_env_map):
    sampler = envmap.build_sampler(jnp.asarray(test_env_map))
    key = jax.random.PRNGKey(2)
    u = jax.random.uniform(key, (1024, 2))
    d, _, pdf, _ = envmap.sample(sampler, u[:, 0], u[:, 1])
    pdf2 = envmap.pdf_of_direction(sampler, d)
    rel = np.abs(np.asarray(pdf) - np.asarray(pdf2)) / np.maximum(
        np.asarray(pdf), 1e-9
    )
    # texel-rounding can move a direction to a neighbour texel; check the bulk
    assert np.quantile(rel, 0.9) < 0.2


def test_texel_gradients_flow(test_env_map):
    """d(lookup)/d(texels) is a one-hot scatter."""
    img = jnp.asarray(test_env_map)

    def f(image):
        d = jnp.array([[0.0, -1.0, 0.0]])  # top pole
        return jnp.sum(envmap.eval_direction(image, d))

    g = jax.grad(f)(img)
    assert float(jnp.sum(g)) == 3.0  # one texel, 3 channels
    assert np.isfinite(np.asarray(g)).all()


def test_two_level_inversion_bit_identical_to_dense():
    """The block-end + boundary-block column inversion must produce the
    EXACT texel the dense compare-and-count picks, including rows with
    zero-luminance runs (duplicate cdf values across block boundaries)."""
    import numpy as np

    from sycl_ray_tracing.ops import envmap

    rng = np.random.default_rng(3)
    h, w = 16, 96  # not a multiple of COL_BLK=32? 96 = 3 blocks exactly;
    lum = rng.random((h, w)).astype(np.float32)
    lum[:, 20:50] = 0.0          # zero run spanning a block boundary
    img = np.repeat(lum[..., None], 3, axis=2) / np.array(
        [0.3086 * 3, 0.6094 * 3, 0.0820 * 3], np.float32
    )
    s = envmap.build_sampler(jnp.asarray(img))
    u_row = jnp.asarray(rng.random(512), jnp.float32)
    u_col = jnp.asarray(rng.random(512), jnp.float32)
    _, _, _, _ = envmap.sample(s, u_row, u_col)

    # dense reference: same row pick, dense count over cond_cdf
    y = jnp.sum(s.row_cdf <= (u_row * s.total)[:, None], axis=-1)
    y = jnp.clip(y, 0, h - 1).astype(jnp.int32)
    pairs_lo = jnp.concatenate([jnp.zeros((1,)), s.row_cdf[:-1]])[y]
    row_sum = jnp.maximum(s.row_cdf[y] - pairs_lo, 1e-12)
    target = u_col * row_sum
    dense_x = jnp.clip(
        jnp.sum(s.cond_cdf[y] <= target[:, None], axis=-1), 0, w - 1
    )
    # two-level (what sample() uses internally)
    nb = s.cond_blk.shape[1]
    blk_w = s.cond_fine.shape[1]
    blk = jnp.clip(
        jnp.sum(s.cond_blk[y] <= target[:, None], axis=-1), 0, nb - 1
    ).astype(jnp.int32)
    two_x = jnp.clip(
        blk * blk_w
        + jnp.sum(s.cond_fine[y * nb + blk] <= target[:, None], axis=-1),
        0, w - 1,
    )
    np.testing.assert_array_equal(np.asarray(dense_x), np.asarray(two_x))


def test_two_level_inversion_odd_width():
    """Widths that do not divide COL_BLK pad the last block with +inf;
    counts must still match the dense inversion."""
    import numpy as np

    from sycl_ray_tracing.ops import envmap

    rng = np.random.default_rng(7)
    h, w = 8, 45  # 45 = 1 full block + 13-wide padded tail
    img = rng.random((h, w, 3)).astype(np.float32)
    s = envmap.build_sampler(jnp.asarray(img))
    u = jnp.asarray(rng.random(256), jnp.float32)
    v = jnp.asarray(rng.random(256), jnp.float32)
    d, rad, pdf, _ = envmap.sample(s, u, v)
    assert np.isfinite(np.asarray(d)).all()
    assert np.isfinite(np.asarray(pdf)).all()
    # cross-check against dense counting
    y = jnp.clip(jnp.sum(s.row_cdf <= (u * s.total)[:, None], axis=-1),
                 0, h - 1).astype(jnp.int32)
    lo = jnp.concatenate([jnp.zeros((1,)), s.row_cdf[:-1]])[y]
    t = v * jnp.maximum(s.row_cdf[y] - lo, 1e-12)
    dense_x = jnp.clip(jnp.sum(s.cond_cdf[y] <= t[:, None], axis=-1),
                       0, w - 1)
    exp_rad = s.image[y, dense_x]
    np.testing.assert_allclose(np.asarray(rad), np.asarray(exp_rad))
