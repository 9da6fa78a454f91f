"""The list tracer's compiled kernels on the card (skipped without a GPU).

tests/test_pallas_listtrace.py pins the kernels' semantics in Pallas's
interpreter; these run the Triton-compiled kernels and compare them with
the brute-force oracle.  On the card, in one process:

    JAX_PLATFORMS=cuda python -m pytest -m gpu -n 0
"""

import jax.numpy as jnp
import numpy as np
import pytest

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("share", [False, True])
def test_golden_rays_compiled_kernels(gpu_device, cornell_scene, share):
    """The closed-form golden rays through both compiled kernel shapes."""
    from sycl_ray_tracing.ops.cluster import BIG_T, build_clusters
    from sycl_ray_tracing.ops.pallas.listtrace import closest_hit
    from test_golden_rays import _golden_data

    hit_rays, expected_pts, _wall, miss_rays = _golden_data()
    cs = build_clusters(np.asarray(cornell_scene.triangles))
    t, _prim, _of = closest_hit(cs, jnp.asarray(hit_rays[:, :3]),
                                jnp.asarray(hit_rays[:, 3:]), share=share)
    t = np.asarray(t)
    assert (t < BIG_T).all()
    pts = hit_rays[:, :3] + t[:, None] * hit_rays[:, 3:]
    assert np.abs(pts - expected_pts).max() < 1e-5
    t_m, prim_m, _of = closest_hit(cs, jnp.asarray(miss_rays[:, :3]),
                                   jnp.asarray(miss_rays[:, 3:]), share=share)
    assert (np.asarray(t_m) >= BIG_T).all()
    assert (np.asarray(prim_m) < 0).all()


def test_dragon_traversal_matches_brute_force(gpu_device):
    """chip_smoke's traversal check at a test size: the scene's own tracer
    (the list path on a GPU) against chunked brute force."""
    import chip_smoke
    from sycl_ray_tracing.models.pathtracer import _resolve_backend
    from sycl_ray_tracing.utils.procedural import dragon_scene

    scene = dragon_scene(n_tris=20_000, with_sky=True, sky_res=(32, 64))
    assert _resolve_backend(scene, "auto") == "list"
    r = chip_smoke.compare_traversal(scene, 128, 1024)
    assert r["hits"] > 0
