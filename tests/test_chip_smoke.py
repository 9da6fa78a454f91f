"""chip_smoke.py's phases at tiny sizes on the CPU, and its device gate.

The script itself has no CPU mode: run whole, it refuses to start without
a GPU.  Its phase functions are plain functions, so their checks (and the
references they compare against) are exercised here at test sizes.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def small_dragon():
    from sycl_ray_tracing.utils.procedural import dragon_scene

    return dragon_scene(n_tris=3_000, with_sky=True, sky_res=(16, 32))


def test_refuses_to_run_without_gpu(tmp_path):
    """Run whole on the CPU, the script exits non-zero and prints no
    result line."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                       env=env, capture_output=True, text=True, timeout=300,
                       cwd=tmp_path)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "needs a GPU" in r.stderr


def test_check_device_refuses_cpu():
    with pytest.raises(RuntimeError, match="needs a GPU"):
        chip_smoke.check_device(1)


def test_brute_closest_matches_dense_oracle():
    """The chunked reference equals the dense brute-force intersector,
    including a chunk size that does not divide the triangle count."""
    from sycl_ray_tracing.ops.intersect import intersect_triangles

    rng = np.random.default_rng(0)
    tris = jnp.asarray(rng.uniform(-1, 1, (300, 3, 3)).astype(np.float32))
    o = jnp.asarray(rng.uniform(-2, 2, (64, 3)).astype(np.float32))
    d = rng.normal(size=(64, 3)).astype(np.float32)
    d = jnp.asarray(d / np.linalg.norm(d, axis=1, keepdims=True))
    t, prim = chip_smoke.brute_closest(o, d, tris, chunk=128)
    want = intersect_triangles(o, d, tris)
    m = np.asarray(want.hit)
    np.testing.assert_array_equal(np.asarray(prim) >= 0, m)
    np.testing.assert_array_equal(np.asarray(prim)[m],
                                  np.asarray(want.prim)[m])
    # want.t is recomputed for the winner by finalize_hit: float32 rounding
    # differs in the last bits, within chip_smoke's stated 1e-5
    np.testing.assert_allclose(np.asarray(t)[m], np.asarray(want.t)[m],
                               rtol=1e-5)


def test_traversal_phase(small_dragon):
    r = chip_smoke.compare_traversal(small_dragon, 16, 64)
    assert r["rays"] == 64 and r["hits"] > 0


def test_image_phase(small_dragon):
    r = chip_smoke.compare_image(small_dragon, 8, 2)
    assert r["pixels_close"] >= 0.999


def test_flagship_phase(small_dragon):
    r = chip_smoke.flagship(small_dragon, 16, 1, 2, grad=True, runs=1)
    assert r["backend"] == "cluster"        # auto on the CPU
    assert r["mean"] > 0.0
    assert len(r["fwd_ms"]) == 3 and len(r["fwd_bwd_ms"]) == 3


def test_fd_phase():
    r = chip_smoke.check_fd(width=8, samples=2, bounces=2)
    assert r["backend"] == "cluster" and r["grad"] > 0.0


def test_main_and_train_phases(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)          # main.main writes RT_output.*
    assert chip_smoke.run_main(16, 2, 2)["mean"] > 0.0
    losses = chip_smoke.run_train(8, 1, 2)
    assert len(losses) == 1 and np.isfinite(losses).all()


def test_sharded_train_phase(small_dragon):
    """The 4-card check on 4 virtual CPU devices: the sharded step equals
    its shard-by-shard replay."""
    r = chip_smoke.sharded_train_check(small_dragon, jax.devices(), width=8,
                                       spp=2, bounces=2)
    assert r["mesh"] == {"data": 2, "sample": 2}
    assert np.isclose(r["loss"], r["loss_ref"], rtol=1e-5)
