"""Test config: CPU backend with 8 virtual devices for sharding tests.

Must set env vars BEFORE jax is imported anywhere.  Tests marked ``gpu``
run on the card instead: ``JAX_PLATFORMS=cuda python -m pytest -m gpu -n 0``
(see README.md); the ``gpu_device`` fixture skips them elsewhere.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

from sycl_ray_tracing.ops.pallas import listtrace  # noqa: E402

# the list tracer's kernels compile only for a GPU; here they run in
# Pallas's interpreter
listtrace.INTERPRET = jax.default_backend() != "gpu"

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORNELL_OBJ = os.path.join(REPO, "data", "cornell_box.obj")


@pytest.fixture(scope="session")
def cornell_scene():
    from sycl_ray_tracing.utils.obj_loader import load_scene

    return load_scene(CORNELL_OBJ)


@pytest.fixture(scope="session")
def test_env_map():
    """Small synthetic HDR env map: smooth gradient sky + a bright 'sun'
    patch so importance sampling has real structure to latch onto."""
    h, w = 32, 64
    y, x = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    sky = np.stack(
        [
            0.3 + 0.2 * np.sin(x / w * 2 * np.pi),
            0.4 + 0.3 * (y / h),
            0.6 + 0.1 * np.cos(x / w * 4 * np.pi),
        ],
        axis=-1,
    ).astype(np.float32)
    sky[8:11, 20:24] = 50.0  # sun
    return sky


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test where JAX has none."""
    devices = jax.devices()
    if devices[0].platform != "gpu":
        pytest.skip(f"needs a GPU; JAX runs on {devices[0].platform}")
    return devices[0]


@pytest.fixture(scope="session")
def rng_key():
    return jax.random.PRNGKey(42)


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    """Free compiled executables between test modules.

    The suite compiles hundreds of XLA programs (including interpret-mode
    Pallas kernels inside remat'd scans, which are large); keeping them
    all cached has aborted the CPU compiler with resource exhaustion when
    the whole suite runs in one process.  Module-scoped clearing bounds
    the live set at a small compile-time cost."""
    yield
    jax.clear_caches()
