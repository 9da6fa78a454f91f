"""Forward-image parity against the ACTUAL compiled C++ reference.

Builds the reference renderer (g++ -fopenmp, OIDN stubbed with an identity
filter — refbuild/stub/) around a parity driver (refbuild/main_parity.cpp)
that renders with a selectable camera and a constant gray env map (a
black sky NaNs the reference's env-CDF sampling), and dumps the RAW
linear float framebuffer.  This framework's render of the same scene at
the same sample count must agree statistically: both are unbiased MC
estimators of the same integral, so 8x8-block box-downsampled images
(effective spp x 64 samples per block) must match within a few percent.

Pins the BASELINE north-star clause "forward image allclose vs reference
semantics at equal sample counts" to the reference binary itself
(main.cpp:63-128, render_kernel.cpp:75-181) instead of internal
cross-checks.
"""

import os
import subprocess

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFBUILD = os.path.join(REPO, "refbuild")
BINARY = os.path.join(REFBUILD, "ref_parity")
REF_SRC = "/root/reference/source"

W, H, SPP, BOUNCES = 128, 128, 32, 8


def _build_binary():
    if os.path.exists(BINARY):
        return True
    srcs = [
        os.path.join(REF_SRC, f)
        for f in os.listdir(REF_SRC)
        if f.endswith(".cpp") and f not in ("main.cpp", "tests.cpp")
    ]
    cmd = [
        "g++", "-O2", "-fopenmp", "-std=c++20",
        "-I/root/reference/include", "-I/root/reference/rapidobj",
        "-I/root/reference/stbi", "-I" + os.path.join(REFBUILD, "stub"),
        os.path.join(REFBUILD, "main_parity.cpp"), *srcs,
        "-o", BINARY, "-lpthread",
    ]
    return subprocess.run(cmd, capture_output=True).returncode == 0


def _read_f32(path):
    with open(path, "rb") as f:
        header = b""
        while not header.endswith(b"\n"):
            header += f.read(1)
        tag, w, h = header.split()
        assert tag == b"P6f"
        data = np.fromfile(f, np.float32, int(w) * int(h) * 3)
    return data.reshape(int(h), int(w), 3)


def _block_mean(img, b=8):
    h, w, _ = img.shape
    return img.reshape(h // b, b, w // b, b, 3).mean(axis=(1, 3))


@pytest.mark.slow
def test_cornell_matches_reference_binary(tmp_path):
    if not _build_binary():
        pytest.skip("g++ or reference sources unavailable")
    out = tmp_path / "ref_image.f32"
    rc = subprocess.run(
        [BINARY, "/root/reference/data/OBJs/cornell_pbr.obj",
         f"--w={W}", f"--h={H}", f"--samples={SPP}",
         f"--bounces={BOUNCES}", "--camera=cornell", "--skyval=0.5",
         f"--out={out}"],
        capture_output=True, timeout=600,
    )
    assert rc.returncode == 0, rc.stderr.decode()[:500]
    ref = _read_f32(out)

    import jax

    from sycl_ray_tracing.models import pathtracer
    from sycl_ray_tracing.models.camera import cornell_box_camera
    from sycl_ray_tracing.utils.config import RenderConfig
    from sycl_ray_tracing.utils.obj_loader import load_scene

    # ggx_sampler="reference" replicates the reference's biased sampler
    # (missing sqrt, render_kernel.cpp:404) so the comparison is
    # bug-for-bug; with the corrected sampler the images differ visibly on
    # the near-mirror walls (that deviation is deliberate and documented
    # in ops/brdf.py).
    cfg = RenderConfig(width=W, height=H, samples=SPP, bounces=BOUNCES,
                       intersect="brute", estimator="parity",
                       ggx_sampler="reference")
    sky = np.full((16, 8, 3), 0.5, np.float32)
    scene = load_scene("/root/reference/data/OBJs/cornell_pbr.obj",
                       env_map_image=sky)
    img = np.asarray(
        pathtracer.render(scene, cornell_box_camera(), cfg,
                          jax.random.PRNGKey(7))
    ).reshape(H, W, 3)

    assert np.isfinite(ref).all() and np.isfinite(img).all()
    # The reference's frame buffer is ALREADY tone-mapped in-place
    # (render_kernel.cpp:171-180: 1-exp(-1.5x) then gamma 1/2.2) — apply
    # the same mapping to our linear HDR before comparing.
    img = np.clip(1.0 - np.exp(-img * 1.5), 0.0, 1.0) ** (1.0 / 2.2)

    # overall brightness within 1%
    np.testing.assert_allclose(img.mean(), ref.mean(), rtol=0.01)
    # 8x8-block means: same lighting structure within MC bounds
    # (independent RNG streams at 32 spp -> a few % noise per block)
    rb, ob = _block_mean(ref), _block_mean(img)
    denom = np.maximum(rb, 0.05)  # ignore relative error in near-black
    rel = np.abs(ob - rb) / denom
    assert np.quantile(rel, 0.99) < 0.20, f"p99 rel err {np.quantile(rel, 0.99):.3f}"
    assert rel.max() < 0.35, f"max rel err {rel.max():.3f}"


@pytest.mark.slow
def test_env_map_matches_reference_binary(tmp_path):
    """Env-CDF importance sampling + env MIS pinned against the compiled
    reference with a NON-CONSTANT synthetic HDR (utils.cpp:126-142,
    render_kernel.cpp:532-567,569-631).  Scene: the reference's open Veach
    MIS plates (MIS.obj), where all lighting is env light — direct sky on
    primary misses, env NEE + MIS at every hit.  Both sides read the SAME
    .hdr file through their own Radiance decoders (the reference via
    stbi_loadf, main.cpp:86-89 path; ours via utils.image_io)."""
    if not _build_binary():
        pytest.skip("g++ or reference sources unavailable")

    from sycl_ray_tracing.utils.hdr import write_hdr
    from sycl_ray_tracing.utils.procedural import procedural_sky

    w = h = 64
    spp, bounces = 8, 4
    sky_path = str(tmp_path / "sky.hdr")
    # smooth gradient + ground + bright sun disc: strongly non-uniform, so
    # a wrong CDF/pdf or a flipped direction convention shifts block means
    # far beyond the tolerances below
    write_hdr(sky_path, procedural_sky(32, 64, sun_intensity=40.0))

    out = tmp_path / "ref_mis.f32"
    rc = subprocess.run(
        [BINARY, "/root/reference/data/OBJs/MIS.obj",
         f"--w={w}", f"--h={h}", f"--samples={spp}",
         f"--bounces={bounces}", "--camera=cornell",
         f"--sky={sky_path}", f"--out={out}"],
        capture_output=True, timeout=600,
    )
    assert rc.returncode == 0, rc.stderr.decode()[:500]
    ref = _read_f32(out)

    import jax

    from sycl_ray_tracing.models import pathtracer
    from sycl_ray_tracing.models.camera import cornell_box_camera
    from sycl_ray_tracing.ops.bvh import build_bvh
    from sycl_ray_tracing.utils.config import RenderConfig
    from sycl_ray_tracing.utils.image_io import read_image_float
    from sycl_ray_tracing.utils.obj_loader import load_scene

    env = read_image_float(sky_path, flip_y=True)  # mirrors main.py/main.cpp
    scene = load_scene("/root/reference/data/OBJs/MIS.obj",
                       env_map_image=env)
    scene = scene.with_bvh(build_bvh(np.asarray(scene.triangles)))
    cfg = RenderConfig(width=w, height=h, samples=spp, bounces=bounces,
                       intersect="bvh", estimator="parity",
                       ggx_sampler="reference")
    img = np.asarray(
        pathtracer.render(scene, cornell_box_camera(), cfg,
                          jax.random.PRNGKey(7))
    ).reshape(h, w, 3)
    assert np.isfinite(ref).all() and np.isfinite(img).all()
    # reference tone-maps its frame buffer in place (render_kernel.cpp:171)
    img = np.clip(1.0 - np.exp(-img * 1.5), 0.0, 1.0) ** (1.0 / 2.2)

    np.testing.assert_allclose(img.mean(), ref.mean(), rtol=0.01)
    rb, ob = _block_mean(ref), _block_mean(img)
    rel = np.abs(ob - rb) / np.maximum(rb, 0.05)
    # measured at these settings: p99 ~0.015, max ~0.020
    assert np.quantile(rel, 0.99) < 0.10, f"p99 {np.quantile(rel, 0.99):.3f}"
    assert rel.max() < 0.15, f"max rel err {rel.max():.3f}"
