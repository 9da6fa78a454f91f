"""Two-PROCESS distributed rendering: the actual jax.distributed bring-up
path (SURVEY §5 distributed backend), not just the single-process virtual
mesh.  Spawns 2 subprocesses with 4 virtual CPU devices each, forms the
8-device global ("data","sample") mesh over localhost gRPC, renders
sharded, and checks the assembled image equals the single-process render
on an identically-shaped mesh (same mesh position -> same folded RNG
streams -> bitwise-close output)."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.slow
def test_two_process_render_matches_single_process(tmp_path):
    port = _free_port()
    coord = f"127.0.0.1:{port}"
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.join(REPO, "tests",
                                          "distributed_worker.py"),
             coord, "2", str(pid), str(tmp_path)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=600)
        outs.append(out.decode())
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out[-2000:]}"

    # assemble the image from each process's addressable output shards
    H, W = 32, 32
    img = np.full((H, W, 3), np.nan, np.float32)
    for pid in range(2):
        data = np.load(tmp_path / f"shards_{pid}.npz")
        for lo, shard in data.items():
            img[int(lo):int(lo) + shard.shape[0]] = shard
    assert np.isfinite(img).all(), "missing shards"

    # single-process reference on the same mesh SHAPE (8 local devices)
    import jax
    from jax.sharding import Mesh

    from sycl_ray_tracing.models.camera import cornell_box_camera
    from sycl_ray_tracing.parallel.render import render_sharded
    from sycl_ray_tracing.utils.config import RenderConfig
    from sycl_ray_tracing.utils.obj_loader import load_scene

    mesh = Mesh(np.asarray(jax.devices()).reshape(4, 2),
                ("data", "sample"))
    cfg = RenderConfig(width=W, height=H, samples=4, bounces=3,
                       intersect="brute")
    scene = load_scene(os.path.join(REPO, "data", "cornell_box.obj"))
    want = np.asarray(
        render_sharded(scene, cornell_box_camera(), cfg,
                       jax.random.PRNGKey(3), mesh)
    )
    np.testing.assert_allclose(img, want, rtol=1e-5, atol=1e-6)
