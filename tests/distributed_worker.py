"""Worker process for the two-process distributed test.

Run as: python distributed_worker.py <coordinator> <nprocs> <pid> <outdir>

Each process owns 4 virtual CPU devices; together they form the same
8-device ("data","sample") global mesh the single-process tests use.
Renders a small cornell frame with render_sharded and dumps this
process's addressable output shards for the parent to assemble.
"""

import os
import sys


def main():
    coordinator, nprocs, pid, outdir = (
        sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    )
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=4"
    ).strip()

    import jax

    jax.config.update("jax_platforms", "cpu")

    import numpy as np

    from sycl_ray_tracing.parallel import distributed

    # the real multi-process bring-up path (SURVEY §5 distributed backend):
    # DCN-style coordination over localhost gRPC
    distributed.initialize(coordinator_address=coordinator,
                           num_processes=nprocs, process_id=pid)
    assert jax.process_count() == nprocs, jax.process_count()
    assert len(jax.devices()) == 4 * nprocs
    assert distributed.is_coordinator() == (pid == 0)

    from sycl_ray_tracing.models.camera import cornell_box_camera
    from sycl_ray_tracing.parallel.render import render_sharded
    from sycl_ray_tracing.utils.config import RenderConfig
    from sycl_ray_tracing.utils.obj_loader import load_scene

    mesh = distributed.global_mesh(sample_axis=2)
    assert mesh.devices.shape == (2 * nprocs, 2)

    cfg = RenderConfig(width=32, height=32, samples=4, bounces=3,
                       intersect="brute")
    scene = load_scene(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "data", "cornell_box.obj"))
    img = render_sharded(scene, cornell_box_camera(), cfg,
                         jax.random.PRNGKey(3), mesh)

    shards = {}
    for s in img.addressable_shards:
        lo = s.index[0].start or 0
        shards[str(lo)] = np.asarray(s.data)
    np.savez(os.path.join(outdir, f"shards_{pid}.npz"), **shards)
    print(f"worker {pid}: ok ({len(shards)} shards)")


if __name__ == "__main__":
    main()
