#!/usr/bin/env python
"""Inverse rendering demo: optimize scene materials (and optionally env-map
texels) to match a target image — the BASELINE.json config-5 capability.

Renders a ground-truth target with the true materials, perturbs them, and
recovers them by gradient descent through the differentiable path tracer,
with the distributed train step (shard_map over the ("data","sample") mesh,
psum'd gradients) when more than one device is visible.

Usage:
  python train.py [--steps=N] [--w=W] [--h=H] [--samples=S] [--scene=cornell]
"""

from __future__ import annotations

import os
import sys
import time


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    steps, W, H, spp, scene_name = 60, 32, 32, 8, "cornell"
    for a in argv:
        if a.startswith("--steps="):
            steps = int(a[8:])
        elif a.startswith("--w="):
            W = int(a[4:])
        elif a.startswith("--h="):
            H = int(a[4:])
        elif a.startswith("--samples="):
            spp = int(a[10:])
        elif a.startswith("--scene="):
            scene_name = a[8:]

    import dataclasses

    import jax
    import jax.numpy as jnp
    import numpy as np
    import optax

    from sycl_ray_tracing.models import pathtracer
    from sycl_ray_tracing.models.camera import PRESETS
    from sycl_ray_tracing.parallel.mesh import best_sample_axis, make_mesh
    from sycl_ray_tracing.parallel.render import make_train_step
    from sycl_ray_tracing.utils.compile_cache import enable_compile_cache
    from sycl_ray_tracing.utils.config import RenderConfig
    from sycl_ray_tracing.utils.obj_loader import load_scene

    enable_compile_cache()
    config = RenderConfig(width=W, height=H, samples=spp, bounces=2,
                          tile_rays=None)
    scene = load_scene(os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "data", "cornell_box.obj"))
    camera = PRESETS[scene_name if scene_name in PRESETS else "cornell"]()

    n_dev = len(jax.devices())
    mesh = make_mesh(n_dev, best_sample_axis(n_dev, spp))
    print(f"mesh: {dict(mesh.shape)}")

    B = W * H

    # perturb the diffuse albedo + roughness
    true_mats = scene.materials
    rng = np.random.default_rng(1)
    init_mats = dataclasses.replace(
        true_mats,
        diffuse=jnp.clip(
            true_mats.diffuse
            + jnp.asarray(rng.uniform(-0.25, 0.25, true_mats.diffuse.shape),
                          jnp.float32),
            0.0, 1.0,
        ),
        roughness=jnp.clip(
            true_mats.roughness
            + jnp.asarray(rng.uniform(-0.2, 0.2, true_mats.roughness.shape),
                          jnp.float32),
            1e-2, 1.0,
        ),
    )

    step_fn = make_train_step(scene, config, mesh, optimize_env=False)
    opt = optax.adam(2e-2)
    mats = init_mats
    opt_state = opt.init((mats.diffuse, mats.roughness))

    ys, xs = jnp.meshgrid(jnp.arange(H, dtype=jnp.float32),
                          jnp.arange(W, dtype=jnp.float32), indexing="ij")
    px, py = xs.reshape(-1), ys.reshape(-1)

    err0_d = float(jnp.abs(init_mats.diffuse - true_mats.diffuse).mean())
    err0_r = float(jnp.abs(init_mats.roughness - true_mats.roughness).mean())
    print(f"init err: diffuse {err0_d:.4f} roughness {err0_r:.4f}")

    t0 = time.time()
    for it in range(steps):
        k = jax.random.fold_in(jax.random.PRNGKey(1000), it)
        loss, (g_mats,) = step_fn(
            mats, None, true_mats, None, camera, px, py, k
        )
        grads = (g_mats.diffuse, g_mats.roughness)
        updates, opt_state = opt.update(grads, opt_state)
        new_d, new_r = optax.apply_updates(
            (mats.diffuse, mats.roughness), updates
        )
        mats = dataclasses.replace(
            mats,
            diffuse=jnp.clip(new_d, 0.0, 1.0),
            roughness=jnp.clip(new_r, 1e-2, 1.0),
        )
        if it % 10 == 0 or it == steps - 1:
            ed = float(jnp.abs(mats.diffuse - true_mats.diffuse).mean())
            er = float(jnp.abs(mats.roughness - true_mats.roughness).mean())
            print(f"step {it:4d} loss {float(loss):.6f} "
                  f"| err diffuse {ed:.4f} roughness {er:.4f}")

    ed = float(jnp.abs(mats.diffuse - true_mats.diffuse).mean())
    er = float(jnp.abs(mats.roughness - true_mats.roughness).mean())
    print(f"done in {time.time()-t0:.1f}s; diffuse err {err0_d:.4f}->{ed:.4f}"
          f" roughness err {err0_r:.4f}->{er:.4f}")
    return 0 if ed < err0_d else 1


if __name__ == "__main__":
    raise SystemExit(main())
