#!/usr/bin/env python
"""CLI driver — capability parity with the reference main()
(main.cpp:63-128):

  parse args -> load OBJ -> build BVH -> load HDR env map -> render ->
  report wall-clock -> tone map -> write PNG + HDR outputs.

Reference flags reproduced (--sky=, --w=, --h=, --samples=, --bounces=,
positional OBJ path) plus runtime --camera= / --intersect= replacing the
reference's compile-time switches.  The denoiser (OIDN, dropped per the
north star) is replaced by an optional non-differentiable post hook
(--denoise=N box-guided blend).
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    import jax
    import jax.numpy as jnp

    from sycl_ray_tracing.models import pathtracer
    from sycl_ray_tracing.models.camera import PRESETS
    from sycl_ray_tracing.ops.bvh import build_bvh
    from sycl_ray_tracing.ops.tonemap import tonemap
    from sycl_ray_tracing.utils.compile_cache import enable_compile_cache
    from sycl_ray_tracing.utils.config import parse_cli
    from sycl_ray_tracing.utils.hdr import write_hdr
    from sycl_ray_tracing.utils.image_io import read_image_float
    from sycl_ray_tracing.utils.obj_loader import load_scene
    from sycl_ray_tracing.utils.png import write_png

    config, obj_path, sky_path = parse_cli(argv)
    enable_compile_cache()

    if config.camera not in PRESETS:
        print(f"error: unknown camera {config.camera!r}; "
              f"choose from {sorted(PRESETS)}")
        return 2
    if not os.path.exists(obj_path):
        print(f"error: OBJ file not found: {obj_path}")
        return 2

    from sycl_ray_tracing.utils.metrics import RenderMetrics

    metrics = RenderMetrics()
    print(f"Reading OBJ {obj_path} ...")
    env_img = None
    if sky_path and os.path.exists(sky_path):
        print(f"Reading Environment Map {sky_path} ...")
        env_img = read_image_float(sky_path, flip_y=True)
    elif sky_path:
        print(f"(env map {sky_path} not found; rendering without sky)")

    with metrics.phase("scene_load"):
        scene = load_scene(obj_path, env_map_image=env_img)
    print(f"{scene.num_triangles} triangles, {scene.num_lights} lights")

    if config.intersect == "bvh" and scene.num_triangles > 64:
        t0 = time.time()
        scene = scene.with_bvh(build_bvh(np.asarray(scene.triangles)))
        print(f"BVH build: {(time.time() - t0) * 1000:.0f}ms")
    # "auto" builds clusters: it resolves to the list tracer on a GPU (or
    # the XLA cluster tracer elsewhere) — pathtracer._resolve_backend
    if config.intersect in ("cluster", "list", "auto"):
        t0 = time.time()
        hint = config.tile_rays or config.width * config.height
        scene = scene.build_acceleration(num_rays_hint=hint)
        metrics.timers["accel_build"] = time.time() - t0
        print(f"cluster build: {(time.time() - t0) * 1000:.0f}ms")

    camera = PRESETS[config.camera]()
    print(f"[{config.width}x{config.height}]: {config.samples} samples\n")

    key = jax.random.PRNGKey(0)

    def render(scene, camera, key):
        """Tiled render with in-flight progress prints (the reference
        prints % per scanline band, render_kernel.cpp:205-209).  Each tile
        is one jit dispatch of the same compiled program; np.asarray
        forces device sync so the percentage is real progress."""
        import jax.numpy as jnp

        W, H = config.width, config.height
        tile = config.tile_rays
        if not tile or tile >= W * H:
            if config.samples >= 8:
                # untiled multi-sample renders go through the progressive
                # batcher purely for in-flight % progress (the reference
                # prints % throughout, render_kernel.cpp:205-209); sample
                # streams are keyed by absolute sample index, identical to
                # the --checkpoint path
                from sycl_ray_tracing.models.progressive import (
                    ProgressiveRenderer,
                )

                spb = next(b for b in range(max(1, config.samples // 8),
                                            0, -1)
                           if config.samples % b == 0)
                pr = ProgressiveRenderer(scene, camera, config,
                                         samples_per_batch=spb)
                pr.run(on_batch=lambda st: print(
                    f"{st.samples_done * 100.0 / config.samples:0.6g}%",
                    flush=True))
                return (pr.state.image.reshape(H, W, 3),
                        {"overflow": jnp.asarray(pr.state.overflow)})
            hdr, aux = jax.jit(
                lambda s, c, k: pathtracer.render(s, c, config, k,
                                                  with_aux=True)
            )(scene, camera, key)
            return np.asarray(hdr).reshape(H, W, 3), aux
        B = W * H
        n_tiles = -(-B // tile)
        pad = n_tiles * tile - B
        ys, xs = np.meshgrid(np.arange(H, dtype=np.float32),
                             np.arange(W, dtype=np.float32), indexing="ij")
        px = np.pad(xs.reshape(-1), (0, pad)).reshape(n_tiles, tile)
        py = np.pad(ys.reshape(-1), (0, pad)).reshape(n_tiles, tile)
        tile_fn = jax.jit(
            lambda s, c, tx, ty, k: pathtracer.render_rays(
                s, c, tx, ty, W, H, k, config.samples, config.bounces,
                config.intersect, True, config.estimator,
                config.samples_per_pass, config.max_radiance,
                with_aux=True,
                ggx_bug=(config.ggx_sampler == "reference"),
            )
        )
        out = np.zeros((n_tiles * tile, 3), np.float32)
        overflow = False
        for i in range(n_tiles):
            k = jax.random.fold_in(key, i)
            hdr, aux = tile_fn(scene, camera, jnp.asarray(px[i]),
                               jnp.asarray(py[i]), k)
            out[i * tile:(i + 1) * tile] = np.asarray(hdr)
            overflow = overflow or bool(aux["overflow"])
            print(f"{(i + 1) * 100.0 / n_tiles:0.6g}%", flush=True)
        return (out[:B].reshape(H, W, 3),
                {"overflow": jnp.asarray(overflow)})

    def render_checkpointed(scene, resume_ok=True):
        """Progressive render with checkpoint/resume (the reference cannot
        resume: its tone mapping destroys the linear accumulation,
        render_kernel.cpp:169-180; see models/progressive.py).  Returns
        (hdr, aux) like render(); aux carries the accumulated overflow
        flag so main's budget auto-regrow covers this path too."""
        from sycl_ray_tracing.models.progressive import (
            ProgressiveRenderer,
        )

        if resume_ok and os.path.exists(config.checkpoint):
            pr = ProgressiveRenderer.resume(
                scene, camera, config, config.checkpoint,
                samples_per_batch=config.checkpoint_batch,
            )
            print(f"resuming at {pr.state.samples_done}/"
                  f"{config.samples} samples")
        else:
            pr = ProgressiveRenderer(
                scene, camera, config,
                samples_per_batch=config.checkpoint_batch,
            )
        total = config.samples

        def _tick(state):
            print(f"{state.samples_done * 100.0 / total:0.6g}%",
                  flush=True)

        hdr = pr.run(checkpoint_path=config.checkpoint, on_batch=_tick)
        return hdr, {"overflow": jnp.asarray(pr.state.overflow)}

    t0 = time.time()
    if config.checkpoint:
        hdr, aux = render_checkpointed(scene)
    else:
        hdr, aux = render(scene, camera, key)
    np.asarray(hdr)
    metrics.timers["render"] = time.time() - t0
    metrics.count("rays",
                  config.width * config.height * config.samples
                  * config.bounces)
    print(f"{(time.time() - t0) * 1000:.0f}ms")

    # Traversal overflow means some ray's answer is UNCERTIFIED (list
    # backend: honest any(~resolved & live) flag; cluster backend: pair
    # budget exceeded) — hits MAY have been dropped.  Auto-grow the
    # backend's REAL knob and re-render rather than writing a corrupt
    # image: candidate-list depth (ClusterScene.list_maxc) for the list
    # tracer, pair budgets for the XLA cluster tracer.
    from sycl_ray_tracing.models.pathtracer import _resolve_backend

    for attempt in range(2):
        if scene.clusters is None or not bool(aux["overflow"]):
            break
        cl = scene.clusters
        if _resolve_backend(scene, config.intersect) == "list":
            from sycl_ray_tracing.ops.pallas.listtrace import (
                DEFAULT_MAXC,
            )

            cur = cl.list_maxc or DEFAULT_MAXC
            if cur >= 128:          # packed-winner encoding cap
                print("ERROR: uncertified rays persist at the maximum "
                      "candidate depth (128); image may be missing hits")
                break
            print(
                f"WARNING: uncertified rays at candidate depth "
                f"maxc={cur}; doubling and re-rendering"
            )
            scene = scene.with_clusters(
                cl.with_list_maxc(min(128, cur * 2))
            )
        else:
            print(
                f"WARNING: cluster pair budget overflow "
                f"(p1={cl.p1_budget}, p2={cl.p2_budget}); doubling and "
                f"re-rendering"
            )
            scene = scene.with_clusters(
                cl.with_budgets(cl.p1_budget * 2, cl.p2_budget * 2)
            )
        if config.checkpoint:
            # overflowing batches are already baked into the checkpoint —
            # the accumulation is suspect, so restart it from scratch
            print("(discarding suspect checkpoint and restarting)")
            hdr, aux = render_checkpointed(scene, resume_ok=False)
        else:
            hdr, aux = render(scene, camera, key)
        np.asarray(hdr)
    else:
        if scene.clusters is not None and bool(aux["overflow"]):
            print("ERROR: cluster budgets still overflowing after growth; "
                  "image may be missing hits")

    hdr_np = np.asarray(hdr)
    ldr = np.asarray(tonemap(hdr))
    write_png("RT_output.png", ldr)
    write_hdr("RT_output.hdr", hdr_np)
    outputs = ["RT_output.png", "RT_output.hdr"]

    # denoised blends, like the reference's three OIDN outputs
    # (main.cpp:118-125) but via the in-tree a-trous denoiser
    from sycl_ray_tracing.utils.denoise import denoise

    for blend in (1.0, 0.75, 0.5):
        den = denoise(hdr, blend=blend)
        name = f"RT_output_denoised_{blend:g}.png"
        write_png(name, np.asarray(tonemap(den)))
        outputs.append(name)
    print("wrote " + ", ".join(outputs))
    print(metrics.dump())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
