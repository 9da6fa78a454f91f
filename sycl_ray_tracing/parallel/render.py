"""Sharded rendering and distributed inverse-rendering steps.

Design (SURVEY.md §5/§7.7, scaling-book recipe):
  * pixels flattened to a ray list, padded, sharded over the "data" axis
  * spp divided over the "sample" axis; each shard renders its slice of
    samples with a distinct folded key; psum over "sample" averages them
  * scene + BVH replicated per chip (pure-DP analogue)
  * inverse rendering: per-shard grads psum'd over BOTH axes — XLA hands
    the all-reduce to NCCL over the cards' links (NVLink within a host)

All collectives are XLA collectives via shard_map — no hand-rolled comms.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P
from jax import shard_map

from sycl_ray_tracing.models import pathtracer
from sycl_ray_tracing.models.camera import Camera
from sycl_ray_tracing.models.scene import Scene
from sycl_ray_tracing.parallel.mesh import pad_to_multiple
from sycl_ray_tracing.utils.config import RenderConfig


def render_sharded(scene: Scene, camera: Camera, config: RenderConfig,
                   key, mesh: Mesh):
    """Full-frame render sharded over the mesh -> HDR [H,W,3] (replicated).

    Equivalent in semantics to models.pathtracer.render for a sample count
    of config.samples; sample keys are folded per sample-shard so the
    estimate differs from single-chip only by RNG stream assignment.
    """
    W, H = config.width, config.height
    n_data = mesh.shape["data"]
    n_sample = mesh.shape["sample"]
    if config.samples % n_sample != 0:
        raise ValueError("samples must divide over the sample axis")
    spp_shard = config.samples // n_sample

    B = W * H
    Bp = pad_to_multiple(B, n_data)
    ys, xs = jnp.meshgrid(
        jnp.arange(H, dtype=jnp.float32),
        jnp.arange(W, dtype=jnp.float32),
        indexing="ij",
    )
    px = jnp.pad(xs.reshape(-1), (0, Bp - B))
    py = jnp.pad(ys.reshape(-1), (0, Bp - B))

    def shard_fn(scene, camera, px, py, key):
        # px/py arrive as this shard's slice; key is replicated
        k = shard_key(key, jax.lax.axis_index("sample"),
                      jax.lax.axis_index("data"))
        hdr = pathtracer.render_rays(
            scene, camera, px, py, W, H, k, spp_shard, config.bounces,
            config.intersect, True, config.estimator,
        )
        return jax.lax.pmean(hdr, "sample")

    # check_vma=False: the bounce/sample scan carries are initialized from
    # replicated constants but become mesh-varying through the folded keys —
    # semantically fine, but trips shard_map's static vma check.
    fn = shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(), P(), P("data"), P("data"), P()),
        out_specs=P("data"),
        check_vma=False,
    )
    hdr = fn(scene, camera, px, py, key)
    return hdr[:B].reshape(H, W, 3)


def render_sharded_jit(scene: Scene, camera: Camera, config: RenderConfig,
                      key, mesh: Mesh):
    """jit-wrapped render_sharded (config/mesh static via closure)."""
    f = jax.jit(lambda s, c, k: render_sharded(s, c, config, k, mesh))
    return f(scene, camera, key)


def _shard_render(materials, env_image, camera, scene: Scene,
                  px, py, config: RenderConfig, key, spp_shard: int):
    """Render this shard's rays/samples with the given scene parameters."""
    scene = scene.with_materials(materials)
    if env_image is not None:
        scene = scene.with_env_map(env_image)
    return pathtracer.render_rays(
        scene, camera, px, py, config.width, config.height, key,
        spp_shard, config.bounces, config.intersect, True, config.estimator,
    )


def shard_key(key, s_idx, d_idx):
    """The RNG key of mesh position (sample s_idx, data d_idx)."""
    return jax.random.fold_in(jax.random.fold_in(key, s_idx), d_idx)


def shard_loss_and_grads(scene: Scene, config: RenderConfig, spp_shard: int,
                         optimize_env: bool, materials, env_image,
                         target_materials, target_env, camera, px, py, k):
    """One shard's (loss, grads) of the inverse-rendering step: renders the
    target and the guess under the SAME key (common random numbers) and
    differentiates the log1p-space MSE w.r.t. the materials (and the env
    texels when ``optimize_env``)."""
    target = jax.lax.stop_gradient(
        _shard_render(
            target_materials, target_env, camera, scene, px, py,
            config, k, spp_shard,
        )
    )
    args = (materials, env_image) if optimize_env else (materials,)

    def loss_fn(*diff_args):
        mats = diff_args[0]
        env = diff_args[1] if optimize_env else env_image
        hdr = _shard_render(
            mats, env, camera, scene, px, py, config, k, spp_shard
        )
        a = jnp.log1p(jnp.maximum(hdr, 0.0))
        b = jnp.log1p(jnp.maximum(target, 0.0))
        return jnp.mean((a - b) ** 2)

    return jax.value_and_grad(loss_fn, argnums=tuple(range(len(args))))(
        *args
    )


def make_train_step(scene: Scene, config: RenderConfig, mesh: Mesh,
                    optimize_env: bool = True):
    """Build a jitted distributed inverse-rendering step.

    step(materials, env_image, target_materials, target_env, camera,
         px, py, key) -> (loss, grads)

    The target is rendered INSIDE the step with the SAME per-shard RNG
    streams as the guess (common random numbers): the MC noise cancels in
    the residual, so the loss is exactly 0 at the true parameters and the
    gradient signal isn't buried under the sampling-noise floor (which is
    ~7x larger than a 0.2-albedo perturbation at low spp).  Loss is MSE in
    log1p space so emitter pixels (~100x brighter) don't drown materials.

    Per-shard gradients are mean-reduced over the whole mesh inside
    shard_map (an all-reduce that XLA can overlap with the backward pass).
    shard_loss_and_grads is the per-shard body, exposed so a check can
    replay the step shard by shard on one device.
    """
    n_sample = mesh.shape["sample"]
    spp_shard = max(1, config.samples // n_sample)

    def shard_fn(materials, env_image, target_materials, target_env,
                 camera, px, py, key):
        s_idx = jax.lax.axis_index("sample")
        d_idx = jax.lax.axis_index("data")
        loss, grads = shard_loss_and_grads(
            scene, config, spp_shard, optimize_env, materials, env_image,
            target_materials, target_env, camera, px, py,
            shard_key(key, s_idx, d_idx),
        )
        loss = jax.lax.pmean(jax.lax.pmean(loss, "sample"), "data")
        grads = jax.tree.map(
            lambda g: jax.lax.pmean(jax.lax.pmean(g, "sample"), "data"), grads
        )
        return loss, grads

    fn = shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(), P(), P(), P(), P(), P("data"), P("data"), P()),
        out_specs=(P(), P()),
        check_vma=False,
    )
    return jax.jit(fn)
