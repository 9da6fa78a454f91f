"""sycl_ray_tracing — a differentiable path tracer in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of the reference
renderer (TomClabault/SYCL-ray-tracing, C++/OpenMP): path-tracing integrator
with Cook–Torrance BRDF importance sampling, emissive-triangle NEE and
environment-map importance sampling (both MIS-combined with the power
heuristic), BVH-accelerated ray/scene intersection, OBJ/MTL + Radiance HDR
scene I/O, and exposure/gamma tone mapping.

Architecture (a redesign, NOT a translation of the C++):
  * wavefront integrator over flat ray batches, bounce loop as ``lax.scan``
    with alive-masks instead of per-ray control flow
    (reference: per-pixel recursion in source/render_kernel.cpp:75-181)
  * stackless threaded-BVH traversal (skip links, DFS order) instead of the
    reference's recursive priority-queue octree (include/bvh.h:143-209)
  * counter-based threefry RNG keyed by (pixel, sample, bounce, purpose)
    instead of stateful xorshift (include/xorshift.h) so the backward pass
    replays exactly the forward samples
  * everything differentiable end-to-end; gradients w.r.t. materials,
    env-map texels and camera pose
  * scaling via jax.sharding Mesh + shard_map over ray tiles, scene/BVH
    replicated per card, scene-parameter gradients all-reduced
"""

__version__ = "0.1.0"

from sycl_ray_tracing.models.scene import Scene, Materials
from sycl_ray_tracing.models.camera import Camera
from sycl_ray_tracing.utils.config import RenderConfig

__all__ = [
    "Scene",
    "Materials",
    "Camera",
    "RenderConfig",
    "__version__",
]
