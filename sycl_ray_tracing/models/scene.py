"""Scene representation: structure-of-arrays pytrees.

Redesign of the reference's AoS buffers (parsed_obj.h:9-16,
simple_material.h:6-13): triangles [N,3,3], material SoA, emissive index
list, optional spheres, environment map + sampler tables, optional BVH.

Everything is a registered pytree of jnp arrays so a Scene can flow through
jit/grad/shard_map; material fields and env texels are differentiable leaves.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import jax
import jax.numpy as jnp
import numpy as np

from sycl_ray_tracing.ops.envmap import EnvMapSampler, build_sampler


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Materials:
    """SoA material table (reference SimpleMaterial, simple_material.h:6-13).

    Index 0 is the magenta debug/default material; OBJ materials are mapped
    with a +1 offset (reference utils.cpp:53-56,75).
    """

    emission: jnp.ndarray   # [M,3]
    diffuse: jnp.ndarray    # [M,3]
    metalness: jnp.ndarray  # [M]
    roughness: jnp.ndarray  # [M] (clamped >= 1e-2 at load, utils.cpp:82)

    @property
    def count(self) -> int:
        return self.emission.shape[0]

    def lookup(self, idx: jnp.ndarray):
        """Gather per-ray material parameters by index [...].

        ONE row-gather of a packed [M,8] table instead of four narrow
        gathers.  The packing concat is [M,8] (tiny) and fully
        differentiable.
        """
        packed = jnp.concatenate(
            [
                self.emission,
                self.diffuse,
                self.metalness[:, None],
                self.roughness[:, None],
            ],
            axis=1,
        )
        rows = packed[idx]
        return rows[..., 0:3], rows[..., 3:6], rows[..., 6], rows[..., 7]


DEFAULT_MATERIAL = dict(
    emission=(1.0, 0.0, 1.0),  # magenta debug emission (utils.cpp:75)
    diffuse=(0.0, 0.0, 0.0),
    metalness=0.0,
    roughness=1.0,
)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Scene:
    """Complete render scene as one pytree.

    material_indices maps triangle index -> material row; sphere_material
    maps sphere index -> material row (the reference threads sphere material
    through a fake primitive index, sphere.h:49 + main.cpp:20-30; here it is
    explicit).
    """

    triangles: jnp.ndarray            # [N,3,3] float32
    materials: Materials
    material_indices: jnp.ndarray     # [N] int32
    emissive_indices: jnp.ndarray     # [K] int32 (triangle ids with Ke>0)
    sphere_centers: jnp.ndarray       # [S,3]
    sphere_radii: jnp.ndarray         # [S]
    sphere_material: jnp.ndarray      # [S] int32
    env_map: Optional[EnvMapSampler]  # None -> black sky
    bvh: Optional[Any]                # ops.bvh.ThreadedBVH or None
    clusters: Optional[Any] = None    # ops.cluster.ClusterScene or None
    tri_areas: Optional[jnp.ndarray] = None  # [N] precomputed areas
    # Cluster-SLOT shading table (aligned with clusters.cl_tri_idx):
    # [K2,T] i32, tri_idx | material_id << 20.  ONE gather by the list
    # kernel's packed (cluster,lane) winner resolves prim AND material,
    # replacing the per-primitive [N,8]/[N,4] row gathers; emitter areas
    # are gathered from the 1-D tri_areas table.
    slot_packed: Optional[jnp.ndarray] = None

    @property
    def num_triangles(self) -> int:
        return self.triangles.shape[0]

    @property
    def num_spheres(self) -> int:
        return self.sphere_centers.shape[0]

    @property
    def num_lights(self) -> int:
        return self.emissive_indices.shape[0]

    def with_env_map(self, image: jnp.ndarray) -> "Scene":
        return dataclasses.replace(self, env_map=build_sampler(image))

    def with_bvh(self, bvh) -> "Scene":
        return dataclasses.replace(self, bvh=bvh)

    def with_clusters(self, clusters) -> "Scene":
        return dataclasses.replace(self, clusters=clusters)

    def build_acceleration(self, num_rays_hint: int = 32768) -> "Scene":
        """Build the default acceleration structure (wavefront clusters).

        ``num_rays_hint`` sizes the static pair budgets and MUST match the
        wavefront TILE size (RenderConfig.tile_rays), NOT the image size —
        the phase-3 gather allocates budget*cluster_row bytes (a 512x512
        hint with 200k triangles would ask for >20 GB)."""
        import numpy as np

        from sycl_ray_tracing.ops.cluster import (
            build_clusters,
            default_budgets,
        )

        tris = np.asarray(self.triangles)
        cs = build_clusters(tris, order="sah")
        p1, p2 = default_budgets(num_rays_hint, cs.num_superclusters)
        scene = self.with_clusters(cs.with_budgets(p1, p2))
        return dataclasses.replace(scene, **_slot_tables(scene))

    def with_materials(self, materials: Materials) -> "Scene":
        return dataclasses.replace(self, materials=materials)


def _slot_tables(scene: "Scene") -> dict:
    """Precompute the cluster-slot shading tables (see Scene.slot_packed).

    Host-side numpy — runs once at accel-build time.  The 20/11-bit
    packing matches the list tracer's 1M-triangle limit
    (listtrace.supports: <=8192 clusters * 128 slots)."""
    if scene.clusters is None:
        return {}
    idx = np.asarray(scene.clusters.cl_tri_idx)           # [K2,T]
    n = scene.num_triangles
    mcount = scene.materials.count
    if n > (1 << 20) or mcount > (1 << 11):
        return {}  # packing would overflow; integrator falls back
    valid = idx >= 0
    ci = np.clip(idx, 0, max(0, n - 1))
    matid = np.asarray(scene.material_indices)[ci]
    sp = np.where(valid, idx, 0).astype(np.int32) | (
        np.where(valid, matid, 0).astype(np.int32) << 20
    )
    return dict(slot_packed=jnp.asarray(sp))


def make_scene(
    triangles,
    material_indices,
    materials: Materials,
    emissive_indices=None,
    sphere_centers=None,
    sphere_radii=None,
    sphere_material=None,
    env_map_image=None,
) -> Scene:
    """Assemble a Scene from host arrays, deriving emissive indices from
    material emission if not given (reference utils.cpp:58-69)."""
    triangles = jnp.asarray(triangles, jnp.float32)
    material_indices = jnp.asarray(material_indices, jnp.int32)

    if emissive_indices is None:
        em = np.asarray(materials.emission)
        mi = np.asarray(material_indices)
        is_emissive = (em[mi] > 0.0).any(axis=-1)
        # row 0 is the debug material, never a light (utils.cpp:58-69 only
        # collects real MTL emitters)
        is_emissive &= mi > 0
        emissive_indices = np.nonzero(is_emissive)[0]
    emissive_indices = jnp.asarray(emissive_indices, jnp.int32)

    if sphere_centers is None:
        sphere_centers = jnp.zeros((0, 3), jnp.float32)
        sphere_radii = jnp.zeros((0,), jnp.float32)
        sphere_material = jnp.zeros((0,), jnp.int32)

    env = None
    if env_map_image is not None:
        env = build_sampler(jnp.asarray(env_map_image, jnp.float32))

    from sycl_ray_tracing.ops.sampling import triangle_area

    return Scene(
        triangles=triangles,
        materials=materials,
        material_indices=material_indices,
        emissive_indices=emissive_indices,
        sphere_centers=jnp.asarray(sphere_centers, jnp.float32),
        sphere_radii=jnp.asarray(sphere_radii, jnp.float32),
        sphere_material=jnp.asarray(sphere_material, jnp.int32),
        env_map=env,
        bvh=None,
        tri_areas=triangle_area(triangles),
    )


def add_sphere(scene: Scene, center, radius: float,
               emission=(0.0, 0.0, 0.0), diffuse=(1.0, 1.0, 1.0),
               metalness: float = 0.0, roughness: float = 0.5) -> Scene:
    """Insert an analytic sphere with its own material (the reference's
    add_sphere_to_scene helper, main.cpp:20-30, made a real API)."""
    mats = scene.materials
    row = mats.count
    new_mats = Materials(
        emission=jnp.concatenate(
            [mats.emission, jnp.asarray([emission], jnp.float32)]
        ),
        diffuse=jnp.concatenate(
            [mats.diffuse, jnp.asarray([diffuse], jnp.float32)]
        ),
        metalness=jnp.concatenate(
            [mats.metalness, jnp.asarray([metalness], jnp.float32)]
        ),
        roughness=jnp.concatenate(
            [mats.roughness,
             jnp.asarray([max(1e-2, roughness)], jnp.float32)]
        ),
    )
    return dataclasses.replace(
        scene,
        materials=new_mats,
        sphere_centers=jnp.concatenate(
            [scene.sphere_centers, jnp.asarray([center], jnp.float32)]
        ),
        sphere_radii=jnp.concatenate(
            [scene.sphere_radii, jnp.asarray([radius], jnp.float32)]
        ),
        sphere_material=jnp.concatenate(
            [scene.sphere_material, jnp.asarray([row], jnp.int32)]
        ),
    )


def make_materials(emission, diffuse, metalness, roughness) -> Materials:
    return Materials(
        emission=jnp.asarray(emission, jnp.float32),
        diffuse=jnp.asarray(diffuse, jnp.float32),
        metalness=jnp.asarray(metalness, jnp.float32),
        roughness=jnp.asarray(roughness, jnp.float32),
    )
