"""Threaded BVH: Morton-ordered build + stackless skip-link traversal.

Replacement for the reference's acceleration structures:
  * build: triangles are sorted by Morton code of their AABB centroid and a
    *balanced* binary tree is erected over equal index ranges — an LBVH-style
    GPU construction (SURVEY.md §7.4), fully vectorized in numpy, replacing
    the sequential 8-way octree insertion of bvh.h:83-125
  * layout: one flat SoA node array in DFS preorder — the capability target
    is the reference's FlattenedBVH (flattened_bvh.h:25-39) but with AABBs
    instead of 7-plane k-DOPs (bounding_volume.h) and with *skip links*
    instead of a 100k-entry traversal stack (bvh_constants.h:6).
    Node data is PACKED: one [M,8] f32 row (aabb min/max) and one [M,4] i32
    row (first,count,skip) per node, so each traversal step is two
    contiguous row-gathers.  Leaf triangles are pre-gathered into Morton
    order ([N,3,3] rows contiguous per leaf) so leaf tests gather
    consecutive rows.
  * traversal: every ray carries ONE integer (current node).  Box hit on an
    internal node -> descend (node+1); miss or finished leaf -> skip link.
    All rays march in lockstep under ``lax.while_loop`` with masks — no
    per-lane stacks, no divergence, pure gathers and elementwise work; the
    loop runs until the slowest ray finishes.  A separate ``any_hit`` walk serves shadow rays
    (reference evaluate_shadow_ray, render_kernel.cpp:744-759): rays retire
    the moment any occluder is found.
  * the traversal (discrete argmin) runs under stop_gradient; the winning
    primitive's hit record is then *recomputed differentiably*, so camera /
    geometry gradients flow exactly like the brute-force oracle's.

Correctness contract: identical closest-hit results (t, prim) to
ops.intersect.intersect_triangles — enforced by tests/test_bvh.py on random
rays and by the closed-form golden rays (tests/test_golden_rays.py), in the
role of the reference's golden-ray regression data, bvh_tests.h.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from sycl_ray_tracing.ops.intersect import BIG_T, Hit, _finalize_tri_hit
from sycl_ray_tracing.ops.safe_math import EPS

SHADOW_EPS = 1e-4  # reference t_max slack (render_kernel.cpp:751)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ThreadedBVH:
    """Flat threaded BVH (DFS preorder, skip links), packed for gathers."""

    nodes_box: jnp.ndarray   # [M,8] f32: min xyz, max xyz, 0, 0
    nodes_meta: jnp.ndarray  # [M,4] i32: first, count (-1 internal), skip, 0
    leaf_tris: jnp.ndarray   # [Np,3,3] f32 triangles in Morton order (padded)
    tri_order: jnp.ndarray   # [Np] i32 original triangle index per slot
    leaf_size: int = dataclasses.field(default=4, metadata=dict(static=True))

    @property
    def num_nodes(self) -> int:
        return self.nodes_box.shape[0]


def _morton3(x: np.ndarray) -> np.ndarray:
    """Interleave 10-bit coords -> 30-bit Morton codes. x: [N,3] in [0,1]."""
    q = np.clip((x * 1024.0), 0, 1023).astype(np.uint64)

    def spread(v):
        v = (v | (v << 16)) & np.uint64(0x030000FF)
        v = (v | (v << 8)) & np.uint64(0x0300F00F)
        v = (v | (v << 4)) & np.uint64(0x030C30C3)
        v = (v | (v << 2)) & np.uint64(0x09249249)
        return v

    return (
        (spread(q[:, 0]) << np.uint64(2))
        | (spread(q[:, 1]) << np.uint64(1))
        | spread(q[:, 2])
    )


def build_bvh(triangles: np.ndarray, leaf_size: int = 4,
              method: str = "auto") -> ThreadedBVH:
    """Build a threaded BVH over triangles [N,3,3] (host-side).

    method:
      * "sah"    — native C++ binned-SAH builder (native/bvh_builder.cpp);
                   best tree quality, requires the compiled library
      * "morton" — numpy Morton-sort + balanced index-range tree: O(N log N),
                   fully vectorized (every level's AABBs are one
                   reshape+min/max over the level below)
      * "auto"   — SAH if the native library is available, else Morton
    """
    tris = np.asarray(triangles, np.float32)
    if method not in ("auto", "sah", "morton"):
        raise ValueError(f"bad build method {method!r}")
    if method in ("auto", "sah"):
        from sycl_ray_tracing import native

        packed = native.sah_build(tris, leaf_size)
        if packed is not None:
            nodes_box, nodes_meta, slot_order = packed
            return ThreadedBVH(
                nodes_box=jnp.asarray(nodes_box),
                nodes_meta=jnp.asarray(nodes_meta),
                leaf_tris=jnp.asarray(tris[slot_order]),
                tri_order=jnp.asarray(slot_order),
                leaf_size=leaf_size,
            )
        if method == "sah":
            raise RuntimeError(
                "native SAH builder unavailable — run "
                "`make -C sycl_ray_tracing/native`"
            )
    n = tris.shape[0]
    tmin = tris.min(axis=1)  # [N,3]
    tmax = tris.max(axis=1)
    centroid = 0.5 * (tmin + tmax)
    lo = centroid.min(axis=0)
    span = np.maximum(centroid.max(axis=0) - lo, 1e-12)
    codes = _morton3((centroid - lo) / span)
    order = np.argsort(codes, kind="stable").astype(np.int32)

    k0 = max(1, -(-n // leaf_size))          # number of real leaves
    depth = max(0, int(np.ceil(np.log2(k0))))
    k = 1 << depth                            # padded leaf count
    m = 2 * k - 1                             # total nodes

    # triangles in Morton order, padded with degenerate (all-zero) triangles
    pad = k * leaf_size - n
    leaf_tris = np.concatenate(
        [tris[order], np.zeros((pad, 3, 3), np.float32)]
    )
    tri_order_padded = np.concatenate([order, np.zeros((pad,), np.int32)])

    big = np.float32(3e38)
    smin = np.concatenate([tmin[order], np.full((pad, 3), big, np.float32)])
    smax = np.concatenate([tmax[order], np.full((pad, 3), -big, np.float32)])
    leaf_min = smin.reshape(k, leaf_size, 3).min(axis=1)   # [K,3]
    leaf_max = smax.reshape(k, leaf_size, 3).max(axis=1)

    # per-level AABBs, bottom-up
    mins = [leaf_min]
    maxs = [leaf_max]
    while mins[-1].shape[0] > 1:
        mins.append(mins[-1].reshape(-1, 2, 3).min(axis=1))
        maxs.append(maxs[-1].reshape(-1, 2, 3).max(axis=1))
    mins = mins[::-1]  # mins[d]: level d (root = level 0)
    maxs = maxs[::-1]

    nodes_box = np.zeros((m, 8), np.float32)
    nodes_meta = np.zeros((m, 4), np.int32)
    nodes_meta[:, 1] = -1  # internal by default

    # DFS preorder positions level by level; subtree size at level d is
    # S(d) = 2^(depth-d+1) - 1
    pos = np.zeros((1,), np.int64)  # root at 0
    for d in range(depth + 1):
        s = (1 << (depth - d + 1)) - 1
        nodes_box[pos, 0:3] = mins[d]
        nodes_box[pos, 3:6] = maxs[d]
        nodes_meta[pos, 2] = pos + s  # skip link
        if d == depth:                # leaves
            leaf_ids = np.arange(k, dtype=np.int64)
            nodes_meta[pos, 0] = (leaf_ids * leaf_size).astype(np.int32)
            nodes_meta[pos, 1] = np.clip(
                n - leaf_ids * leaf_size, 0, leaf_size
            ).astype(np.int32)
        else:
            child_s = (1 << (depth - d)) - 1
            pos = np.stack([pos + 1, pos + 1 + child_s], axis=1).reshape(-1)

    return ThreadedBVH(
        nodes_box=jnp.asarray(nodes_box),
        nodes_meta=jnp.asarray(nodes_meta),
        leaf_tris=jnp.asarray(leaf_tris),
        tri_order=jnp.asarray(tri_order_padded),
        leaf_size=leaf_size,
    )


def _inv_dir(ray_d):
    """Robust finite inverse direction (no inf*0 NaNs in the slab test)."""
    sign = jnp.where(ray_d < 0, -1.0, 1.0)
    return sign / jnp.maximum(jnp.abs(ray_d), 1e-30)


def _slab_test(box, o, inv_d, t_limit):
    """Ray/AABB slab test bounded above by t_limit.  box: [B,8]."""
    t0 = (box[:, 0:3] - o) * inv_d
    t1 = (box[:, 3:6] - o) * inv_d
    tnear = jnp.max(jnp.minimum(t0, t1), axis=-1)
    tfar = jnp.min(jnp.maximum(t0, t1), axis=-1)
    return (tnear <= tfar) & (tfar > EPS) & (tnear < t_limit)


def _leaf_mt(bvh: ThreadedBVH, first, count, o, d):
    """Möller–Trumbore on each ray's current leaf slots.

    Returns (t [B,L] with BIG_T fills, slot [B,L] global slot index).
    """
    L = bvh.leaf_size
    lane = jnp.arange(L, dtype=jnp.int32)
    slot = first[:, None] + lane[None, :]                    # [B,L]
    np_slots = bvh.leaf_tris.shape[0]
    slot_c = jnp.clip(slot, 0, np_slots - 1)
    tri = bvh.leaf_tris[slot_c]                              # [B,L,3,3]
    valid_slot = lane[None, :] < count[:, None]

    va = tri[..., 0, :]
    e1 = tri[..., 1, :] - va
    e2 = tri[..., 2, :] - va
    dv = d[:, None, :]
    ov = o[:, None, :]
    h = jnp.cross(dv, e2)
    a = jnp.sum(e1 * h, axis=-1)
    parallel = jnp.abs(a) < EPS
    f = 1.0 / jnp.where(parallel, 1.0, a)
    s = ov - va
    u = f * jnp.sum(s * h, axis=-1)
    q = jnp.cross(s, e1)
    v = f * jnp.sum(dv * q, axis=-1)
    t = f * jnp.sum(e2 * q, axis=-1)
    ok = (
        valid_slot
        & (~parallel)
        & (u >= 0.0)
        & (u <= 1.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > EPS)
    )
    return jnp.where(ok, t, BIG_T), slot_c


def closest_prim(bvh: ThreadedBVH, ray_o, ray_d):
    """Lockstep threaded traversal.  Returns (best_t [B], best_prim [B];
    prim = -1 on miss, in ORIGINAL triangle indexing).
    Non-differentiable (discrete search)."""
    B = ray_o.shape[0]
    m = bvh.num_nodes
    inv_d = _inv_dir(ray_d)

    def cond(state):
        node, _, _ = state
        return jnp.any(node < m)

    def body(state):
        node, best_t, best_slot = state
        nc = jnp.clip(node, 0, m - 1)
        box = bvh.nodes_box[nc]                              # [B,8]
        meta = bvh.nodes_meta[nc]                            # [B,4]
        first, cnt, skp = meta[:, 0], meta[:, 1], meta[:, 2]
        active = node < m

        box_hit = _slab_test(box, ray_o, inv_d, best_t) & active
        is_leaf = cnt >= 0
        do_leaf = box_hit & is_leaf

        t, slot = _leaf_mt(
            bvh, jnp.where(do_leaf, first, 0), jnp.where(do_leaf, cnt, 0),
            ray_o, ray_d,
        )
        lane_best = jnp.argmin(t, axis=1)
        lane_t = jnp.take_along_axis(t, lane_best[:, None], axis=1)[:, 0]
        lane_slot = jnp.take_along_axis(slot, lane_best[:, None], axis=1)[:, 0]
        better = do_leaf & (lane_t < best_t)
        best_t = jnp.where(better, lane_t, best_t)
        best_slot = jnp.where(better, lane_slot, best_slot)

        descend = box_hit & (~is_leaf)
        nxt = jnp.where(descend, node + 1, skp)
        node = jnp.where(active, nxt, node)
        return node, best_t, best_slot

    node0 = jnp.zeros((B,), jnp.int32)
    t0 = jnp.full((B,), BIG_T, jnp.float32)
    s0 = jnp.full((B,), -1, jnp.int32)
    _, best_t, best_slot = jax.lax.while_loop(cond, body, (node0, t0, s0))
    best_prim = jnp.where(
        best_slot >= 0, bvh.tri_order[jnp.maximum(best_slot, 0)], -1
    )
    from sycl_ray_tracing.ops.intersect import name_traversal

    return name_traversal(best_t, best_prim)


def any_hit(bvh: ThreadedBVH, ray_o, ray_d, t_max):
    """Occlusion walk: True where ANY triangle lies at t in
    (EPS, t_max - SHADOW_EPS).  Rays retire as soon as a hit is found —
    much cheaper than closest-hit for shadow rays.  t_max may be BIG_T
    for miss-tests (env-map MIS rays).  Non-differentiable."""
    B = ray_o.shape[0]
    m = bvh.num_nodes
    inv_d = _inv_dir(ray_d)
    t_lim = t_max - SHADOW_EPS

    def cond(state):
        node, found = state
        return jnp.any((node < m) & (~found))

    def body(state):
        node, found = state
        nc = jnp.clip(node, 0, m - 1)
        box = bvh.nodes_box[nc]
        meta = bvh.nodes_meta[nc]
        first, cnt, skp = meta[:, 0], meta[:, 1], meta[:, 2]
        active = (node < m) & (~found)

        box_hit = _slab_test(box, ray_o, inv_d, t_lim) & active
        is_leaf = cnt >= 0
        do_leaf = box_hit & is_leaf

        t, _ = _leaf_mt(
            bvh, jnp.where(do_leaf, first, 0), jnp.where(do_leaf, cnt, 0),
            ray_o, ray_d,
        )
        hit_any = do_leaf & jnp.any(t < t_lim[:, None], axis=1)
        found = found | hit_any

        descend = box_hit & (~is_leaf)
        nxt = jnp.where(descend, node + 1, skp)
        node = jnp.where(active, nxt, node)
        return node, found

    node0 = jnp.zeros((B,), jnp.int32)
    f0 = jnp.zeros((B,), bool)
    _, found = jax.lax.while_loop(cond, body, (node0, f0))
    from sycl_ray_tracing.ops.intersect import name_traversal

    return name_traversal(found)


def intersect_bvh(bvh: ThreadedBVH, tris, ray_o, ray_d) -> Hit:
    """Closest-hit via BVH, differentiable hit record.

    The discrete search runs under stop_gradient; the winning triangle's
    t/point/normal/uv are recomputed differentiably (same recipe as the
    brute-force path, ops.intersect._finalize_tri_hit).
    """
    o_ng = jax.lax.stop_gradient(ray_o)
    d_ng = jax.lax.stop_gradient(ray_d)
    _, prim = closest_prim(bvh, o_ng, d_ng)
    from sycl_ray_tracing.ops.intersect import finalize_hit

    return finalize_hit(ray_o, ray_d, tris, prim)
