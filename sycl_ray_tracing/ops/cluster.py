"""Wavefront cluster tracer: dense, loop-free ray/scene intersection.

Instead of per-ray pointer chasing (ops/bvh.py's lockstep skip-link walk, a
``while_loop`` that runs until the slowest ray finishes), traversal is three
dense, fully parallel phases:

  1. ray x supercluster AABB slab tests        — dense [B,K1], no gathers
  2. surviving (ray, supercluster) pairs test the 64 child cluster AABBs
     — one contiguous row-gather per pair + dense [P1,64] math
  3. surviving (ray, cluster) pairs run Möller–Trumbore on the cluster's
     T_CLUSTER=128 triangles — one row-gather per pair + dense [P2,128]
     math, then a segment-min reduction back to per-ray closest hits

Pair expansion uses static budgets with a masked overflow flag, and the
reductions use sorted ``segment_min`` — no data-dependent control flow
anywhere, so the whole intersection is a fixed-shape DAG: no while_loop,
no divergence, no lockstep straggler problem.

Geometry is grouped by the C++ SAH builder's leaf order (or Morton order)
into clusters of T_CLUSTER=128 triangles and superclusters of 64 clusters.
The same tables feed the list tracer (ops/pallas/listtrace.py), whose
nearest-first candidate lists are built here (candidate_clusters*); its
id packing holds up to 8192 clusters = 1M triangles, which covers the
reference's 870k-triangle flagship.

The reference equivalent is the flattened BVH + iterative traversal
(flattened_bvh.h:12-48); capability is the same (closest-hit + any-hit for
shadows).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from sycl_ray_tracing.ops.intersect import BIG_T, Hit
from sycl_ray_tracing.ops.safe_math import EPS

T_CLUSTER = 128      # triangles per cluster
S_CLUSTER = 64       # clusters per supercluster
SHADOW_EPS = 1e-4    # reference t_max slack (render_kernel.cpp:751)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ClusterScene:
    """Two-level clustered geometry (all padded to full 64/64 groups)."""

    sc_box: jnp.ndarray       # [K1,8] f32 supercluster AABB (min3,max3,0,0)
    cl_box_rows: jnp.ndarray  # [K1, 8*S] f32 child AABBs, PLANAR coord rows
    cl_box: jnp.ndarray       # [K2,8] f32 per-cluster AABB (dense path)
    cl_tris: jnp.ndarray      # [K2, 9*T] f32 PLANAR triangle coordinate rows
    cl_tri_idx: jnp.ndarray   # [K2, T] i32 original tri index (-1 pad)
    p1_budget: int = dataclasses.field(default=0, metadata=dict(static=True))
    p2_budget: int = dataclasses.field(default=0, metadata=dict(static=True))
    # max hit child-clusters per (ray, supercluster) pair; 0 = exact path
    fanout: int = dataclasses.field(default=0, metadata=dict(static=True))
    # per-ray candidate-list depth override for the Pallas list tracer
    # (0 = module defaults).  This is the list tracer's REAL escalation
    # knob — main.py's overflow regrow doubles it (share-mode unions and
    # the hier supercluster budget scale along, listtrace._run_once);
    # p1/p2 budgets above only govern the XLA cluster tracer.
    list_maxc: int = dataclasses.field(default=0, metadata=dict(static=True))

    @property
    def num_superclusters(self) -> int:
        return self.sc_box.shape[0]

    @property
    def num_clusters(self) -> int:
        return self.cl_tris.shape[0]

    def with_budgets(self, p1: int, p2: int) -> "ClusterScene":
        return dataclasses.replace(self, p1_budget=p1, p2_budget=p2)

    def with_fanout(self, f: int) -> "ClusterScene":
        return dataclasses.replace(self, fanout=f)

    def with_list_maxc(self, maxc: int) -> "ClusterScene":
        return dataclasses.replace(self, list_maxc=maxc)


def sah_order(triangles: np.ndarray) -> np.ndarray | None:
    """Triangle permutation from the native binned-SAH builder's leaf
    order (depth-first leaves).  Adjacent triangles then come from the
    same SAH leaf, so fixed-size clusters get far tighter, less
    overlapping AABBs than Morton order — which both shrinks per-ray
    candidate counts and makes candidate entry-t informative for the list
    tracer's early termination.  None if the native lib is unavailable."""
    from sycl_ray_tracing import native

    built = native.sah_build(np.asarray(triangles, np.float32), 4)
    if built is None:
        return None
    _, _, slots = built
    slots = slots[slots >= 0].astype(np.int64)
    # leaf padding repeats triangle indices: keep first occurrences only
    _, first = np.unique(slots, return_index=True)
    order = slots[np.sort(first)]
    if order.size != triangles.shape[0]:
        return None
    return order


def build_clusters(triangles: np.ndarray, order=None,
                   p1_budget: int = 0, p2_budget: int = 0) -> ClusterScene:
    """Group triangles [N,3,3] into the two-level cluster table.

    ``order``: optional spatial ordering — an explicit permutation array,
    "sah" (native SAH leaf order, falls back to Morton if the native lib
    is missing), or None/"morton" for Morton order of AABB centroids.
    """
    from sycl_ray_tracing.ops.bvh import _morton3

    tris = np.asarray(triangles, np.float32)
    n = tris.shape[0]
    if isinstance(order, str) and order == "sah":
        order = sah_order(tris)
    elif isinstance(order, str):  # "morton"
        order = None
    if order is None:
        tmin = tris.min(axis=1)
        tmax = tris.max(axis=1)
        cent = 0.5 * (tmin + tmax)
        lo = cent.min(axis=0)
        span = np.maximum(cent.max(axis=0) - lo, 1e-12)
        order = np.argsort(_morton3((cent - lo) / span), kind="stable")
    order = np.asarray(order, np.int64)

    k2 = max(1, -(-n // T_CLUSTER))
    k1 = max(1, -(-k2 // S_CLUSTER))
    k2_pad = k1 * S_CLUSTER
    slot_count = k2_pad * T_CLUSTER

    # triangle slots (padded with degenerate zero triangles)
    sorted_tris = np.zeros((slot_count, 3, 3), np.float32)
    sorted_tris[:n] = tris[order]
    tri_idx = np.full((slot_count,), -1, np.int32)
    tri_idx[:n] = order.astype(np.int32)

    grouped = sorted_tris.reshape(k2_pad, T_CLUSTER, 3, 3)
    # COORDINATE-PLANAR row layout: [ax*T | ay*T | az*T | bx*T | ...] so the
    # MT math reads contiguous [P,T] planes instead of stride-9 accesses
    planar = np.transpose(grouped, (0, 2, 3, 1)).reshape(
        k2_pad, 9 * T_CLUSTER
    )
    # cluster AABBs; padding slots must not affect bounds
    valid = (tri_idx.reshape(k2_pad, T_CLUSTER) >= 0)[..., None]
    big = np.float32(3e38)
    vmin = np.where(valid, grouped.min(axis=2), big).min(axis=1)   # [K2,3]
    vmax = np.where(valid, grouped.max(axis=2), -big).max(axis=1)

    sc_min = vmin.reshape(k1, S_CLUSTER, 3).min(axis=1)
    sc_max = vmax.reshape(k1, S_CLUSTER, 3).max(axis=1)

    # Empty (padding) groups have inverted bounds, and the auto-sorting slab
    # test would treat those as hit-everything.  Patch them to the
    # always-miss sentinel min = max = +big (tnear==tfar==±big fails either
    # tfar>EPS or tnear<t_lim for every ray).
    cl_empty = ~valid.any(axis=(1, 2))
    vmin[cl_empty] = big
    vmax[cl_empty] = big
    sc_empty = cl_empty.reshape(k1, S_CLUSTER).all(axis=1)
    sc_min[sc_empty] = big
    sc_max[sc_empty] = big

    # planar per-supercluster child-box rows:
    # [minx*S | miny*S | minz*S | maxx*S | maxy*S | maxz*S | 0*2S]
    # (lane-contiguous coordinate planes, like the triangle rows)
    cl_minmax = np.concatenate([vmin, vmax], axis=1)                # [K2,6]
    planes = np.transpose(
        cl_minmax.reshape(k1, S_CLUSTER, 6), (0, 2, 1)
    ).reshape(k1, 6 * S_CLUSTER)
    cl_box_rows = np.concatenate(
        [planes, np.zeros((k1, 2 * S_CLUSTER), np.float32)], axis=1
    )
    # flat per-cluster boxes (for the one-level dense path)
    cl_box = np.concatenate(
        [vmin, vmax, np.zeros((k2_pad, 2), np.float32)], axis=1
    )                                                               # [K2,8]
    sc_box = np.concatenate(
        [sc_min, sc_max, np.zeros((k1, 2), np.float32)], axis=1
    )

    return ClusterScene(
        sc_box=jnp.asarray(sc_box),
        cl_box_rows=jnp.asarray(cl_box_rows),
        cl_box=jnp.asarray(cl_box),
        cl_tris=jnp.asarray(planar),
        cl_tri_idx=jnp.asarray(tri_idx.reshape(k2_pad, T_CLUSTER)),
        p1_budget=p1_budget or 16 * 1024,
        p2_budget=p2_budget or 64 * 1024,
    )


def default_budgets(num_rays: int, k1: int):
    """Heuristic pair budgets sized from measured densities on the dragon
    workload at T=128: surface-origin rays average ~5 supercluster pairs
    and ~13 cluster pairs per ray; primaries are far sparser."""
    p1 = min(num_rays * 8, num_rays * max(1, k1))
    p2 = num_rays * 18
    return p1, p2


def _inv_dir(ray_d):
    sign = jnp.where(ray_d < 0, -1.0, 1.0)
    return sign / jnp.maximum(jnp.abs(ray_d), 1e-30)


def _slab_dense(boxes, o, inv_d, t_lim):
    """boxes [K,8] vs rays [B,3]: -> hit mask [B,K] (dense, no gathers)."""
    bmin = boxes[:, 0:3]                               # [K,3]
    bmax = boxes[:, 3:6]
    t0 = (bmin[None] - o[:, None]) * inv_d[:, None]    # [B,K,3]
    t1 = (bmax[None] - o[:, None]) * inv_d[:, None]
    tnear = jnp.max(jnp.minimum(t0, t1), axis=-1)
    tfar = jnp.min(jnp.maximum(t0, t1), axis=-1)
    return (tnear <= tfar) & (tfar > EPS) & (tnear < t_lim[:, None])


def _expand_pairs(mask, budget):
    """mask [A,C] -> (row_idx [P], col_idx [P], valid [P], overflowed).
    Invalid entries carry (A, C) like jnp.nonzero's fill_value would."""
    r, c, valid, overflow = _compact_mask(mask, budget)
    r = jnp.where(valid, r, mask.shape[0])
    c = jnp.where(valid, c, mask.shape[1])
    return r, c, valid, overflow


def _mt_block(tri_rows, o, d):
    """MT on planar rows [P, 9*T] vs per-pair rays [P,3] -> t [P,T]."""
    return _mt_rows_scalar(tri_rows, o, d)


def _build_pairs(scene: ClusterScene, ray_o, ray_d, t_lim):
    """Phases 1-2: culling + pair expansion (no triangle work).

    Returns (r2 [P2] ray ids, c2 [P2] cluster ids, valid2 [P2],
    rays12 [B,12] packed ray rows, overflow).  Pairs are ray-major
    (row-major order of the phase-1/2 masks).

    Gather discipline: ray fields are packed into ONE [B,12] row array;
    phase-1 (ray, supercluster) ids are packed into one int payload carried
    through the phase-2 compaction's own row-gather.
    """
    B = ray_o.shape[0]
    inv_d = _inv_dir(ray_d)
    # packed per-ray rows: o(3) d(3) inv(3) t_lim(1) pad(2)
    rays12 = jnp.concatenate(
        [ray_o, ray_d, inv_d, t_lim[:, None],
         jnp.zeros((B, 2), ray_o.dtype)], axis=1
    )

    # phase 1: dense supercluster tests
    m1 = _slab_dense(scene.sc_box, ray_o, inv_d, t_lim)          # [B,K1]
    r1, s1, valid1, of1 = _expand_pairs(m1, scene.p1_budget)
    r1c = jnp.minimum(r1, B - 1)
    s1c = jnp.minimum(s1, scene.num_superclusters - 1)

    # phase 2: child cluster tests — one wide PLANAR row-gather per pair,
    # scalarized slab math in [P1,S] lane-contiguous tiles
    S = S_CLUSTER
    rowsb = scene.cl_box_rows[s1c]                                # [P1,8S]
    rg1 = rays12[r1c]                                             # [P1,12]
    o1 = rg1[:, 0:3]
    i1 = rg1[:, 6:9]
    tl1 = rg1[:, 9]
    x0 = (rowsb[:, 0 * S:1 * S] - o1[:, 0:1]) * i1[:, 0:1]
    y0 = (rowsb[:, 1 * S:2 * S] - o1[:, 1:2]) * i1[:, 1:2]
    z0 = (rowsb[:, 2 * S:3 * S] - o1[:, 2:3]) * i1[:, 2:3]
    x1 = (rowsb[:, 3 * S:4 * S] - o1[:, 0:1]) * i1[:, 0:1]
    y1 = (rowsb[:, 4 * S:5 * S] - o1[:, 1:2]) * i1[:, 1:2]
    z1 = (rowsb[:, 5 * S:6 * S] - o1[:, 2:3]) * i1[:, 2:3]
    tnear = jnp.maximum(
        jnp.maximum(jnp.minimum(x0, x1), jnp.minimum(y0, y1)),
        jnp.minimum(z0, z1),
    )
    tfar = jnp.minimum(
        jnp.minimum(jnp.maximum(x0, x1), jnp.maximum(y0, y1)),
        jnp.maximum(z0, z1),
    )
    m2 = (tnear <= tfar) & (tfar > EPS) & (tnear < tl1[:, None])
    m2 = m2 & valid1[:, None]                                     # [P1,S]

    if scene.fanout > 0:
        # Bound children per SC-pair to ``fanout`` via nearest-first argmin
        # rounds, shrinking the phase-2 compaction input from [P1,S] to
        # [P1,F].  Pairs with more hit children than F overflow (flagged) —
        # opt-in for mesh scenes; fanout=0 keeps the exact path.
        F = scene.fanout
        lanes = jax.lax.broadcasted_iota(jnp.int32, m2.shape, 1)
        m = m2
        sel_cols = []
        sel_ok = []
        for _ in range(F):
            tmask = jnp.where(m, tnear, BIG_T)
            c = jnp.argmin(tmask, axis=1)                         # [P1]
            ok = jnp.take_along_axis(m, c[:, None], axis=1)[:, 0]
            sel_cols.append(c)
            sel_ok.append(ok)
            m = m & (lanes != c[:, None])
        of_fanout = jnp.any(m)
        mF = jnp.stack(sel_ok, axis=1)                            # [P1,F]
        cF = jnp.stack(sel_cols, axis=1)                          # [P1,F]

        # pack (ray, supercluster, chosen child) through the compaction
        payload = jnp.concatenate(
            [r1c[:, None], s1c[:, None], cF], axis=1
        )
        p2c, f_idx, valid2, of2, pay = _compact_mask(
            mF, scene.p2_budget, payload
        )
        r2 = pay[:, 0]
        fcols = pay[:, 2:]
        c2_local = jnp.take_along_axis(
            fcols, jnp.minimum(f_idx, F - 1)[:, None], axis=1
        )[:, 0]
        c2 = pay[:, 1] * S_CLUSTER + c2_local
        of2 = of2 | of_fanout
    else:
        payload = jnp.concatenate([r1c[:, None], s1c[:, None]], axis=1)
        p2c, c2_local, valid2, of2, pay = _compact_mask(
            m2, scene.p2_budget, payload
        )
        r2 = pay[:, 0]
        c2 = pay[:, 1] * S_CLUSTER + jnp.minimum(c2_local, S_CLUSTER - 1)

    r2 = jnp.where(valid2, r2, B)
    return r2, c2, valid2, rays12, of1 | of2


def _trace_pairs(scene: ClusterScene, ray_o, ray_d, t_lim):
    """Phases 1-3.  Returns (r2, c2, t [P2,T], valid2 [P2], tl2 [P2],
    overflow)."""
    B = ray_o.shape[0]
    r2, c2, valid2, rays12, of = _build_pairs(scene, ray_o, ray_d, t_lim)
    r2c = jnp.minimum(r2, B - 1)
    # phase 3: cluster triangle tests (one 2.3KB row-gather per pair + the
    # packed ray row)
    tri_rows = scene.cl_tris[c2]                                  # [P2,T*9]
    rg2 = rays12[r2c]                                             # [P2,12]
    t = _mt_block(tri_rows, rg2[:, 0:3], rg2[:, 3:6])             # [P2,T]
    t = jnp.where(valid2[:, None], t, BIG_T)
    return r2, c2, t, valid2, rg2[:, 9], of


def _compact_mask(mask2d, budget, payload=None):
    """Stream-compact True positions of mask [A,C] into (row [P], col [P],
    valid [P], overflow[, payload_g [P,D]]) with P = budget, ordered
    row-major.  EXACT.  ``payload`` [A,D] i32 rows, if given, are gathered
    FUSED with the compaction's own row-gather (zero extra gathers).

    Inverted (gather-style) compaction: instead of a key sort or a
    scatter, each OUTPUT slot finds its source position:

      * row bases = exclusive cumsum of per-row counts  [A]
      * slot q's row  = searchsorted(bases, q)           (binary search)
      * slot q's col  = rank-(q - base) set bit of its row, found by a
        dense compare against the row's inclusive cumsum (one [P,C] tile)

    Costs: two cumsums + a batched binary search + one [P,C] row-gather.
    """
    A, Cc = mask2d.shape
    mi = mask2d.astype(jnp.int32)
    cum = jnp.cumsum(mi, axis=1)                      # [A,C] inclusive
    counts = cum[:, -1]                               # [A]
    ends = jnp.cumsum(counts)                         # inclusive
    total = ends[-1]
    base = ends - counts                              # exclusive

    q = jax.lax.broadcasted_iota(jnp.int32, (budget, 1), 0)[:, 0]
    # method='sort': one merge-style key sort of [A + budget] instead of
    # the default 'scan' method's while_loop
    row = jnp.searchsorted(
        ends, q, side="right", method="sort"
    ).astype(jnp.int32)
    rowc = jnp.minimum(row, A - 1)

    # ONE row-gather serves the row base, the row's cumsum AND any caller
    # payload
    parts = [base[:, None], cum]
    if payload is not None:
        parts.append(payload.astype(jnp.int32))
    cumx = jnp.concatenate(parts, axis=1)             # [A, C+1(+D)]
    cumx_g = cumx[rowc]                               # [P, C+1(+D)]
    j = q - cumx_g[:, 0]                              # rank within row
    col = jnp.sum(
        (cumx_g[:, 1:Cc + 1] <= j[:, None]).astype(jnp.int32), axis=1
    )
    col = jnp.minimum(col, Cc - 1)
    valid = q < total
    if payload is not None:
        return rowc, col, valid, total > budget, cumx_g[:, Cc + 1:]
    return rowc, col, valid, total > budget


def _mt_rows_scalar(tri_rows, o, d):
    """Scalarized Möller–Trumbore on PLANAR triangle rows [..., 9*T] vs
    rays o/d (shape broadcastable to [..., 3] against the row batch dims).

    All arithmetic stays in [..., T] tiles (xyz as separate contiguous
    planes — no [...,3] axis, no jnp.cross) so XLA fuses the whole chain
    without strided loads or materialized intermediates.  Returns
    t [..., T] with BIG_T fills.
    """
    T = T_CLUSTER
    r = tri_rows
    ax = r[..., 0 * T:1 * T]
    ay = r[..., 1 * T:2 * T]
    az = r[..., 2 * T:3 * T]
    bx = r[..., 3 * T:4 * T]
    by = r[..., 4 * T:5 * T]
    bz = r[..., 5 * T:6 * T]
    cx = r[..., 6 * T:7 * T]
    cy = r[..., 7 * T:8 * T]
    cz = r[..., 8 * T:9 * T]
    e1x, e1y, e1z = bx - ax, by - ay, bz - az
    e2x, e2y, e2z = cx - ax, cy - ay, cz - az
    dx = d[..., 0:1]
    dy = d[..., 1:2]
    dz = d[..., 2:3]
    ox = o[..., 0:1]
    oy = o[..., 1:2]
    oz = o[..., 2:3]

    hx = dy * e2z - dz * e2y
    hy = dz * e2x - dx * e2z
    hz = dx * e2y - dy * e2x
    a = e1x * hx + e1y * hy + e1z * hz
    parallel = jnp.abs(a) < EPS
    f = 1.0 / jnp.where(parallel, 1.0, a)
    sx, sy, sz = ox - ax, oy - ay, oz - az
    u = f * (sx * hx + sy * hy + sz * hz)
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    v = f * (dx * qx + dy * qy + dz * qz)
    t = f * (e2x * qx + e2y * qy + e2z * qz)
    ok = (
        (~parallel)
        & (u >= 0.0)
        & (u <= 1.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > EPS)
    )
    return jnp.where(ok, t, BIG_T)


def _dense_cluster_mask(scene: ClusterScene, ray_o, inv_d, t_lim):
    """Slab-test ALL clusters against all rays: [B,K2] (dense, scalarized)."""
    return _dense_box_mask(scene.cl_box, ray_o, inv_d, t_lim)


def _dense_box_mask(boxes, ray_o, inv_d, t_lim):
    """Slab-test boxes [K,8] against rays: (hit [B,K], tnear [B,K])."""
    ox, oy, oz = ray_o[:, 0:1], ray_o[:, 1:2], ray_o[:, 2:3]
    ix, iy, iz = inv_d[:, 0:1], inv_d[:, 1:2], inv_d[:, 2:3]
    x0 = (boxes[None, :, 0] - ox) * ix                 # [B,K2]
    y0 = (boxes[None, :, 1] - oy) * iy
    z0 = (boxes[None, :, 2] - oz) * iz
    x1 = (boxes[None, :, 3] - ox) * ix
    y1 = (boxes[None, :, 4] - oy) * iy
    z1 = (boxes[None, :, 5] - oz) * iz
    tnear = jnp.maximum(
        jnp.maximum(jnp.minimum(x0, x1), jnp.minimum(y0, y1)),
        jnp.minimum(z0, z1),
    )
    tfar = jnp.minimum(
        jnp.minimum(jnp.maximum(x0, x1), jnp.maximum(y0, y1)),
        jnp.maximum(z0, z1),
    )
    hit = (tnear <= tfar) & (tfar > EPS) & (tnear < t_lim[:, None])
    return hit, tnear


def _reduce_closest(scene: ClusterScene, B, r2, pair_t, pair_cl, valid2):
    """Per-pair (t, packed winner) -> per-ray (t, prim) via sorted segment
    reductions (pairs must be ray-major; invalid pairs carry r2 == B)."""
    seg = r2                                    # invalid pairs -> dump row B
    best_t = jax.ops.segment_min(
        pair_t, seg, num_segments=B + 1, indices_are_sorted=True
    )[:B]
    best_t = jnp.minimum(best_t, BIG_T)
    # winner identification: one [P2] gather of the per-ray best + one
    # scatter-max of the packed (cluster, lane)
    is_best = (pair_t <= best_t[jnp.minimum(seg, B - 1)]) & valid2
    win = jax.ops.segment_max(
        jnp.where(is_best, pair_cl, -1), seg, num_segments=B + 1,
        indices_are_sorted=True,
    )[:B]
    # resolve the original triangle id at [B] scale (cheap)
    win_c = jnp.maximum(win, 0) // T_CLUSTER
    win_l = jnp.maximum(win, 0) % T_CLUSTER
    best_prim = scene.cl_tri_idx[win_c, win_l]
    best_prim = jnp.where((best_t < BIG_T) & (win >= 0), best_prim, -1)
    return best_t, best_prim


def _extract_candidates(hit, tnear, maxc: int, k2: int):
    """Nearest-first candidate extraction from a dense hit mask.

    (hit [R,K2] bool, tnear [R,K2] f32) -> (cand [R,maxc] i32 cluster ids,
    -1 empty; ctn [R,maxc] f32 entry-t, BIG_T empty; overflow scalar).

    ``maxc`` min-reduction rounds over a packed (quantized-tnear |
    cluster-id) key.  Positive-float bits are order-preserving as int32,
    so dropping the low ceil(log2(k2)) mantissa bits (11 at <=2048
    clusters, 13 at the 870k-tri flagship's ~6.8k) makes room for the
    cluster id and min() selects (nearest, its id) in ONE reduction per
    round — no argmin/take_along, no compaction sorts, no scatter.
    Quantization rounds entry-t DOWN, which is conservative everywhere it
    is consumed (ordering ties, early-exit guards, exactness
    certificates).  Requires k2 <= 65536 (id bits eat at most 16 of the
    23 mantissa bits; worst-case entry-t precision 2^-7 relative).
    """
    R = hit.shape[0]
    assert k2 <= 65536, "_extract_candidates: cluster-id field too wide"
    id_bits = max(11, (k2 - 1).bit_length())
    id_mask = jnp.int32((1 << id_bits) - 1)
    tn = jnp.maximum(tnear, 0.0)
    tbits = jax.lax.bitcast_convert_type(tn, jnp.int32)
    ids = jax.lax.broadcasted_iota(jnp.int32, hit.shape, 1)
    key = (tbits & ~id_mask) | ids
    DEAD = jnp.int32(0x7F800000)          # +inf bits, id 0: above any real
    rem = jnp.where(hit, key, DEAD)

    # THRESHOLD-MIN extraction: the unique id bits make keys strictly
    # increasing per row, so round j is "min of keys above round j-1's
    # key" — ONE read pass over [R,K2] per round with NO update writes.
    # (The previous form re-read AND rewrote rem every round — 3x the HBM
    # traffic; this loop IS the candidate build's cost at scale.)
    cands = []
    tns = []
    prev = jnp.full((R,), -1, jnp.int32)  # every real key is >= 0
    for _ in range(maxc):
        m = jnp.min(jnp.where(rem > prev[:, None], rem, DEAD), axis=1)
        alive = m < DEAD
        cands.append(jnp.where(alive, m & id_mask, -1))
        tns.append(
            jnp.where(
                alive,
                jax.lax.bitcast_convert_type(m & ~id_mask, jnp.float32),
                BIG_T,
            )
        )
        prev = m
    overflow = jnp.any(
        jnp.min(jnp.where(rem > prev[:, None], rem, DEAD), axis=1) < DEAD
    )
    return jnp.stack(cands, axis=1), jnp.stack(tns, axis=1), overflow


# Extraction algorithm for candidate lists: "minrounds" (threshold-min,
# maxc passes over [R,K2] — HBM traffic R*K2*maxc*4B) or "topk"
# (jax.lax.approx_min_k, one fused top-k pass).  approx recall
# misses are made safe by poisoning: rows that come back SHORT
# (got < min(count, maxc)) and — under approx recall — FULL rows
# (count > maxc, where a miss is undetectable by counting) both raise the
# overflow flag AND have their certificate poisoned like a true overflow.
# Certificate-consuming passes (listtrace._run) always request exact
# recall, which keeps full rows' certificates live.  Both are exact under
# the count check; which one is faster on the GPU is not measured.
EXTRACT_METHOD = "topk"


def _extract_candidates_topk(hit, tnear, maxc: int, k2: int,
                             exact: bool = False):
    """One-pass extraction via approx_min_k on the packed keys (see
    _extract_candidates for the key layout and conservativeness notes).

    ``exact=True`` requests recall_target=1.0 (exact aggregation).
    The ESCALATION passes need this: their whole purpose is to certify
    rays the main pass could not, and a recall miss there would recur
    forever (the count check would poison the same row again), leaving
    frames flagged overflow with no remaining remedy.  Main passes keep
    the cheaper default; their misses are caught by the count check and
    healed by escalation."""
    R = hit.shape[0]
    assert k2 <= 65536
    id_bits = max(11, (k2 - 1).bit_length())
    id_mask = jnp.int32((1 << id_bits) - 1)
    # clamp also above: the +2^23 bias below must not push keys past the
    # inf bit pattern (1e30's bits leave ample headroom; real tnear values
    # are scene-scale anyway)
    tn = jnp.clip(tnear, 0.0, 1e30)
    tbits = jax.lax.bitcast_convert_type(tn, jnp.int32)
    ids = jax.lax.broadcasted_iota(jnp.int32, hit.shape, 1)
    # +2^23 bias: a quantized tnear of 0 would otherwise make the packed
    # key a SUBNORMAL float, and float-domain comparisons (approx_min_k,
    # sort) may flush subnormals to zero — "origin inside the box"
    # candidates (the common bounce-ray case) would all compare equal.
    # Biased keys are normal floats, so float order == int order exactly.
    key = ((tbits & ~id_mask) | ids) + jnp.int32(1 << 23)
    DEAD = jnp.int32(0x7F800000)                           # +inf: sorts last
    rem = jnp.where(hit, key, DEAD)
    kf = jax.lax.bitcast_convert_type(rem, jnp.float32)
    # approx_min_k requires k <= the reduction dim; tiny scenes (or
    # escalated maxc on few-cluster scenes) pad the tail slots with +inf
    k = min(maxc, kf.shape[1])
    vals, _idx = jax.lax.approx_min_k(
        kf, k=k, recall_target=1.0 if exact else 0.95
    )
    if k < maxc:
        inf = jax.lax.bitcast_convert_type(DEAD, jnp.float32)
        vals = jnp.concatenate(
            [vals, jnp.full((R, maxc - k), inf, jnp.float32)], axis=1
        )
    # approx_min_k does NOT guarantee sorted output; nearest-first order is
    # load-bearing (kernel early-exit guard reads per-slot entry-t, and the
    # exactness certificate needs the LAST slot to be the row max).  A
    # [R,maxc] sort is tiny next to the [R,K2] reduction it replaced.
    vals = jnp.sort(vals, axis=1)
    kv = jax.lax.bitcast_convert_type(vals, jnp.int32)     # [R,maxc] sorted
    alive = kv < DEAD
    kv = kv - jnp.int32(1 << 23)                           # undo the bias
    cand = jnp.where(alive, kv & id_mask, -1)
    ctn = jnp.where(
        alive,
        jax.lax.bitcast_convert_type(kv & ~id_mask, jnp.float32),
        BIG_T,
    )
    # completeness check: recall misses and >maxc rays both flag overflow
    # and poison the per-ray certificate (ctn last -> -BIG, cand last -> 0).
    # Under APPROX recall, FULL rows (count > maxc) are poisoned too: a
    # recall miss there keeps got == maxc but swaps a true-nearest key for
    # a farther one, so ctn's last slot would OVER-state the drop threshold
    # and the distance certificate (tmin <= ctn_last) could wrongly certify
    # a ray whose true closest hit lives in the missed cluster — the count
    # check alone only catches rows that came back SHORT.  Exact extraction
    # keeps the genuine certificate: its kept set is provably the maxc
    # nearest, so ctn_last lower-bounds every dropped entry-t.
    count = jnp.sum(hit, axis=1)
    got = jnp.sum(alive, axis=1)
    short = got < jnp.minimum(count, maxc)
    over = short | (count > maxc)
    unsound = short if exact else over
    last_c = jnp.where(over & (cand[:, -1] < 0), 0, cand[:, -1])
    last_t = jnp.where(unsound, -BIG_T, ctn[:, -1])
    cand = jnp.concatenate([cand[:, :-1], last_c[:, None]], axis=1)
    ctn = jnp.concatenate([ctn[:, :-1], last_t[:, None]], axis=1)
    return cand, ctn, jnp.any(over)


def _extract(hit, tnear, maxc, k2, exact: bool = False):
    if EXTRACT_METHOD == "topk":
        return _extract_candidates_topk(hit, tnear, maxc, k2, exact=exact)
    # threshold-min extraction is always exact
    return _extract_candidates(hit, tnear, maxc, k2)


def _membership_cert(hit, tn_blk, cand_local, ctn, ncols: int, group: int):
    """Per-ray MEMBERSHIP exactness certificate for block-union lists.

    A ray is provably exact — even when its block's union list FILLED —
    if every column (cluster) the RAY ITSELF hits is among the KEPT
    (extracted) columns: the kernel then tested every box that could
    contain one of this ray's hits, so its closest-hit/any-hit answer is
    the true one.  This is what the block-level distance certificate
    (tmin <= ctn_last) cannot prove for unblocked any-hit rays (their
    t_lim is BIG), and those rays were the bulk of the escalation volume
    (see listtrace.ESC_CAP_DIV).

    With EXACT extraction the kept set is exactly {packed keys <= last
    kept key} (keys carry unique id bits), so membership is one dense
    compare against a per-block threshold — no scatter, no [nb,K,maxc]
    one-hot.  The compare fuses into the same [B,ncols] pass shape as the
    slab test that produced ``hit``.

    hit:        [B, ncols]  per-RAY column hit mask (same t_lim the kernel
                            will enforce)
    tn_blk:     [nb, ncols] block-min entry-t (what extraction keyed on)
    cand_local: [nb, maxc]  extracted LOCAL column ids (-1 empty)
    ctn:        [nb, maxc]  extracted entry-t (-BIG_T = poisoned row)
    Returns covered [B] bool.  Poisoned rows (approx-recall shortfalls,
    hier SC overflow is handled by the CALLER via row_of) never certify:
    their kept set is not a key-prefix, so no membership claim holds.
    """
    nb = tn_blk.shape[0]
    id_bits = max(11, (ncols - 1).bit_length())
    id_mask = jnp.int32((1 << id_bits) - 1)
    # same packing as _extract*: quantized entry-t above unique column id
    tb = jax.lax.bitcast_convert_type(
        jnp.clip(tn_blk, 0.0, 1e30), jnp.int32
    )
    ids = jax.lax.broadcasted_iota(jnp.int32, tn_blk.shape, 1)
    bkey = (tb & ~id_mask) | ids                          # [nb,ncols]
    full = cand_local[:, -1] >= 0
    poisoned = ctn[:, -1] < 0.0                           # -BIG_T sentinel
    last_key = (
        jax.lax.bitcast_convert_type(ctn[:, -1], jnp.int32) & ~id_mask
    ) | jnp.maximum(cand_local[:, -1], 0)
    # non-full lists kept every union column -> nothing was ever dropped
    # (+inf bits exceed every real key: clip(.,1e30) < inf)
    thr = jnp.where(full, last_key, jnp.int32(0x7F800000))
    drop_col = bkey > thr[:, None]                        # [nb,ncols]
    dropped = jnp.any(
        hit.reshape(nb, group, ncols) & drop_col[:, None, :], axis=2
    )                                                     # [nb,group]
    covered = (~dropped) & (~poisoned)[:, None]
    return covered.reshape(-1)


def candidate_clusters(scene: ClusterScene, ray_o, ray_d, t_lim, maxc: int,
                       exact: bool = False):
    """Per-ray nearest-first candidate cluster lists (fixed ``maxc`` slots).

    Returns (cand [B,maxc] i32 cluster ids, -1 for empty slots;
    ctn [B,maxc] f32 entry-t per slot (BIG_T on empty); overflow scalar —
    True if any ray hit more than ``maxc`` cluster boxes).

    This replaces the budgeted pair-expansion pipeline for the Pallas list
    tracer: a dense [B,K2] slab test + nearest-first extraction
    (_extract: threshold-min rounds or approx top-k;
    ``exact=True`` forces full-recall extraction — escalation passes).
    """
    inv_d = _inv_dir(ray_d)
    hit, tnear = _dense_cluster_mask(scene, ray_o, inv_d, t_lim)   # [B,K2]
    return _extract(hit, tnear, maxc, scene.num_clusters, exact=exact)


def candidate_clusters_grouped(scene: ClusterScene, ray_o, ray_d, t_lim,
                               maxc: int, group: int, exact: bool = False,
                               ray_cert: bool = False):
    """Per-GROUP (block of ``group`` consecutive rays) candidate lists: the
    union of the block's per-ray cluster hits, nearest-first by the BLOCK
    entry-t (min over the block's rays).  B must divide by ``group``.

    Returns (cand [B/group, maxc], ctn [B/group, maxc], overflow), plus
    covered [B] (the per-ray MEMBERSHIP certificate, _membership_cert)
    when ``ray_cert=True`` — ray_cert requires ``exact=True`` (approx
    recall breaks the kept-set-is-a-key-prefix property it relies on).

    This is the candidate build for the block-shared list kernel: one list
    serves all ``group`` rays, so the kernel loads each candidate tile ONCE
    per block (vs once per ray) and the extraction runs on B/group rows.
    Correctness of per-ray exactness certificates is preserved because the
    block entry-t lower-bounds every member ray's entry-t: a cluster
    dropped beyond slot maxc has block-entry >= ctn[:, -1], so any hit in
    it satisfies t >= ray-entry >= block-entry >= ctn[:, -1]."""
    B = ray_o.shape[0]
    assert B % group == 0
    assert not (ray_cert and not exact), "membership cert needs exact"
    inv_d = _inv_dir(ray_d)
    hit, tnear = _dense_cluster_mask(scene, ray_o, inv_d, t_lim)   # [B,K2]
    k2 = scene.num_clusters
    hit_g = hit.reshape(B // group, group, k2).any(axis=1)
    tn_g = jnp.min(
        jnp.where(hit, jnp.maximum(tnear, 0.0), BIG_T)
        .reshape(B // group, group, k2),
        axis=1,
    )
    cand, ctn, of = _extract(hit_g, tn_g, maxc, k2, exact=exact)
    if not ray_cert:
        return cand, ctn, of
    covered = _membership_cert(hit, tn_g, cand, ctn, k2, group)
    return cand, ctn, of, covered


def candidate_clusters_hier(scene: ClusterScene, ray_o, ray_d, t_lim,
                            maxc: int, maxs: int = 12, group: int = 8,
                            grouped: bool = False, exact: bool = False,
                            ray_cert: bool = False):
    """Per-ray nearest-first candidate lists via a SUPERCLUSTER prefilter.
    With ``grouped=True``, returns per-BLOCK union lists [B/group, maxc]
    instead (the block-shared kernel's contract), still over the
    prefiltered maxs*64 columns.

    Same contract as candidate_clusters (cand [B,maxc], ctn [B,maxc],
    overflow) but the threshold-min extraction — whose HBM traffic
    (rows x columns x maxc x 4B) dominates the whole sweep at scale —
    runs over C = maxs*64 PREFILTERED columns instead of all K2 clusters:

      1. dense [B,K1] supercluster slab tests (K1 is tiny)
      2. per-BLOCK (``group`` sorted rays) SC candidate extraction,
         ``maxs`` slots — block-level so the child-box row gather costs
         B/group x maxs gathers, not B x maxs
      3. per-ray slab tests against the selected SCs' 64 child boxes each
         ([B, maxs*64], computed from the gathered planar rows)
      4. per-ray extraction over [B, maxs*64] with LOCAL slot ids,
         mapped back to global cluster ids through the block's SC list

    At the 870k-tri flagship (K2=6784) this is ~K2/C = 9x less extraction
    traffic; at the 200k stand-in (K2=1600) ~2-4x.  Exactly equivalent to
    the dense build whenever no block hits more than ``maxs``
    superclusters; beyond that the overflow flag is raised AND the
    affected rows are marked unresolvable (ctn last slot = -BIG_T) so
    _run's per-ray exactness certificates stay sound."""
    B = ray_o.shape[0]
    assert B % group == 0
    nb = B // group
    k1 = scene.num_superclusters
    S = S_CLUSTER
    inv_d = _inv_dir(ray_d)

    # 1-2: block SC candidates
    m1, tn1 = _dense_box_mask(scene.sc_box, ray_o, inv_d, t_lim)  # [B,K1]
    hit_g = m1.reshape(nb, group, k1).any(axis=1)
    tn_g = jnp.min(
        jnp.where(m1, jnp.maximum(tn1, 0.0), BIG_T)
        .reshape(nb, group, k1),
        axis=1,
    )
    scand, _sctn, _of_ext = _extract_candidates(hit_g, tn_g, maxs, k1)
    # per-BLOCK SC overflow (exact: any hit SC beyond the maxs nearest) —
    # these blocks may be missing nearer clusters entirely, so their
    # certificates must not fire
    sc_of = jnp.sum(hit_g, axis=1) > maxs                         # [nb]

    scv = scand >= 0                                              # [nb,maxs]
    sc_idx = jnp.maximum(scand, 0)

    # 3: per-ray slab tests against gathered child-box planar rows
    rows = scene.cl_box_rows[sc_idx.reshape(-1)]                  # [nb*maxs, 8S]
    rows = rows.reshape(nb, maxs, 8 * S)
    o3 = ray_o.reshape(nb, group, 3)
    i3 = inv_d.reshape(nb, group, 3)
    tl2 = t_lim.reshape(nb, group, 1, 1)

    def plane(c):
        return rows[:, None, :, c * S:(c + 1) * S]                # [nb,1,maxs,S]

    def oc(a):
        return o3[:, :, None, a:a + 1]                            # [nb,g,1,1]

    def ic(a):
        return i3[:, :, None, a:a + 1]

    x0 = (plane(0) - oc(0)) * ic(0)
    y0 = (plane(1) - oc(1)) * ic(1)
    z0 = (plane(2) - oc(2)) * ic(2)
    x1 = (plane(3) - oc(0)) * ic(0)
    y1 = (plane(4) - oc(1)) * ic(1)
    z1 = (plane(5) - oc(2)) * ic(2)
    tnear = jnp.maximum(
        jnp.maximum(jnp.minimum(x0, x1), jnp.minimum(y0, y1)),
        jnp.minimum(z0, z1),
    )
    tfar = jnp.minimum(
        jnp.minimum(jnp.maximum(x0, x1), jnp.maximum(y0, y1)),
        jnp.maximum(z0, z1),
    )
    hit2 = (
        (tnear <= tfar) & (tfar > EPS) & (tnear < tl2)
        & scv[:, None, :, None]
    )                                                             # [nb,g,maxs,S]
    C = maxs * S

    covered = None
    if grouped:
        # BLOCK lists (for the block-shared kernel): union-reduce the
        # per-ray child tests before extraction, like
        # candidate_clusters_grouped but over the prefiltered columns
        assert not (ray_cert and not exact), "membership cert needs exact"
        hit_b = hit2.reshape(nb, group, C).any(axis=1)
        tn_b = jnp.min(
            jnp.where(hit2, jnp.maximum(tnear, 0.0), BIG_T)
            .reshape(nb, group, C),
            axis=1,
        )
        cand_l, ctn, of2 = _extract(hit_b, tn_b, maxc, C,
                                    exact=exact)                  # [nb,maxc]
        if ray_cert:
            # membership over the PREFILTERED local columns; SC-overflow
            # blocks (row_of below) may be missing whole superclusters, so
            # their rays never certify regardless of local membership
            covered = _membership_cert(
                hit2.reshape(B, C), tn_b, cand_l, ctn, C, group
            ) & ~jnp.repeat(sc_of, group)
        slot = jnp.maximum(cand_l, 0)
        sc_g = jnp.take_along_axis(scand, slot // S, axis=1)      # [nb,maxc]
        cand = jnp.where(cand_l >= 0, sc_g * S + slot % S, -1)
        row_of = sc_of                                            # [nb]
    else:
        hit2 = hit2.reshape(B, C)
        tn2 = tnear.reshape(B, C)
        # 4: per-ray extraction in LOCAL slot ids, mapped back to global
        cand_l, ctn, of2 = _extract(hit2, tn2, maxc, C, exact=exact)
        slot = jnp.maximum(cand_l, 0)
        blk = jnp.arange(B, dtype=jnp.int32) // group
        sc_g = scand.reshape(-1)[blk[:, None] * maxs + slot // S]  # [B,maxc]
        cand = jnp.where(cand_l >= 0, sc_g * S + slot % S, -1)
        row_of = sc_of[blk]                                       # [B]

    # SC-overflow rows: poison the certificate (see _run: resolved needs a
    # full-looking list whose last entry-t bounds dropped hits from below).
    # Column rewrite via concat; cluster 0 as the filler id is a real,
    # harmless re-test.
    last_c = jnp.where(row_of & (cand[:, -1] < 0), 0, cand[:, -1])
    last_t = jnp.where(row_of, -BIG_T, ctn[:, -1])
    cand = jnp.concatenate([cand[:, :-1], last_c[:, None]], axis=1)
    ctn = jnp.concatenate([ctn[:, :-1], last_t[:, None]], axis=1)
    if covered is not None:
        return cand, ctn, jnp.any(sc_of) | of2, covered
    return cand, ctn, jnp.any(sc_of) | of2


def closest_hit(scene: ClusterScene, ray_o, ray_d):
    """Closest-hit for rays [B,3] -> (t [B], prim [B] (-1 miss), overflow).

    Loop-free: all phases are dense math / wide gathers / segment reduce.
    """
    B = ray_o.shape[0]
    t_lim = jnp.full((B,), BIG_T, ray_o.dtype)
    r2, c2, t, valid2, _, overflow = _trace_pairs(scene, ray_o, ray_d, t_lim)

    # per-pair closest triangle via pure reductions (no take_along gathers)
    pair_t = jnp.min(t, axis=1)                               # [P2]
    lane = jnp.argmin(t, axis=1)                              # fused reduce
    pair_cl = c2 * T_CLUSTER + lane                           # packed winner

    best_t, best_prim = _reduce_closest(scene, B, r2, pair_t, pair_cl, valid2)
    from sycl_ray_tracing.ops.intersect import name_traversal

    return name_traversal(best_t, best_prim, overflow)


def any_hit(scene: ClusterScene, ray_o, ray_d, t_max):
    """Occlusion: True where any triangle lies at t < t_max - SHADOW_EPS.

    Returns (blocked [B] bool, overflow scalar bool) — overflow means a pair
    budget was exceeded and hits MAY have been dropped (never silently:
    callers thread it to the render API, models/pathtracer.py)."""
    B = ray_o.shape[0]
    t_lim = t_max - SHADOW_EPS
    r2, _, t, valid2, tl2, overflow = _trace_pairs(scene, ray_o, ray_d, t_lim)
    pair_hit = jnp.any(t < tl2[:, None], axis=1) & valid2
    hits = jax.ops.segment_max(
        pair_hit.astype(jnp.int32), r2, num_segments=B + 1,
        indices_are_sorted=True,
    )[:B]
    from sycl_ray_tracing.ops.intersect import name_traversal

    return name_traversal(hits > 0, overflow)


def intersect_clusters(scene: ClusterScene, tris, ray_o, ray_d,
                       of: list | None = None) -> Hit:
    """Closest-hit with a differentiable hit record (same stop-gradient +
    recompute recipe as ops.bvh.intersect_bvh).

    ``of``: optional collector list — the traversal's budget-overflow flag
    (a traced scalar bool) is appended so integrators can reduce it into
    their carries instead of dropping hits silently."""
    o_ng = jax.lax.stop_gradient(ray_o)
    d_ng = jax.lax.stop_gradient(ray_d)
    _, prim, overflow = closest_hit(scene, o_ng, d_ng)
    if of is not None:
        of.append(overflow)
    from sycl_ray_tracing.ops.intersect import finalize_hit

    return finalize_hit(ray_o, ray_d, tris, prim)
