"""List tracer: exact traversal over precomputed nearest-first candidate-
cluster lists, with the round loop as a Pallas kernel on the Triton route.

Why this shape: the XLA wavefront tracer (ops/cluster.py) does exact
per-pair work but materializes every (ray, cluster) pair — pair
compaction, per-pair row-gathers of 128 triangles, segment reductions.
Here XLA only builds, per ray or per block of rays, the list of cluster
ids its boxes hit, nearest entry first; the kernel then walks the list,
loading one 9x128 planar triangle tile per round and running
Moller-Trumbore on it with a min-accumulate, so no pair ever leaves the
kernel.  On the dragon frames this is about three times faster end to end
than the cluster tracer (PERF.md).

Two candidate/kernel shapes, selected by ``share``:

  * PER-RAY (share=False): RB rays per program, each with its own list.
    Round r gathers each ray's r-th candidate tile and runs one (RB,128)
    Moller-Trumbore tile — every row intersects its OWN cluster.
  * BLOCK-SHARED (share=True): one candidate list per block of RB_SHARE
    spatially sorted rays — the UNION of the block's cluster hits,
    nearest-first by block entry-t (ops/cluster.py
    candidate_clusters_grouped).  Round r loads the block's r-th tile ONCE
    and intersects all RB_SHARE rays against it, and the candidate
    extraction runs on 1/RB_SHARE as many rows.  The price is union
    dilution: rays also test block-mates' clusters.  Spatial sorting keeps
    unions tight.

Both kernels stop a block as soon as no ray can still improve: candidate
entry-t ascends along a list, so once the next entry-t is at or above
every ray's best hit (or the ray is an any-hit query that is already
blocked), the remaining rounds are provably useless.  Per-lane minima and
the round that produced them are written out; the per-ray reduction runs
in XLA on those (B,128) outputs.  Dead paths (mask=False) get t_lim=-BIG
-> empty candidate lists, and the ray sort pushes them into trailing
blocks that the bucketed launch never runs.

The kernels compile only for a GPU.  Tests set ``INTERPRET = True`` to run
them in Pallas's interpreter on the CPU.

Reference equivalent: flattened-BVH traversal + Triangle::intersect
(flattened_bvh.cpp:10-58, triangle.h:16-60): same capability (closest-hit
and any-hit with t_max).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from sycl_ray_tracing.ops.cluster import (
    S_CLUSTER,
    SHADOW_EPS,
    T_CLUSTER,
    ClusterScene,
    candidate_clusters,
    candidate_clusters_grouped,
    candidate_clusters_hier,
)
from sycl_ray_tracing.ops.intersect import BIG_T, Hit, name_traversal
from sycl_ray_tracing.ops.safe_math import EPS

RB = 8             # per-ray kernel: rays per program
RB_SHARE = 32      # block-shared kernel: rays sharing one candidate list
DEFAULT_MAXC = 32  # per-ray candidate slots (the escalation pass handles
                   # the tail)
DEFAULT_MAXC_SHARE = 128  # block-union slots (the winner packing's cap)
ESC_CAP_DIV = 4    # escalation compaction: cap ~= B/4 rows (>=256).  The
                   # redo set is not just the closest-hit tail: every
                   # UNBLOCKED any-hit ray in a block whose union list
                   # filled is uncertifiable by the distance certificate
                   # (its t_lim is BIG), and sky-bound shadow rays make
                   # that several percent of a launch.  Rays beyond the
                   # cap stay uncertified and keep the overflow flag up.
HIER_MAXS = 16     # supercluster slots per block in the hierarchical build
BUCKET_DIVS = (64, 32, 16, 8, 4, 2)  # launch buckets: 1/64 .. 1/2 of blocks
# Largest clustered scene the list path takes: the slot shading tables
# pack a 20-bit triangle index (models/scene.py), i.e. 8192 clusters of
# 128 triangles; larger scenes use the XLA cluster tracer.
MAX_CLUSTERS = 8192

# Module default for the ``share`` mode of closest_hit/any_hit/multi_query
# (callers may override per call): block-shared lists plus the per-ray
# escalation pass over every ray its certificate cannot prove.
LIST_SHARE_DEFAULT = True

# Run the kernels in Pallas's interpreter (CPU tests); otherwise they
# compile for the GPU through Triton.
INTERPRET = False


def _resolve_share(scene: ClusterScene, share, maxc=None) -> bool:
    if share is not None:
        return bool(share)
    if maxc is not None:
        # a caller that PINNED maxc asked for per-ray lists of exactly
        # that depth (the deterministic, certifiable contract — pinned
        # calls also skip the escalation pass).  Block-union lists under
        # a pinned depth would silently change what "maxc" bounds.
        return False
    return bool(LIST_SHARE_DEFAULT)


def supports(scene: ClusterScene) -> bool:
    """True when the list path can trace this clustered scene."""
    return scene.num_clusters <= MAX_CLUSTERS


def _mt8(ax, ay, az, bx, by, bz, cx, cy, cz, ox, oy, oz, dx, dy, dz, tl):
    """Moller-Trumbore on broadcastable (rows, T) operands (triangle.h:16-60
    semantics, EPS=1e-7; t_lim folded in: BIG_T for closest-hit,
    t_max - SHADOW_EPS for occlusion)."""
    e1x, e1y, e1z = bx - ax, by - ay, bz - az
    e2x, e2y, e2z = cx - ax, cy - ay, cz - az
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
        & (t < tl)
    )
    return jnp.where(ok, t, BIG_T)


def _round_loop(rays_ref, cnt_ref, at_ref, ar_ref, planes_of, next_entry_t,
                rows):
    """The kernels' shared round loop over ``rows`` rays.

    rays_ref: (8, rows) o3 d3 t_lim anyhit_flag, one ray per column
    cnt_ref:  (1,) candidate count of this program's list(s)
    planes_of(r) -> 9 planes (rows or 1, T) of round r's triangle tiles
    next_entry_t(r) -> (rows or 1, 1) entry-t of round r's candidates
    at_ref/ar_ref: (rows, T) per-lane min t and the round that produced it
    """
    col = [rays_ref[c, :][:, None] for c in range(8)]      # (rows, 1)
    ox, oy, oz, dx, dy, dz, tl, ah = col
    cnt = cnt_ref[0]

    def cond(carry):
        r, at, _ = carry
        best = jnp.min(at, axis=1)[:, None]
        done = (ah > 0.0) & (best < tl)
        useful = jnp.where(done | (next_entry_t(r) >= best), 0, 1)
        return (r < cnt) & (jnp.max(useful) > 0)

    def body(carry):
        r, at, ar = carry
        t = _mt8(*planes_of(r), ox, oy, oz, dx, dy, dz, tl)
        upd = t < at
        return r + 1, jnp.where(upd, t, at), jnp.where(upd, r, ar)

    at0 = jnp.broadcast_to(tl, (rows, T_CLUSTER))
    ar0 = jnp.full((rows, T_CLUSTER), -1, jnp.int32)
    _, at, ar = jax.lax.while_loop(cond, body, (jnp.int32(0), at0, ar0))
    at_ref[...] = at
    ar_ref[...] = ar


def _tile_planes(tris_ref, cid):
    """9 coordinate planes of cluster tile(s) ``cid`` (scalar or (rows,))
    from the flat [K2+1, 9*T] table."""
    return [tris_ref[cid, pl.ds(k * T_CLUSTER, T_CLUSTER)] for k in range(9)]


def _list_kernel(cand_ref, ctn_ref, cnt_ref, rays_ref, tris_ref,
                 at_ref, ar_ref, *, maxc):
    """RB rays, each over its OWN candidate list.

    cand_ref: (RB, maxc) i32 cluster per (ray, round); empty slots carry
              the never-hit dummy tile id K2
    ctn_ref:  (RB, maxc) f32 candidate entry-t (BIG_T empty)
    cnt_ref:  (1,) the block's largest candidate count
    """
    last = maxc - 1
    _round_loop(
        rays_ref, cnt_ref, at_ref, ar_ref,
        lambda r: _tile_planes(tris_ref, cand_ref[:, r]),
        lambda r: ctn_ref[:, jnp.minimum(r, last)][:, None],
        RB,
    )


def _block_kernel(cand_ref, ctn_ref, cnt_ref, rays_ref, tris_ref,
                  at_ref, ar_ref, *, maxc, rb):
    """``rb`` rays over one SHARED candidate list.

    cand_ref: (maxc,) i32 the block's clusters (dummy id K2 when empty)
    ctn_ref:  (maxc,) f32 block entry-t (BIG_T empty)
    cnt_ref:  (1,) candidate count
    """
    last = maxc - 1
    _round_loop(
        rays_ref, cnt_ref, at_ref, ar_ref,
        lambda r: [p[None, :] for p in _tile_planes(tris_ref, cand_ref[r])],
        lambda r: ctn_ref[jnp.minimum(r, last)],
        rb,
    )


def _launch(share, cand_k, ctn, cnt, rays, tris_flat, maxc):
    """One kernel launch over g blocks -> (at, ar) [g*rb, T]."""
    if not INTERPRET and jax.default_backend() != "gpu":
        raise RuntimeError(
            "the list tracer's kernels compile only for a GPU; use the "
            "cluster tracer elsewhere"
        )
    rb = RB_SHARE if share else RB
    g = cnt.shape[0]
    if share:
        kernel = functools.partial(_block_kernel, maxc=maxc, rb=rb)
        list_spec = pl.BlockSpec((None, maxc), lambda b: (b, 0))
    else:
        kernel = functools.partial(_list_kernel, maxc=maxc)
        list_spec = pl.BlockSpec((RB, maxc), lambda b: (b, 0))
    return pl.pallas_call(
        kernel,
        grid=(g,),
        in_specs=[
            list_spec,                                        # cand ids
            list_spec,                                        # entry-t
            pl.BlockSpec((None, 1), lambda b: (b, 0)),        # count
            pl.BlockSpec((8, rb), lambda b: (0, b)),          # rays
            pl.BlockSpec(tris_flat.shape, lambda b: (0, 0)),  # tiles
        ],
        out_specs=(
            pl.BlockSpec((rb, T_CLUSTER), lambda b: (b, 0)),
            pl.BlockSpec((rb, T_CLUSTER), lambda b: (b, 0)),
        ),
        out_shape=(
            jax.ShapeDtypeStruct((g * rb, T_CLUSTER), jnp.float32),
            jax.ShapeDtypeStruct((g * rb, T_CLUSTER), jnp.int32),
        ),
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=1),
        backend=None if INTERPRET else "triton",
        interpret=INTERPRET,
        name="list_trace_shared" if share else "list_trace",
    )(cand_k, ctn, cnt[:, None], rays.T, tris_flat)


def _ray_sort_key(scene: ClusterScene, ray_o, ray_d):
    """Spatial sort key: 15-bit Morton of the origin cell (5 bits/axis over
    the scene bounds) above a 12-bit Morton of the DIRECTION (4 bits/axis
    over [-1,1]).  Sorted rays give the kernel homogeneous blocks, so the
    early exit actually fires (unsorted blocks almost always contain one
    straggler) and block-shared candidate unions stay tight.

    Direction bits matter as much as origin bits: a ray's cluster
    footprint is direction-dominated past the first few cells, and an
    origin-only key leaves same-origin primary bundles in scanline order,
    whose 32-ray unions are several times the per-ray list even for
    near-parallel rays; 2D-patch ordering via direction Morton collapses
    that."""
    lo = jnp.min(scene.sc_box[:, 0:3], axis=0)
    hi = jnp.max(scene.sc_box[:, 3:6], axis=0)
    q = jnp.clip((ray_o - lo) / jnp.maximum(hi - lo, 1e-6), 0.0, 1.0)
    cell = (q * 31.0).astype(jnp.int32)                       # [B,3]
    m = jnp.zeros(ray_o.shape[:1], jnp.int32)
    for b in range(5):
        for a in range(3):
            m = m | (((cell[:, a] >> b) & 1) << (3 * b + a))
    dq = (jnp.clip(ray_d * 0.5 + 0.5, 0.0, 1.0) * 15.0).astype(jnp.int32)
    dm = jnp.zeros(ray_d.shape[:1], jnp.int32)
    for b in range(4):
        for a in range(3):
            dm = dm | (((dq[:, a] >> b) & 1) << (3 * b + a))
    return (m << 12) | dm


def _run_once(scene: ClusterScene, ray_o, ray_d, t_lim, maxc, any_hit,
              sort=True, mask=None, share=False, force_dense=False,
              exact=False):
    """ONE candidate-list build (XLA) + list kernel + XLA reduction tail.
    Returns (t [B], packed winner cluster*T+lane [B] (-1 miss), resolved,
    overflow).  ``overflow`` here is the RAW extraction overflow (some
    list/union filled past maxc) — callers wanting the honest "answer may
    be wrong" flag use _run, which consults the per-ray certificates.

    ``any_hit``: scalar bool or [B] bool — rays flagged any-hit only need
    "does anything lie below t_lim"; the kernel retires them as soon as
    they are blocked.

    ``mask``: optional [B] bool — rays with mask=False are DEAD (their
    result is a guaranteed miss): they get t_lim=-BIG so the candidate
    build yields empty lists (tnear < t_lim never holds), and the sort key
    pushes them behind every live ray.  The launch is then BUCKETED: the
    candidate build and the kernel grid run only over the first
    1/64, 1/32, ..., 1/2 or all of the blocks — the smallest bucket
    covering all live rays — selected at runtime with lax.switch, so the
    sweep's cost scales with the live fraction (about 2.7x on the 200k
    dragon frame, PERF.md).

    ``share``: block-shared candidate lists + kernel (see module
    docstring) — one list per RB_SHARE sorted rays, each tile loaded once
    per block.
    """
    assert maxc <= 128, "winner packing uses at most 7 round bits"
    # rounds-per-lane field width for the packed (lane, round) winner
    rslot = 1 << max(1, (maxc - 1)).bit_length()
    B = ray_o.shape[0]
    rb = RB_SHARE if share else RB
    nb = -(-B // rb)
    pad = nb * rb - B
    k2 = scene.num_clusters
    # root-box cull: a ray that misses the scene's bounding box cannot hit
    # any cluster — fold it into the dead-lane mask so the sort pushes it
    # into trailing blocks the bucketed launch never runs.
    lo = jnp.min(scene.sc_box[:, 0:3], axis=0)
    hi = jnp.max(scene.sc_box[:, 3:6], axis=0)
    sign = jnp.where(ray_d < 0, -1.0, 1.0)
    inv = sign / jnp.maximum(jnp.abs(ray_d), 1e-30)
    t0r = (lo[None] - ray_o) * inv
    t1r = (hi[None] - ray_o) * inv
    tnr = jnp.max(jnp.minimum(t0r, t1r), axis=-1)
    tfr = jnp.min(jnp.maximum(t0r, t1r), axis=-1)
    root_hit = (tnr <= tfr) & (tfr > EPS) & (tnr < t_lim)
    explicit_mask = mask is not None
    mask = root_hit if mask is None else (mask & root_hit)
    t_lim = jnp.where(mask, t_lim, -BIG_T)
    if isinstance(any_hit, bool):
        ah = jnp.full((B,), 1.0 if any_hit else 0.0, jnp.float32)
    else:
        ah = any_hit.astype(jnp.float32)
    # ray fields packed into ONE [B,8] row array before permuting: one
    # wide row-gather instead of four narrow ones
    rays = jnp.concatenate(
        [ray_o, ray_d, t_lim[:, None], ah[:, None]], axis=1
    )
    perm = None
    if sort and B >= 4 * rb:
        key = _ray_sort_key(scene, ray_o, ray_d)
        if mask is not None:
            key = jnp.where(mask, key, jnp.int32(1) << 28)
        perm = jnp.argsort(key)
        rays = rays[perm]
    if pad:
        rays = jnp.concatenate([rays, jnp.zeros((pad, 8), rays.dtype)], 0)
    # flat tile table + a never-hit dummy row K2 for empty slots
    tris_flat = jnp.concatenate(
        [scene.cl_tris, jnp.zeros((1, 9 * T_CLUSTER), jnp.float32)], axis=0
    )

    # supercluster budget for the hierarchical prefilter scales with maxc
    # so one escalation knob (maxc, see main.py's overflow regrow) deepens
    # BOTH truncation points
    maxs = max(HIER_MAXS, maxc // 3)

    def run_bucket(g):
        """Candidate build + kernel over the first ``g`` blocks only."""
        rg = rays[: g * rb]
        # force_dense (escalation passes): skip the hier prefilter — its
        # per-block supercluster truncation poisons certificates, which
        # would leave big-scene escalations unable to certify; the dense
        # [rows, K2] build is exact and affordable on escalation passes
        big = (not force_dense) and scene.num_clusters > 2 * maxs * S_CLUSTER
        # the per-ray MEMBERSHIP certificate (cluster._membership_cert)
        # requires exact extraction
        covered = None
        if share and big:
            out = candidate_clusters_hier(
                scene, rg[:, 0:3], rg[:, 3:6], rg[:, 6], maxc,
                maxs=maxs, group=rb, grouped=True, exact=exact,
                ray_cert=exact,
            )                                             # (g, maxc)
            cand, ctn, overflow = out[:3]
            covered = out[3] if exact else None
        elif share:
            out = candidate_clusters_grouped(
                scene, rg[:, 0:3], rg[:, 3:6], rg[:, 6], maxc, rb,
                exact=exact, ray_cert=exact,
            )                                             # (g, maxc)
            cand, ctn, overflow = out[:3]
            covered = out[3] if exact else None
        elif big:
            # supercluster-prefiltered build (only where the column cut is
            # >=2x): extraction traffic scales with maxs*64 prefiltered
            # columns, not all K2 clusters
            cand, ctn, overflow = candidate_clusters_hier(
                scene, rg[:, 0:3], rg[:, 3:6], rg[:, 6], maxc,
                maxs=maxs, group=rb, exact=exact,
            )                                             # (gRB, maxc)
        else:
            cand, ctn, overflow = candidate_clusters(
                scene, rg[:, 0:3], rg[:, 3:6], rg[:, 6], maxc,
                exact=exact,
            )                                             # (gRB, maxc)
        cand_k = jnp.where(cand >= 0, cand, k2)  # empty slot -> dummy
        # candidate COUNT per program: bounds the kernel's round loop.
        # Counts the poisoned last slot too (a harmless re-test).
        cnt = jnp.sum(cand >= 0, axis=1, dtype=jnp.int32)
        if not share:
            cnt = cnt.reshape(-1, RB).max(axis=1)
        at, ar = _launch(share, cand_k, ctn, cnt, rg, tris_flat, maxc)

        # reduction tail INSIDE the bucket (dense reductions only — no
        # argmin) so its cost scales with the live prefix
        tlg = rg[:, 6]
        tmin = jnp.min(at, axis=1)                        # [gRB]
        hit = tmin < tlg
        # per-ray EXACTNESS certificate (nearest-first entry-t): a ray
        # with a full candidate list may have had farther clusters
        # dropped, but any dropped hit satisfies t >= its entry-t >=
        # ctn_last — so best <= ctn_last proves no dropped one could win
        lanes = jax.lax.broadcasted_iota(jnp.int32, at.shape, 1)
        sel = at <= tmin[:, None]
        # consistent (lane, round) winner: lane-major packing
        pk = jnp.min(
            jnp.where(sel, lanes * rslot + jnp.minimum(ar, rslot - 1),
                      jnp.int32(1 << 30)), axis=1)
        lane = pk // rslot
        rwin = jnp.minimum(pk % rslot, maxc - 1)
        if share:
            resolved = jnp.broadcast_to(
                (cand[:, maxc - 1] < 0)[:, None], (g, rb)
            ).reshape(-1) | (
                tmin
                <= jnp.broadcast_to(
                    ctn[:, maxc - 1][:, None], (g, rb)
                ).reshape(-1)
            )
            if covered is not None:
                # per-ray membership certificate: exact even in a FULL
                # block when all of THIS ray's hit clusters were kept —
                # fires for the unblocked any-hit rays the distance
                # certificate never could (t_lim BIG ⇒ tmin == t_lim)
                resolved = resolved | covered
            blk = jnp.arange(g * rb, dtype=jnp.int32) // rb
            cl = cand.reshape(-1)[blk * maxc + rwin]
        else:
            resolved = (cand[:, maxc - 1] < 0) | (tmin <= ctn[:, maxc - 1])
            cl = jnp.take_along_axis(cand, rwin[:, None], axis=1)[:, 0]
        packed = jnp.where(hit, cl * T_CLUSTER + lane, -1)
        t = jnp.where(hit, tmin, BIG_T)

        fill = nb * rb - g * rb
        if fill:
            # beyond the bucket: only dead rays (sort invariant) -> miss
            t = jnp.concatenate([t, jnp.full((fill,), BIG_T)], 0)
            packed = jnp.concatenate(
                [packed, jnp.full((fill,), -1, jnp.int32)], 0)
            resolved = jnp.concatenate(
                [resolved, jnp.ones((fill,), bool)], 0)
        return t, packed, resolved, overflow

    # the interpreter (CPU tests) buckets ONLY on explicit masks, and into
    # 2 buckets: each switch branch is another interpreted kernel build
    if perm is None or (INTERPRET and not explicit_mask):
        t, packed, resolved, overflow = run_bucket(nb)
    else:
        divs = (64,) if INTERPRET else BUCKET_DIVS
        buckets = sorted({max(1, -(-nb // d)) for d in divs} | {nb})
        n_live = jnp.sum(mask)
        idx = jnp.zeros((), jnp.int32)
        for bkt in buckets[:-1]:
            idx = idx + (n_live > bkt * rb).astype(jnp.int32)
        t, packed, resolved, overflow = jax.lax.switch(
            idx, [functools.partial(run_bucket, g) for g in buckets]
        )

    t, packed, resolved = t[:B], packed[:B], resolved[:B]
    if perm is not None:
        # ONE row-gather for the inverse permutation: packed ids fit f32
        # exactly (< 2^20 << 2^24)
        out = jnp.stack(
            [t, packed.astype(jnp.float32), resolved.astype(jnp.float32)],
            axis=1,
        )
        out = out[jnp.argsort(perm)]
        t = out[:, 0]
        packed = out[:, 1].astype(jnp.int32)
        resolved = out[:, 2] > 0.5
    # tag as remat residuals: the whole sweep (sort + candidate build +
    # kernel) is dead code in the integrators' backward replay
    return name_traversal(t, packed, resolved, overflow)


def _certain(any_hit, packed, resolved):
    """A ray's answer is CERTAIN when its exactness certificate holds, or
    (any-hit rays only) when it is already blocked — a found hit below
    t_lim proves "blocked" regardless of dropped clusters."""
    return resolved | (any_hit & (packed >= 0))


def _run(scene: ClusterScene, ray_o, ray_d, t_lim, maxc, any_hit,
         sort=True, mask=None, share=False, escalate=True):
    """Candidate lists (XLA) + list kernel + XLA reduction tail, EXACT.
    Returns (t [B], packed winner cluster*T+lane [B] (-1 miss), resolved,
    overflow).

    Exactness:
      * the main pass (per-ray lists, or block-union lists with
        share=True) is followed by a PER-RAY escalation pass over exactly
        the rays whose certificate did NOT fire (and, for any-hit rays,
        that are not already blocked) at doubled depth, compacted to at
        most ``cap`` rows, and skipped (lax.cond) on launches where every
        ray certified.  Its cost scales with the unresolved fraction:
        the compacted pass is bucketed like any masked launch.  ``escalate=False`` (callers that
        pinned maxc explicitly) keeps the single-pass behavior.
      * ``overflow`` is the HONEST flag: True iff some LIVE ray's answer
        is still uncertified after escalation (any(~certain & live)) —
        certificate-proven frames report no overflow
        (render_kernel.cpp:485-502 never drops hits; we flag instead of
        silently dropping).
    """
    B = ray_o.shape[0]
    # The overflow-regrow knob (ClusterScene.list_maxc, main.py) also
    # WIDENS the escalation cap: share-mode union depth is already at the
    # 128-slot packing cap by default, so re-rendering a flagged frame
    # must buy more escalation COVERAGE (the other way a frame stays
    # uncertified) — each regrow doubling halves the cap divisor, down to
    # a full-batch escalation sweep.
    div = ESC_CAP_DIV
    if scene.list_maxc:
        div = max(1, div // max(1, scene.list_maxc // DEFAULT_MAXC))
    cap = min(B, max(256, -(-B // (div * 256)) * 256))
    live = jnp.ones((B,), bool) if mask is None else mask
    if isinstance(any_hit, bool):
        ah = jnp.full((B,), any_hit, bool)
    else:
        ah = any_hit
    # The MAIN pass uses EXACT (full-recall) extraction: with approximate
    # recall, a FULL union row (count > maxc) with a recall miss keeps
    # got == maxc while swapping a true-nearest cluster for a farther one
    # — ctn_last then over-states the drop threshold and the distance
    # certificate could wrongly certify a ray whose true closest hit lives
    # in the missed cluster.  Exact extraction restores the certificate's
    # premise (kept = the maxc nearest), and is also what the per-ray
    # MEMBERSHIP certificate requires (cluster._membership_cert).
    will_escalate = escalate and (share or maxc < 128)
    t, packed, resolved, _raw = _run_once(
        scene, ray_o, ray_d, t_lim, maxc, any_hit, sort=sort, mask=mask,
        share=share, exact=True,
    )
    if will_escalate:
        redo = live & ~_certain(ah, packed, resolved)
        maxc2 = min(128, 2 * maxc)

        def _esc(redo):
            # COMPACTED per-ray pass: stable-partition the redo rays to
            # the front (one bool-key argsort), gather the first ``cap``
            # rows, run the per-ray exact pass on those ONLY, and merge
            # back with one [B] row-gather — no scatter, no full-batch
            # permutes.  Rays beyond ``cap`` stay uncertified and keep the
            # overflow flag honest — main.py's maxc regrow remains the
            # remedy, exactly as for a true list overflow.
            perm_r = jnp.argsort(~redo)              # stable: redo first
            idx = perm_r[:cap]
            t2c, p2c, r2c, _raw2 = _run_once(
                scene, ray_o[idx], ray_d[idx], t_lim[idx], maxc2, ah[idx],
                sort=True, mask=redo[idx], share=False, force_dense=True,
                exact=True,
            )
            # merge-back gather: original row -> its compact slot
            pos = jnp.cumsum(redo.astype(jnp.int32)) - 1
            slot = jnp.clip(pos, 0, cap - 1)
            out = jnp.stack(
                [t2c, p2c.astype(jnp.float32), r2c.astype(jnp.float32)],
                axis=1,
            )[slot]                                   # ONE [B] row-gather
            covered = redo & (pos < cap)
            t2 = jnp.where(covered, out[:, 0], t)
            p2 = jnp.where(covered, out[:, 1].astype(jnp.int32), packed)
            r2 = jnp.where(covered, out[:, 2] > 0.5, resolved)
            return t2, p2, r2

        t2, p2, r2 = jax.lax.cond(
            jnp.any(redo), _esc, lambda _: (t, packed, resolved), redo
        )
        # a certified per-ray answer IS the true closest hit (or true
        # miss), so it replaces the union answer outright: both passes
        # only ever report REAL hits (cluster boxes bound their
        # triangles), so a certified t2 satisfies t2 <= any real hit the
        # union found.  Uncertified escalations keep whichever is nearer
        # (best effort; the ray stays flagged).
        use2 = redo & (r2 | (t2 < t))
        t = jnp.where(use2, t2, t)
        packed = jnp.where(use2, p2, packed)
        resolved = resolved | (redo & r2)
    overflow = jnp.any(live & ~_certain(ah, packed, resolved))
    return name_traversal(t, packed, resolved, overflow)


def _default_maxc(share, scene: ClusterScene | None = None):
    """Candidate-list depth: the scene's escalation override if set (the
    overflow-regrow knob, ClusterScene.list_maxc — interpreted as the
    PER-RAY depth; share-mode unions scale by the same ratio as the
    module defaults, DEFAULT_MAXC_SHARE/DEFAULT_MAXC), else the module
    defaults.  Capped at 128 by the packed-winner encoding (see
    _run_once's rslot)."""
    if scene is not None and scene.list_maxc:
        base = scene.list_maxc
    else:
        return DEFAULT_MAXC_SHARE if share else DEFAULT_MAXC
    mc = base * DEFAULT_MAXC_SHARE // DEFAULT_MAXC if share else base
    return min(128, mc)


def _check_supported(scene: ClusterScene):
    if not supports(scene):
        raise ValueError(
            f"scene too large for the list tracer ({scene.num_clusters} "
            f"clusters > {MAX_CLUSTERS}); use the XLA cluster tracer"
        )


def closest_hit(scene: ClusterScene, ray_o, ray_d,
                maxc: int | None = None, mask=None, share=None,
                with_resolved: bool = False):
    """Closest-hit for rays [B,3] -> (t [B], prim [B] i32 -1 on miss,
    overflow) — overflow is the HONEST flag: True iff some live ray's
    answer is still UNCERTIFIED after (in share mode) the per-ray
    escalation pass; a frame whose every ray carries an exactness
    certificate reports False even when candidate lists filled up.
    ``mask``: False lanes are dead rays, reported as misses at ~zero cost
    (see _run_once).

    ``with_resolved=True`` appends the per-ray exactness certificate: a
    resolved ray's answer is provably the true closest hit (its best t is
    at or below the last candidate's entry-t, so no dropped cluster could
    hold a nearer hit).

    Pinning ``maxc`` selects the deterministic contract: PER-RAY lists of
    exactly that depth, exact (full-recall) extraction, and NO escalation
    pass — what you bound is what runs.  ``maxc=None`` (the default)
    selects the adaptive contract: block-shared lists at the module
    default depth plus a per-ray escalation pass over uncertified rays."""
    _check_supported(scene)
    share = _resolve_share(scene, share, maxc)
    escalate = maxc is None
    maxc = _default_maxc(share, scene) if maxc is None else maxc
    B = ray_o.shape[0]
    t_lim = jnp.full((B,), BIG_T, ray_o.dtype)
    t, packed, resolved, overflow = _run(scene, ray_o, ray_d, t_lim,
                                         maxc, any_hit=False, mask=mask,
                                         share=share, escalate=escalate)
    hit = packed >= 0
    win = jnp.maximum(packed, 0)
    prim = scene.cl_tri_idx[win // T_CLUSTER, win % T_CLUSTER]
    prim = jnp.where(hit, prim, -1)
    if with_resolved:
        return t, prim, overflow, resolved
    return t, prim, overflow


def any_hit(scene: ClusterScene, ray_o, ray_d, t_max,
            maxc: int | None = None, mask=None, share=None):
    """Occlusion: True where any triangle lies at t < t_max - SHADOW_EPS
    (reference evaluate_shadow_ray slack, render_kernel.cpp:744-759).
    Returns (blocked [B] bool, overflow) — overflow is the honest flag
    (see closest_hit); a blocked ray is always certain, so only unblocked
    uncertified rays can raise it.  ``mask``: False lanes are dead rays,
    reported unblocked at ~zero cost (see _run_once).  Pinning ``maxc``
    selects per-ray lists + exact extraction + no escalation (see
    closest_hit)."""
    _check_supported(scene)
    share = _resolve_share(scene, share, maxc)
    escalate = maxc is None
    maxc = _default_maxc(share, scene) if maxc is None else maxc
    t, packed, _resolved, overflow = _run(
        scene, ray_o, ray_d, t_max - SHADOW_EPS, maxc, any_hit=True,
        mask=mask, share=share, escalate=escalate,
    )
    return packed >= 0, overflow


def intersect_list(scene: ClusterScene, tris, ray_o, ray_d,
                   of: list | None = None, mask=None, share=None) -> Hit:
    """Closest-hit with a differentiable hit record (stop-gradient +
    finalize recompute, same recipe as ops.cluster.intersect_clusters)."""
    from sycl_ray_tracing.ops.intersect import finalize_hit

    o_ng = jax.lax.stop_gradient(ray_o)
    d_ng = jax.lax.stop_gradient(ray_d)
    _, prim, overflow = closest_hit(scene, o_ng, d_ng, mask=mask,
                                    share=share)
    if of is not None:
        of.append(overflow)
    return finalize_hit(ray_o, ray_d, tris, prim)


def multi_query(scene: ClusterScene, queries,
                maxc: int | None = None, share=None):
    """FUSED scene queries: one sort + candidate build + kernel launch for
    several ray sets (e.g. a bounce's continuation closest-hit + its NEE
    shadow rays).  Per-launch glue (ray sort, candidate build, dispatch) is
    paid once instead of per query, and mixing the sets improves block
    coherence (shadow rays sort next to the continuations that spawned
    them).

    ``queries``: list of (ray_o [B,3], ray_d [B,3], t_lim [B] or None for
    closest-hit, mask [B] or None[, any_hit bool]).  Returns (results,
    overflow) where results[i] = (t [B], packed [B]) — packed >= 0 means
    "a triangle lies at t < t_lim", which answers BOTH closest-hit
    (t, prim) and occlusion (blocked) exactly; an any-hit query just reads
    packed >= 0.  Shadow t_lims should already include the reference's
    SHADOW_EPS slack.  Queries flagged any_hit=True get the early exit
    (their t/packed still answer "blocked below t_lim" exactly, but t may
    not be the true closest once blocked — don't read it as one).
    Pinning ``maxc`` selects per-ray lists + exact extraction + no
    escalation (see closest_hit).
    """
    _check_supported(scene)
    share = _resolve_share(scene, share, maxc)
    escalate = maxc is None
    maxc = _default_maxc(share, scene) if maxc is None else maxc
    os_, ds_, tls, masks, ahs = [], [], [], [], []
    for q in queries:
        o, d, tl, m = q[:4]
        ah = bool(q[4]) if len(q) > 4 else False
        B = o.shape[0]
        os_.append(o)
        ds_.append(d)
        tls.append(jnp.full((B,), BIG_T, o.dtype) if tl is None else tl)
        masks.append(jnp.ones((B,), bool) if m is None else m)
        ahs.append(jnp.full((B,), ah, bool))
    # pure intersection oracle: gradients flow through finalize_hit
    # recompute (packed_to_prim + ops.intersect.finalize_hit), never
    # through the kernel itself
    o = jax.lax.stop_gradient(jnp.concatenate(os_, 0))
    d = jax.lax.stop_gradient(jnp.concatenate(ds_, 0))
    tl = jax.lax.stop_gradient(jnp.concatenate(tls, 0))
    mask = jnp.concatenate(masks, 0)
    ah = jnp.concatenate(ahs, 0)
    t, packed, _resolved, overflow = _run(scene, o, d, tl, maxc,
                                          any_hit=ah, mask=mask,
                                          share=share, escalate=escalate)
    results = []
    lo = 0
    for q in queries:
        B = q[0].shape[0]
        results.append((t[lo:lo + B], packed[lo:lo + B]))
        lo += B
    return results, overflow


def packed_to_prim(scene: ClusterScene, t, packed):
    """(t, packed) from multi_query -> (t, prim) closest-hit record."""
    hit = packed >= 0
    win = jnp.maximum(packed, 0)
    prim = scene.cl_tri_idx[win // T_CLUSTER, win % T_CLUSTER]
    return jnp.where(hit, t, BIG_T), jnp.where(hit, prim, -1)
