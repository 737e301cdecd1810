"""Multi-device SPMD rendering: Morton-range triangle partitioning + ray
data-parallelism over a `jax.sharding.Mesh`.

The reference is strictly single-GPU (SURVEY §2: no NCCL/MPI/multi-process
anywhere); this layer is a new first-class component of this framework.
Parallel axes:

- ``dp`` (data parallel): the ray/pixel batch is sharded; each device traces
  its block. Exact — every ray sees a full BVH of the triangles it's tested
  against.
- ``tp`` (tensor/spatial parallel — the Morton-range a.k.a. sequence-parallel
  axis): triangles are partitioned into Morton-contiguous ranges after the
  global sort; each device builds a local LBVH over its range and traces the
  rays against it; per-ray results combine across ``tp`` with an
  ``all_gather`` + lexicographic (t, shard) min — the collective replacing
  the reference's nonexistent communication layer.

Tie-breaking across shards is (t, then lowest shard = lowest Morton range);
within a shard it is the same DFS order as single-chip traversal.  A miss
carries shard-local triangle 0's attributes — composited output is identical
(alpha 0), raw RGB on misses may differ from single-chip, as in the reference
where miss pixels shade with triangleData[0] (Raytracing.compute:178-182).
"""
from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from unitysimpleraytracing.core.pytree import pytree_dataclass
from unitysimpleraytracing import constants as C
from unitysimpleraytracing.core.types import Bvh, Scene, Triangles
from unitysimpleraytracing.ops import dispatch, lbvh, sort, trace, unique


@pytree_dataclass
class ShardedScene:
    """Scene partitioned into Morton-contiguous triangle ranges.

    Every per-triangle array gains a leading shard axis (S, shard_cap, ...).
    ``counts[s]`` is the number of real triangles in shard s; ``global_tri``
    maps shard-local ids back to original mesh triangle ids.
    """

    tri_a: jnp.ndarray      # (S, cap, 3)
    tri_b: jnp.ndarray
    tri_c: jnp.ndarray
    a_uv: jnp.ndarray       # (S, cap, 2)
    b_uv: jnp.ndarray
    c_uv: jnp.ndarray
    a_normal: jnp.ndarray   # (S, cap, 3)
    b_normal: jnp.ndarray
    c_normal: jnp.ndarray
    aabb_min: jnp.ndarray   # (S, cap, 3)
    aabb_max: jnp.ndarray
    morton: jnp.ndarray     # (S, cap) uint32, sorted within shard; pad 0xFFFFFFFF
    global_tri: jnp.ndarray  # (S, cap) int32 original triangle ids
    counts: jnp.ndarray      # (S,) int32
    range_min: jnp.ndarray   # (S, 3) f32 — per-shard root AABB (early-out tests)
    range_max: jnp.ndarray   # (S, 3) f32

    @property
    def num_shards(self) -> int:
        return self.morton.shape[0]

    @property
    def shard_capacity(self) -> int:
        return self.morton.shape[1]


def partition_scene(
    scene: Scene,
    num_shards: int,
    pad_multiple: int = C.LANE,
    balance: str = "count",
) -> ShardedScene:
    """Split a scene into ``num_shards`` Morton-contiguous ranges.

    Triangles are globally sorted by Morton code, then divided into contiguous
    chunks (the Morton-range partitioning of SURVEY §5 / the BASELINE north
    star): spatial locality per shard, so most rays terminate against few
    shards.

    ``balance`` is the skew-handling policy for choosing range boundaries:
    - "count": equal triangle counts per shard (balances build work).
      DEVICE-SIDE and jit-compatible: one payload gather by the sorted
      order + static slices — no host round-trip (VERDICT r1 weak #7).
    - "area":  equal summed triangle surface area per shard (a SAH-style
      traversal-cost proxy — hot, large-area ranges get split across more
      shards, cold ranges get merged).  Boundaries are data-dependent, so
      this path stays host-driven.
    """
    if balance == "count":
        return _partition_scene_device(scene, num_shards, pad_multiple)
    n = scene.count
    keys, order = sort.sort_key_val(scene.morton, scene.tri_index)
    keys = np.asarray(keys)
    order = np.asarray(order)

    if balance == "area":
        t = scene.triangles
        a = np.asarray(t.a)[order[:n]]
        b = np.asarray(t.b)[order[:n]]
        c = np.asarray(t.c)[order[:n]]
        area = 0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=1)
        cum = np.cumsum(area)  # cum[i] = weight of triangles [0..i]
        targets = cum[-1] * np.arange(num_shards + 1) / num_shards
        # Boundary = the triangle whose cumulative range contains the target;
        # that straddling triangle starts the NEXT shard (so one dominant
        # triangle gets isolated rather than dragging everything into shard 0).
        bounds = np.searchsorted(cum, targets)
        bounds[0], bounds[-1] = 0, n
        bounds = np.maximum.accumulate(bounds)  # monotone, possibly-empty tails
    else:
        raise ValueError(f"unknown balance policy {balance!r}")

    per = int(np.max(bounds[1:] - bounds[:-1]))
    cap = C.pad_count(max(per, 2), pad_multiple)

    def shard_gather(arr, fill=0.0):
        arr = np.asarray(arr)
        out = np.full((num_shards, cap) + arr.shape[1:], fill, arr.dtype)
        for s in range(num_shards):
            lo, hi = bounds[s], bounds[s + 1]
            out[s, : hi - lo] = arr[order[lo:hi]]
        return jnp.asarray(out)

    counts = (bounds[1:] - bounds[:-1]).astype(np.int32)
    morton = np.full((num_shards, cap), C.KEY_PADDING, np.uint32)
    gtri = np.zeros((num_shards, cap), np.int32)
    rmin = np.zeros((num_shards, 3), np.float32)
    rmax = np.zeros((num_shards, 3), np.float32)
    amin_np, amax_np = np.asarray(scene.aabb_min), np.asarray(scene.aabb_max)
    for s in range(num_shards):
        lo, hi = bounds[s], bounds[s + 1]
        morton[s, : hi - lo] = keys[lo:hi]
        gtri[s, : hi - lo] = order[lo:hi]
        if hi > lo:
            rmin[s] = amin_np[order[lo:hi]].min(axis=0)
            rmax[s] = amax_np[order[lo:hi]].max(axis=0)
        else:  # empty shard: inverted box no ray can hit
            rmin[s] = np.inf
            rmax[s] = -np.inf

    t = scene.triangles
    return ShardedScene(
        tri_a=shard_gather(t.a),
        tri_b=shard_gather(t.b),
        tri_c=shard_gather(t.c),
        a_uv=shard_gather(t.a_uv),
        b_uv=shard_gather(t.b_uv),
        c_uv=shard_gather(t.c_uv),
        a_normal=shard_gather(t.a_normal),
        b_normal=shard_gather(t.b_normal),
        c_normal=shard_gather(t.c_normal),
        aabb_min=shard_gather(scene.aabb_min),
        aabb_max=shard_gather(scene.aabb_max),
        morton=jnp.asarray(morton),
        global_tri=jnp.asarray(gtri),
        counts=jnp.asarray(counts),
        range_min=jnp.asarray(rmin),
        range_max=jnp.asarray(rmax),
    )


@partial(jax.jit, static_argnames=("num_shards", "pad_multiple"))
def _partition_scene_device(
    scene: Scene, num_shards: int, pad_multiple: int = C.LANE
) -> ShardedScene:
    """Count-balanced Morton-range partition, entirely on device.

    Boundaries of equal-count shards depend only on the STATIC ``scene.count``
    (bounds[s] = min(s * ceil(n/S), n)), so every shard is a static slice of
    the sorted arrays; the payload permutation is a single row gather of one
    packed (cap, 30) matrix (vertices, normals, per-tri AABBs, uvs) instead
    of 11 separate gathers.  Fully jit-compatible — `build_bvh_chunked` and
    the 1M-triangle flow never touch the host."""
    n = scene.count
    keys, order = sort.sort_key_val(scene.morton, scene.tri_index)

    bounds = [min(math.ceil(n / num_shards) * s, n) for s in range(num_shards + 1)]
    per = max(bounds[s + 1] - bounds[s] for s in range(num_shards))
    cap = C.pad_count(max(per, 2), pad_multiple)

    t = scene.triangles
    # Columns: a(3) b(3) c(3) an(3) bn(3) cn(3) amin(3) amax(3) auv(2) buv(2) cuv(2)
    payload = jnp.concatenate(
        [
            t.a, t.b, t.c,
            t.a_normal, t.b_normal, t.c_normal,
            scene.aabb_min, scene.aabb_max,
            t.a_uv, t.b_uv, t.c_uv,
        ],
        axis=1,
    )
    # The permutation gather, in 8-column groups.
    sortedp = jnp.concatenate(
        [payload[:, c : c + 8][order] for c in range(0, payload.shape[1], 8)],
        axis=1,
    )

    def shard_rows(arr, fill):
        """(full,) or (full, k) sorted array → (S, cap, ...) static slices."""
        blocks = []
        for s in range(num_shards):
            lo, hi = bounds[s], bounds[s + 1]
            blk = arr[lo:hi]
            pad_n = cap - (hi - lo)
            if pad_n:
                pad_blk = jnp.full((pad_n,) + arr.shape[1:], fill, arr.dtype)
                blk = jnp.concatenate([blk, pad_blk])
            blocks.append(blk)
        return jnp.stack(blocks)

    sp = shard_rows(sortedp, 0.0)          # (S, cap, 30)
    morton = shard_rows(keys, C.KEY_PADDING)
    gtri = shard_rows(order, 0)
    counts = jnp.asarray(
        [bounds[s + 1] - bounds[s] for s in range(num_shards)], jnp.int32
    )

    rows = jnp.arange(cap, dtype=jnp.int32)[None, :]
    live = (rows < counts[:, None])[..., None]
    amin_s, amax_s = sp[..., 18:21], sp[..., 21:24]
    range_min = jnp.min(jnp.where(live, amin_s, jnp.inf), axis=1)
    range_max = jnp.max(jnp.where(live, amax_s, -jnp.inf), axis=1)

    return ShardedScene(
        tri_a=sp[..., 0:3], tri_b=sp[..., 3:6], tri_c=sp[..., 6:9],
        a_normal=sp[..., 9:12], b_normal=sp[..., 12:15], c_normal=sp[..., 15:18],
        aabb_min=amin_s, aabb_max=amax_s,
        a_uv=sp[..., 24:26], b_uv=sp[..., 26:28], c_uv=sp[..., 28:30],
        morton=morton, global_tri=gtri, counts=counts,
        range_min=range_min, range_max=range_max,
    )


def make_mesh(dp: int, tp: int, devices=None) -> Mesh:
    """Device mesh with ray-parallel (dp) × triangle-parallel (tp) axes."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    assert devices.size >= dp * tp, f"need {dp*tp} devices, have {devices.size}"
    return Mesh(devices[: dp * tp].reshape(dp, tp), ("dp", "tp"))


def _local_build(morton_l, aabb_min_l, aabb_max_l, count):
    """Per-shard LBVH over already-sorted local keys (sort is a no-op pass
    kept for generality when shards are re-fed unsorted data).

    Skewed partitions can leave a shard with 0 or 1 real triangles, for which
    the Karras topology is undefined (the reference requires >= 2 leaves too);
    clamping the effective count to 2 folds padding rows in as extra leaves —
    harmless, since padding geometry is degenerate (a=b=c=0 → Möller–Trumbore
    det≈0 reject) and can never win a hit."""
    cap = morton_l.shape[0]
    iota = jnp.arange(cap, dtype=jnp.int32)
    keys, sorted_tri = jax.lax.sort_key_val(morton_l, iota, is_stable=True)
    count = jnp.maximum(count, 2)
    keys = unique.distribute_keys(keys, count)
    return lbvh.build_bvh_from_sorted(
        keys, sorted_tri, aabb_min_l, aabb_max_l, count, static_count=cap
    )


def _shard_scene_view(ss_fields, cap: int) -> Scene:
    """Wrap one shard's local arrays in the Scene container traverse expects."""
    (ta, tb, tc, auv, buv, cuv, an, bn, cn, amin, amax, morton, gtri) = ss_fields
    tris = Triangles(
        a=ta, b=tb, c=tc,
        a_uv=auv, b_uv=buv, c_uv=cuv,
        a_normal=an, b_normal=bn, c_normal=cn,
        count=cap,
    )
    return Scene(
        triangles=tris,
        aabb_min=amin,
        aabb_max=amax,
        morton=morton,
        tri_index=gtri,
        count=cap,
    )


def _trace_and_payload(ss_fields, count, origins, dirs, impl="auto"):
    """Local build + trace + shading payload for one shard."""
    cap = ss_fields[11].shape[0]
    scene_l = _shard_scene_view(ss_fields, cap)
    bvh = _local_build(ss_fields[11], ss_fields[9], ss_fields[10], count)
    hits = dispatch.trace_rays(scene_l, bvh, origins, dirs, impl=impl)

    tri = hits.tri
    w = 1.0 - hits.u - hits.v
    bary = (w[:, None], hits.u[:, None], hits.v[:, None])
    uv = bary[0] * scene_l.triangles.a_uv[tri] + bary[1] * scene_l.triangles.b_uv[tri] + bary[2] * scene_l.triangles.c_uv[tri]
    normal = (
        bary[0] * scene_l.triangles.a_normal[tri]
        + bary[1] * scene_l.triangles.b_normal[tri]
        + bary[2] * scene_l.triangles.c_normal[tri]
    )
    g_tri = ss_fields[12][tri]
    return hits.t, g_tri, hits.u, hits.v, uv, normal


def render_hits_sharded(
    sscene: ShardedScene,
    origins: jnp.ndarray,
    dirs: jnp.ndarray,
    mesh: Mesh,
    impl: str = "auto",
):
    """SPMD build + trace over a (dp, tp) mesh.

    Returns per-ray (t, global_tri, u, v, uv(2), normal(3)) with the shading
    payload already interpolated (so no cross-shard triangle gather is ever
    needed).  Rays sharded over dp; triangle ranges over tp; the per-ray
    combine is an all_gather over tp + first-minimum select.  ``impl``
    selects the per-device traversal engine (``auto`` → the GPU kernel on a
    GPU, ops/dispatch.resolve_impl).
    """
    fields = (
        sscene.tri_a, sscene.tri_b, sscene.tri_c,
        sscene.a_uv, sscene.b_uv, sscene.c_uv,
        sscene.a_normal, sscene.b_normal, sscene.c_normal,
        sscene.aabb_min, sscene.aabb_max,
        sscene.morton, sscene.global_tri,
    )
    tp_size = mesh.shape["tp"]
    assert sscene.num_shards == tp_size, (
        f"scene has {sscene.num_shards} shards but mesh tp={tp_size}"
    )
    assert origins.shape[0] % mesh.shape["dp"] == 0, "rays must divide dp"

    field_spec = tuple(P("tp") for _ in fields)

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(field_spec, P("tp"), P("dp"), P("dp")),
        out_specs=P("dp"),
        check_vma=False,
    )
    def step(fields_blk, counts_blk, origins_blk, dirs_blk):
        local = tuple(f[0] for f in fields_blk)  # drop the size-1 shard axis
        count = counts_blk[0]
        payload = _trace_and_payload(local, count, origins_blk, dirs_blk, impl)
        # Combine across Morton ranges: (tp, R) gathered, first-min wins.
        gathered = tuple(jax.lax.all_gather(p, "tp") for p in payload)
        t_all = gathered[0]
        win = jnp.argmin(t_all, axis=0)  # ties → lowest shard index

        def pick(g):
            idx = win.reshape((1,) + win.shape + (1,) * (g.ndim - 2))
            return jnp.take_along_axis(g, idx, axis=0)[0]

        return tuple(pick(g) for g in gathered)

    return step(fields, sscene.counts, origins, dirs)


def render_hits_ring(
    sscene: ShardedScene,
    origins: jnp.ndarray,
    dirs: jnp.ndarray,
    mesh: Mesh,
    impl: str = "auto",
):
    """Ring-pipelined ray exchange over the ``tp`` axis — the ray analog of
    ring attention (SURVEY §5: CP/Ulysses patterns applied to rays).

    Where `render_hits_sharded` replicates every dp ray block across all tp
    shards and all_gathers S payloads per ray, here rays are sharded over the
    FULL (dp × tp) mesh and circulate the tp ring with ``ppermute``: each of
    the S hops traces the resident ray block against the local shard's BVH
    and folds the running best hit.  Per-ray exchanged state is constant
    (6 ray + 14 hit floats), independent of S, and XLA overlaps each hop's
    ppermute with the next traversal (async collectives) — the
    exchange-overlapped-with-traversal design of the BASELINE north star.

    Early-out skew handling: a ray skips a hop when its running best t is
    closer than its entry distance to the shard's root AABB (monotonicity:
    any hit inside the box is at least entry-distance away — so a gated ray
    can never improve its best, making the skip EXACT).  Gated rays are
    substituted with a guaranteed-miss ray before traversal, so they drop out
    of the packet kernel's union DFS immediately; a fully-gated packet
    terminates after a single root step — the skip saves real compute, not
    just the fold.

    Returns the same payload tuple as `render_hits_sharded`.  ``impl`` as in
    `render_hits_sharded`.
    """
    fields = (
        sscene.tri_a, sscene.tri_b, sscene.tri_c,
        sscene.a_uv, sscene.b_uv, sscene.c_uv,
        sscene.a_normal, sscene.b_normal, sscene.c_normal,
        sscene.aabb_min, sscene.aabb_max,
        sscene.morton, sscene.global_tri,
    )
    tp_size = mesh.shape["tp"]
    assert sscene.num_shards == tp_size
    total = mesh.shape["dp"] * tp_size
    assert origins.shape[0] % total == 0, "rays must divide dp*tp"

    field_spec = tuple(P("tp") for _ in fields)

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(field_spec, P("tp"), P("tp"), P("tp"),
                  P(("dp", "tp")), P(("dp", "tp"))),
        out_specs=P(("dp", "tp")),
        check_vma=False,
    )
    def step(fields_blk, counts_blk, rmin_blk, rmax_blk, origins_blk, dirs_blk):
        local = tuple(f[0] for f in fields_blk)
        count = counts_blk[0]
        rmin, rmax = rmin_blk[0], rmax_blk[0]
        cap = local[11].shape[0]
        scene_l = _shard_scene_view(local, cap)
        bvh = _local_build(local[11], local[9], local[10], count)
        R = origins_blk.shape[0]

        def entry_t(o, d):
            """Slab entry distance to this shard's root box; +inf on miss."""
            inv = 1.0 / d
            t1 = (rmin[None, :] - o) * inv
            t2 = (rmax[None, :] - o) * inv
            tmin = jnp.max(jnp.minimum(t1, t2), axis=1)
            tmax = jnp.min(jnp.maximum(t1, t2), axis=1)
            hit = (tmax > tmin) & (tmax > 0)
            return jnp.where(hit, jnp.maximum(tmin, 0.0), jnp.inf)

        # A ray that can never see this shard's box: origin far past the
        # root box's max corner, pointing further away (slab tmax < 0).
        # nan_to_num guards the empty-shard sentinel box (rmax = -inf).
        base = jnp.nan_to_num(rmax, posinf=0.0, neginf=0.0)
        miss_o = base + jnp.maximum(jnp.max(jnp.abs(base)), 1.0) + 1e6
        miss_d = jnp.asarray([1.0, 0.0, 0.0], jnp.float32)

        def trace_fold(o, d, best):
            t_b, tri_b, u_b, v_b, uv_b, n_b = best
            gate = entry_t(o, d) < t_b  # early-out: box can't beat best
            o_eff = jnp.where(gate[:, None], o, miss_o[None, :])
            d_eff = jnp.where(gate[:, None], d, miss_d[None, :])
            h = dispatch.trace_rays(
                scene_l, bvh, o_eff, d_eff, impl=impl, t_init=t_b
            )
            win = gate & (h.t < t_b)
            tri = h.tri
            w = 1.0 - h.u - h.v
            uv = (
                w[:, None] * scene_l.triangles.a_uv[tri]
                + h.u[:, None] * scene_l.triangles.b_uv[tri]
                + h.v[:, None] * scene_l.triangles.c_uv[tri]
            )
            nrm = (
                w[:, None] * scene_l.triangles.a_normal[tri]
                + h.u[:, None] * scene_l.triangles.b_normal[tri]
                + h.v[:, None] * scene_l.triangles.c_normal[tri]
            )
            gtri = local[12][tri]
            win2 = win[:, None]
            return (
                jnp.where(win, h.t, t_b),
                jnp.where(win, gtri, tri_b),
                jnp.where(win, h.u, u_b),
                jnp.where(win, h.v, v_b),
                jnp.where(win2, uv, uv_b),
                jnp.where(win2, nrm, n_b),
            )

        best = (
            jnp.full((R,), C.MAX_FLOAT, jnp.float32),
            jnp.zeros((R,), jnp.int32),
            jnp.zeros((R,), jnp.float32),
            jnp.zeros((R,), jnp.float32),
            jnp.zeros((R, 2), jnp.float32),
            jnp.zeros((R, 3), jnp.float32),
        )
        o, d = origins_blk, dirs_blk
        perm = [(i, (i + 1) % tp_size) for i in range(tp_size)]
        for _hop in range(tp_size):
            best = trace_fold(o, d, best)
            if tp_size > 1:
                # Rotate rays+state around the tp ring; after all tp_size
                # rotations every block is back on its home device.
                o, d, *best = [
                    jax.lax.ppermute(x, "tp", perm) for x in (o, d, *best)
                ]
                best = tuple(best)
        return best

    return step(
        fields, sscene.counts, sscene.range_min, sscene.range_max, origins, dirs
    )


def _shuffle_plan(o, d, rmin_all, rmax_all):
    """Routing of `render_hits_shuffle` for one device's (R,) rays, inside a
    ``shard_map`` over ``tp``.

    Returns ``(r_of, valid_pair, send, fwd, rev)``: the ray of each of the
    K = S·R send rows and whether the row is live, the (K, 6) send buffer
    (origin, direction; rows grouped by destination shard), and the
    ``(input_offsets, send_sizes, output_offsets)`` of the forward exchange
    and of the reverse one that brings the results home (`_exchange_blocks`;
    ``output_offsets`` says where each SENT block lands on its receiver).
    """
    S = rmin_all.shape[0]
    R = o.shape[0]
    K = S * R
    me = jax.lax.axis_index("tp")

    # Which shards does each ray enter? (R, S) slab test.
    inv = 1.0 / d
    t1 = (rmin_all[None, :, :] - o[:, None, :]) * inv[:, None, :]
    t2 = (rmax_all[None, :, :] - o[:, None, :]) * inv[:, None, :]
    tmin = jnp.max(jnp.minimum(t1, t2), axis=2)
    tmax = jnp.min(jnp.maximum(t1, t2), axis=2)
    overlap = (tmax > tmin) & (tmax > 0)

    # Bucket rays by destination (groups contiguous, ray-ordered).
    ray_ids = jnp.arange(R, dtype=jnp.int32)
    pair_key = jnp.where(
        overlap.T,
        jnp.arange(S, dtype=jnp.int32)[:, None] * R + ray_ids[None, :],
        jnp.int32(2**31 - 1),
    ).reshape(K)
    pair_key = jnp.sort(pair_key)
    valid_pair = pair_key < 2**31 - 1
    r_of = jnp.where(valid_pair, pair_key % R, 0)

    def excl(x, axis=0):  # exclusive cumsum
        return jnp.cumsum(x, axis=axis) - x

    dest_counts = jnp.sum(overlap, axis=0, dtype=jnp.int32)   # (S,) I send to each
    sizes = jax.lax.all_gather(dest_counts, "tp")             # (S, S) [src, dst]
    col_me = sizes[:, me]                                     # each src sends me
    in_off = excl(dest_counts)            # my block for dst j in my send buffer
    out_off = excl(sizes)[me]             # my block's place in dst j's recv buffer
    my_in_offs = excl(col_me)             # src i's block in my recv buffer
    rev_out_off = excl(sizes, axis=1)[:, me]  # j's send-buffer offset for me

    send = jnp.where(
        valid_pair[:, None], jnp.concatenate([o, d], axis=1)[r_of], 0.0
    )
    fwd = (in_off, dest_counts, out_off)
    rev = (my_in_offs, col_me, rev_out_off)
    return r_of, valid_pair, send, fwd, rev


def _exchange_blocks(op, out, in_off, send_sizes, out_off, axis_name):
    """Send ``op[in_off[j] : in_off[j] + send_sizes[j]]`` to device j, where
    it is written into ``out`` at ``out_off[j]``; rows nobody writes keep
    ``out``'s value.

    Every block is padded to the operand's P rows and exchanged with one
    dense `all_to_all` of (S, P, C), so the volume is S·P rows per device
    whatever the sizes.  XLA's `ragged_all_to_all` sends only the live rows
    and meets its documented semantics alone, but inside the shuffle's
    program on four H100s its one-shot intra-host kernel loses slices
    (`benchmarks/ragged_a2a_check.py`, PERF.md); XLA:CPU has none.
    """
    S = send_sizes.shape[0]
    P = op.shape[0]
    p = jnp.arange(P, dtype=jnp.int32)
    rows = jnp.clip(in_off[:, None] + p[None, :], 0, P - 1)       # (S, P)
    msk = p[None, :] < send_sizes[:, None]
    dense = jnp.where(msk[..., None], op[rows], 0)                # (S, P, C)
    dense = jax.lax.all_to_all(dense, axis_name, 0, 0)            # slot i ← src i
    placement = jax.lax.all_to_all(out_off, axis_name, 0, 0)      # (S,)
    got = jax.lax.all_to_all(send_sizes, axis_name, 0, 0)         # rows from src i
    dst = placement[:, None] + p[None, :]
    dst = jnp.where(p[None, :] < got[:, None], dst, out.shape[0])
    return out.at[dst.reshape(-1)].set(
        dense.reshape(S * P, -1), mode="drop"
    )


def render_hits_shuffle(
    sscene: ShardedScene,
    origins: jnp.ndarray,
    dirs: jnp.ndarray,
    mesh: Mesh,
    impl: str = "auto",
):
    """Ray shuffle — the BASELINE.json north-star exchange ("rays
    distributed-shuffled to the host owning the relevant BVH partition").

    Where the ring circulates EVERY ray through EVERY shard (S hops of
    constant volume), here each ray is routed only to the shards whose root
    AABB it enters: rays are bucketed per destination, exchanged along the
    ``tp`` axis (`_exchange_blocks`: per-destination blocks, padded), traced
    once on the owning device with the production kernel, and the per-copy
    results return by the reverse exchange;
    the origin device folds a (t, shard)-lexicographic min, which reproduces
    the all_gather combine's tie rule (lowest Morton range wins).

    Exactness: a triangle's inflated AABB is contained in its shard's root
    box, so any ray with a hit in shard s slab-enters s's box (same test,
    same arithmetic as the traversal's root step) — routing by box overlap
    loses no hits.  Skew handling is partition-time: hot ranges are split by
    ``partition_scene(balance='area')``; the receive buffers are sized for
    the worst case (S·R_local rows), so imbalance costs memory/compute but
    never correctness.

    Returns the same payload tuple as `render_hits_sharded`.
    """
    fields = (
        sscene.tri_a, sscene.tri_b, sscene.tri_c,
        sscene.a_uv, sscene.b_uv, sscene.c_uv,
        sscene.a_normal, sscene.b_normal, sscene.c_normal,
        sscene.aabb_min, sscene.aabb_max,
        sscene.morton, sscene.global_tri,
    )
    S = mesh.shape["tp"]
    assert sscene.num_shards == S
    total = mesh.shape["dp"] * S
    assert origins.shape[0] % total == 0, "rays must divide dp*tp"
    R = origins.shape[0] // total
    K = S * R  # send/recv buffer rows (worst case: every ray to every shard)
    assert K < (1 << 24), "pack_key layout needs S*R < 2^24"

    field_spec = tuple(P("tp") for _ in fields)

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(field_spec, P("tp"), P(), P(),
                  P(("dp", "tp")), P(("dp", "tp"))),
        out_specs=P(("dp", "tp")),
        check_vma=False,
    )
    def step(fields_blk, counts_blk, rmin_all, rmax_all, origins_blk, dirs_blk):
        local = tuple(f[0] for f in fields_blk)
        count = counts_blk[0]
        cap = local[11].shape[0]
        scene_l = _shard_scene_view(local, cap)
        bvh = _local_build(local[11], local[9], local[10], count)
        r_of, valid_pair, send, fwd, rev = _shuffle_plan(
            origins_blk, dirs_blk, rmin_all, rmax_all
        )

        # Guaranteed-miss filler so unreceived recv rows die in one kernel step.
        base = jnp.nan_to_num(
            jnp.max(local[10], axis=0), posinf=0.0, neginf=0.0
        )
        miss_o = base + jnp.maximum(jnp.max(jnp.abs(base)), 1.0) + 1e6
        recv_init = jnp.broadcast_to(
            jnp.concatenate([miss_o, jnp.asarray([1.0, 0.0, 0.0])]), (K, 6)
        )
        recv = _exchange_blocks(send, recv_init, *fwd, "tp")

        # --- 3. trace the received rays against the local shard
        h = dispatch.trace_rays(scene_l, bvh, recv[:, 0:3], recv[:, 3:6], impl=impl)
        tri = h.tri
        w = 1.0 - h.u - h.v
        uv = (
            w[:, None] * scene_l.triangles.a_uv[tri]
            + h.u[:, None] * scene_l.triangles.b_uv[tri]
            + h.v[:, None] * scene_l.triangles.c_uv[tri]
        )
        nrm = (
            w[:, None] * scene_l.triangles.a_normal[tri]
            + h.u[:, None] * scene_l.triangles.b_normal[tri]
            + h.v[:, None] * scene_l.triangles.c_normal[tri]
        )
        gtri_f = local[12][tri].astype(jnp.float32)  # exact: ids < 2^24
        res = jnp.concatenate(
            [h.t[:, None], gtri_f[:, None], h.u[:, None], h.v[:, None], uv, nrm],
            axis=1,
        )  # (K, 9)

        # --- 4. reverse exchange: my sent blocks come home
        back = _exchange_blocks(
            res, jnp.full((K, 9), C.MAX_FLOAT, jnp.float32), *rev, "tp"
        )

        # --- 5. fold: per-ray min t, ties to lowest (shard, row)
        t_rows = jnp.where(valid_pair, back[:, 0], C.MAX_FLOAT)
        t_best = jnp.full((R,), C.MAX_FLOAT, jnp.float32).at[r_of].min(
            t_rows, mode="drop"
        )
        is_best = valid_pair & (t_rows == t_best[r_of])
        rows = jnp.arange(K, dtype=jnp.int32)
        pack = jnp.where(is_best, rows, jnp.int32(2**31 - 1))
        win = jnp.full((R,), 2**31 - 1, jnp.int32).at[r_of].min(pack, mode="drop")
        hit_ray = win < 2**31 - 1
        row = jnp.where(hit_ray, win, 0)
        sel = back[row]
        zero = jnp.zeros((R,), jnp.float32)
        return (
            t_best,
            jnp.where(hit_ray, sel[:, 1].astype(jnp.int32), 0),
            jnp.where(hit_ray, sel[:, 2], zero),
            jnp.where(hit_ray, sel[:, 3], zero),
            jnp.where(hit_ray[:, None], sel[:, 4:6], 0.0),
            jnp.where(hit_ray[:, None], sel[:, 6:9], 0.0),
        )

    return step(
        fields, sscene.counts, sscene.range_min, sscene.range_max, origins, dirs
    )


def render_hits_dp(scene: Scene, bvh: Bvh, origins, dirs, mesh: Mesh, impl: str = "auto"):
    """Pure ray-data-parallel traversal: scene+BVH replicated, rays sharded.

    Exact same results as single-chip traversal (each ray sees the full
    BVH); ``impl`` selects the per-device engine."""

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P(), P("dp"), P("dp")),
        out_specs=P("dp"),
        check_vma=False,
    )
    def step(scene_r, bvh_r, origins_blk, dirs_blk):
        h = dispatch.trace_rays(scene_r, bvh_r, origins_blk, dirs_blk, impl=impl)
        return h.t, h.tri, h.u, h.v

    t, tri, u, v = step(scene, bvh, origins, dirs)
    from unitysimpleraytracing.core.types import HitRecord

    return HitRecord(t=t, tri=tri, u=u, v=v)
