"""Large-scene path: chunked BVH build + traversal.

The scene is split into Morton-contiguous chunks (the same partitioning the
distributed layer shards across devices, parallel/dist.py), each chunk gets
its own LBVH, and rays fold a running best hit over the chunks, nearest
chunk first, so the running best prunes the far chunks at their roots.
The reference has no analog (it is hard-capped at 524 288 triangles,
Constants.cs:6).

Tie semantics: equal-t hits resolve to the chunk traced first (chunks are
scheduled near-first from the ray origin, see trace_chunked); within a
chunk, DFS order.  Same bounded exact-tie class as the distributed combines.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from unitysimpleraytracing.core.pytree import pytree_dataclass
from unitysimpleraytracing import constants as C
from unitysimpleraytracing.core.types import Bvh, HitRecord, Scene, Triangles
from unitysimpleraytracing.ops import sah, trace_gpu
from unitysimpleraytracing.ops.dispatch import trace_rays
from unitysimpleraytracing.parallel import dist

# The largest chunk the traversal kernel takes: a chunk's capacity, once the
# partition pads it to the lane multiple, stays below the record metas'
# 21-bit id field (`trace_gpu.MAX_IDS`).  Fewer chunks fold faster, since the
# fold launches the kernel once per chunk.
DEFAULT_CHUNK_CAPACITY = trace_gpu.MAX_IDS - C.LANE


@pytree_dataclass
class ChunkedBvh:
    """Morton-range chunked scene + per-chunk LBVHs (stacked on axis 0).

    ``tables`` carries the pre-packed traversal kernel tables per chunk,
    packed once at build time, not per frame inside the trace jit."""

    sscene: dist.ShardedScene
    bvhs: Bvh  # every field stacked (S, ...)
    tables: jnp.ndarray  # (S, ...) pre-packed kernel tables per chunk

    @property
    def num_chunks(self) -> int:
        return self.sscene.num_shards

    @property
    def capacity(self) -> int:
        return self.sscene.shard_capacity


def _local_build_sah(morton_l, aabb_min_l, aabb_max_l, count):
    """Per-shard sweep-SAH build (the ``builder="sah"`` analog of
    dist._local_build; same degenerate-shard clamping)."""
    cap = morton_l.shape[0]
    iota = jnp.arange(cap, dtype=jnp.int32)
    _, sorted_tri = jax.lax.sort_key_val(morton_l, iota, is_stable=True)
    count = jnp.maximum(count, 2)
    return sah.build_bvh_sah_from_sorted(
        sorted_tri, aabb_min_l, aabb_max_l, count, static_count=cap
    )


def _local_build_sah_free(morton_l, aabb_min_l, aabb_max_l, count):
    """Per-shard FREE-ORDER sweep-SAH build (``builder="sah_free"``): the
    Morton sort seeds the permutation, the builder re-orders leaves per node
    (ops/sah.build_topology_sah_free)."""
    cap = morton_l.shape[0]
    iota = jnp.arange(cap, dtype=jnp.int32)
    _, sorted_tri = jax.lax.sort_key_val(morton_l, iota, is_stable=True)
    count = jnp.maximum(count, 2)
    return sah.build_bvh_sah_free(
        sorted_tri, aabb_min_l, aabb_max_l, count, static_count=cap
    )


@functools.partial(jax.jit, static_argnames=("num_chunks", "builder"))
def _partition_build(scene: Scene, num_chunks: int, builder: str):
    sscene = dist.partition_scene(scene, num_chunks)
    fn = {
        "sah": _local_build_sah, "sah_free": _local_build_sah_free,
    }.get(builder, dist._local_build)
    bvhs = jax.vmap(fn)(
        sscene.morton, sscene.aabb_min, sscene.aabb_max, sscene.counts
    )
    return sscene, bvhs


def build_bvh_chunked(
    scene: Scene,
    chunk_capacity: int = DEFAULT_CHUNK_CAPACITY,
    builder: str | None = None,
) -> ChunkedBvh:
    """Partition + build one LBVH per chunk (vmapped over chunks) and pack
    each chunk's BVH4 record table (ops/trace_gpu).

    ``builder``: per-chunk topology builder; concrete builds default to
    "sah" (ops/sah.py), traced builds (inside a caller's jit) to "karras".

    For concrete (non-traced) scenes the tables are sized to the ACTUAL
    max per-chunk record count (one host scalar read at build time) instead
    of the worst-case (2n+1)/3 bound.  Inside a jit trace the worst-case
    bound is kept."""
    if isinstance(jnp.asarray(scene.morton), jax.core.Tracer):
        assert builder in (None, "karras"), "builder='sah' needs concrete inputs"
        return _build_bvh_chunked_traced(scene, chunk_capacity)
    if builder is None:
        builder = "sah"
    n = scene.count
    num_chunks = max(-(-n // chunk_capacity), 1)
    sscene, bvhs = _partition_build(scene, num_chunks, builder)
    cap = sscene.shard_capacity
    chunk_bvhs = [_chunk_bvh(bvhs, s, cap) for s in range(num_chunks)]
    infos = [trace_gpu.node_mask(b) for b in chunk_bvhs]
    cap4 = max(max(c for _, _, c in infos), 1)
    tables = jnp.stack(
        [
            trace_gpu.pack_tables(
                _chunk_scene(sscene, s, cap), chunk_bvhs[s],
                cap4=cap4, mask=infos[s][0], new_id=infos[s][1],
            )
            for s in range(num_chunks)
        ]
    )
    return ChunkedBvh(sscene=sscene, bvhs=bvhs, tables=tables)


@functools.partial(jax.jit, static_argnames=("chunk_capacity",))
def _build_bvh_chunked_traced(
    scene: Scene, chunk_capacity: int = DEFAULT_CHUNK_CAPACITY
) -> ChunkedBvh:
    """Fully-traced fallback (build_bvh_chunked called inside a caller's jit):
    the per-chunk record count is not host-readable, so tables use the
    static worst-case bound (≤ (2n+1)/3 even-depth nodes; padding inert)."""
    n = scene.count
    num_chunks = max(-(-n // chunk_capacity), 1)
    sscene, bvhs = _partition_build(scene, num_chunks, "karras")
    cap = sscene.shard_capacity
    tables = jnp.stack(
        [
            trace_gpu.pack_tables(_chunk_scene(sscene, s, cap), _chunk_bvh(bvhs, s, cap))
            for s in range(num_chunks)
        ]
    )
    return ChunkedBvh(sscene=sscene, bvhs=bvhs, tables=tables)


def _chunk_scene(ss: dist.ShardedScene, s: int, cap: int) -> Scene:
    tris = Triangles(
        a=ss.tri_a[s], b=ss.tri_b[s], c=ss.tri_c[s],
        a_uv=ss.a_uv[s], b_uv=ss.b_uv[s], c_uv=ss.c_uv[s],
        a_normal=ss.a_normal[s], b_normal=ss.b_normal[s], c_normal=ss.c_normal[s],
        count=cap,
    )
    return Scene(
        triangles=tris,
        aabb_min=ss.aabb_min[s],
        aabb_max=ss.aabb_max[s],
        morton=ss.morton[s],
        tri_index=ss.global_tri[s],
        count=cap,
    )


def _chunk_bvh(bvhs: Bvh, s: int, cap: int) -> Bvh:
    return Bvh(
        left=bvhs.left[s], right=bvhs.right[s],
        left_is_leaf=bvhs.left_is_leaf[s], right_is_leaf=bvhs.right_is_leaf[s],
        internal_parent=bvhs.internal_parent[s], leaf_parent=bvhs.leaf_parent[s],
        range_first=bvhs.range_first[s], range_last=bvhs.range_last[s],
        split_axis=bvhs.split_axis[s],
        node_aabb_min=bvhs.node_aabb_min[s], node_aabb_max=bvhs.node_aabb_max[s],
        sorted_tri=bvhs.sorted_tri[s], depth=bvhs.depth[s],
        count=cap,
    )


@functools.partial(
    jax.jit, static_argnames=("impl", "route", "compact")
)
def trace_chunked(
    cbvh: ChunkedBvh,
    origins: jnp.ndarray,
    dirs: jnp.ndarray,
    impl: str = "auto",
    route: bool = True,
    anyhit_thresh: jnp.ndarray | None = None,
    compact: int | None | str = "auto",
) -> HitRecord:
    """Nearest hit over all chunks; ``tri`` is the ORIGINAL scene triangle id.

    Chunks are traced NEAR-FIRST (by distance from the mean ray origin to
    each chunk root AABB, a traced argsort — no recompile when the camera
    moves): the running-best ``t_init`` then prunes most of the far chunks'
    DFS at the root, which is what makes streaming S chunks cost much less
    than S full traversals.  Exactness is unaffected (a pruned candidate can
    never win the strict-< fold); only EXACT cross-chunk t-ties resolve to
    the nearer chunk instead of the lower Morton range — the same bounded
    tie class as the distributed combines (parallel/dist.py).

    ``route=True`` additionally reorders the RAYS once, stably, by each
    ray's nearest OVERLAPPED chunk (the shuffle engine's root-box routing,
    dist.render_hits_shuffle, applied single-chip): packets then align with
    chunk locality, so the union DFS of a packet stops straddling chunk
    boundaries where most of the work is, and rays overlapping nothing sort
    to the tail as all-dead packets.  One (R,S) slab test + one stable sort
    + two bulk gathers total (NOT per chunk); results are unpermuted at the
    end — bit-identical to ``route=False`` (same fold, same per-ray
    candidates, order of the fold unchanged).

    ``compact`` = the one schedule position after which LIVE rays are
    re-packed to the front (stable partition by "some remaining chunk's raw
    root-slab tmin is still < this ray's best t" — any winning hit in chunk
    c has t ≥ tmin_c, so the gate is exact; raw tmin, NOT clamped to 0,
    because the reference's Möller–Trumbore accepts negative t).  After the
    compaction the sparse survivors occupy few dense packets and every
    all-dead packet exits at the root step.  Overhead is two stable sorts +
    two grouped row gathers: rays + t_init gather in, the tail chunks fold
    into a FRESH best state seeded with the permuted t_init (so the head state is never
    permuted), and the tail state is unpermuted once and merged by
    strict-< at the end.  Hit t/u/v/tri match ``compact=None`` except that
    re-packeting changes packet composition, and with it the packet
    direction votes and union traversal order — EXACT-t ties across
    triangles may resolve differently (the same bounded tie class as the
    distributed combines; `t` itself is order-independent).

    ``"auto"`` resolves to OFF: tile-major camera rays are already
    live/dead coherent.  The knob stays for incoherent generic batches.
    """
    S, cap = cbvh.num_chunks, cbvh.capacity
    R = origins.shape[0]
    if compact == "auto":
        compact = None  # camera frames are already coherent (docstring)
    if compact is not None and not (0 <= compact < S - 1):
        # Explicit positions must be meaningful — a silent no-op would let
        # an A/B compare two identical programs under different labels.
        raise ValueError(
            f"compact={compact} is out of range for {S} chunks (valid: "
            f"0..{S - 2}, i.e. a position with chunks remaining after it); "
            f"use compact=None to disable"
        )
    # Distance from the representative origin to each chunk's root box
    # (camera rays share one origin; for mixed batches the mean is only a
    # scheduling heuristic — results are exact for any order).
    eye = jnp.mean(origins, axis=0)
    roots_min = cbvh.bvhs.node_aabb_min[:, 0]
    roots_max = cbvh.bvhs.node_aabb_max[:, 0]
    closest = jnp.clip(eye, roots_min, roots_max)
    perm = jnp.argsort(jnp.sum((closest - eye) ** 2, axis=1))

    gate = None
    if (route or compact is not None) and S > 1:
        # Root-slab distances per (ray, chunk); inf where no overlap.
        inv = 1.0 / dirs
        t1 = (roots_min[None, :, :] - origins[:, None, :]) * inv[:, None, :]
        t2 = (roots_max[None, :, :] - origins[:, None, :]) * inv[:, None, :]
        tmin = jnp.max(jnp.minimum(t1, t2), axis=2)
        tmax = jnp.min(jnp.maximum(t1, t2), axis=2)
        ov = (tmax > tmin) & (tmax > 0)
        gate = jnp.where(ov, tmin, jnp.inf)  # raw tmin: exact liveness bound

    ray_perm = None
    if route and S > 1:
        # Nearest-overlapped-chunk id per ray; rays overlapping no chunk get
        # id S and pack into all-dead packets.
        entry = jnp.where(ov, jnp.maximum(tmin, 0.0), jnp.inf)
        nearest = jnp.where(
            jnp.any(ov, axis=1), jnp.argmin(entry, axis=1), jnp.int32(S)
        )
        # Stable sort keeps the tile-major coherence within each group.
        _, ray_perm = jax.lax.sort_key_val(
            nearest, jnp.arange(R, dtype=jnp.int32), is_stable=True
        )
        odg = jnp.concatenate([origins, dirs], axis=1)
        if compact is not None:
            odg = jnp.concatenate([odg, gate], axis=1)
        odg = jnp.concatenate(
            [odg[:, c:c + 8][ray_perm] for c in range(0, odg.shape[1], 8)],
            axis=1,
        )
        origins, dirs = odg[:, 0:3], odg[:, 3:6]
        if compact is not None:
            gate = odg[:, 6:6 + S]
        if anyhit_thresh is not None:
            anyhit_thresh = anyhit_thresh[ray_perm]
    if compact is not None:
        # Gate columns in schedule order (position s's remaining chunks are
        # columns s+1..S).
        gate = jnp.take(gate, perm, axis=1)

    best_t = jnp.full((R,), C.MAX_FLOAT, jnp.float32)
    best_tri = jnp.zeros((R,), jnp.int32)   # LOCAL tri id within its chunk
    best_chunk = jnp.zeros((R,), jnp.int32)
    best_u = jnp.zeros((R,), jnp.float32)
    best_v = jnp.zeros((R,), jnp.float32)
    for s in range(S):  # static unroll: one kernel launch per chunk
        idx = perm[s]
        scene_s = _chunk_scene(cbvh.sscene, idx, cap)
        # Later chunks prune against the best found so far (exact: a hit at
        # or beyond best.t loses the strict-< fold anyway); tables come
        # pre-packed from build time.  The fold keeps the LOCAL tri id +
        # winning chunk and resolves the global id with ONE gather after
        # the loop.
        # anyhit: a collapsed t (0) from any chunk makes best_t = 0, and the
        # next chunk's t_init=0 prunes its whole DFS for that ray (occlusion
        # rays start outside the scene, so every slab entry is positive) —
        # cross-chunk early exit composes exactly like in-kernel collapse.
        h = trace_rays(
            scene_s, _chunk_bvh(cbvh.bvhs, idx, cap), origins, dirs,
            impl=impl, t_init=best_t, tables=cbvh.tables[idx],
            anyhit_thresh=anyhit_thresh,
        )
        win = h.t < best_t  # ties → earlier-traced (nearer) chunk
        best_t = jnp.where(win, h.t, best_t)
        best_tri = jnp.where(win, h.tri, best_tri)
        best_chunk = jnp.where(win, idx, best_chunk)
        best_u = jnp.where(win, h.u, best_u)
        best_v = jnp.where(win, h.v, best_v)
        if s == compact:
            # Stable partition: rays some remaining chunk can still improve
            # (raw tmin strictly below the running best — the only way to
            # win the strict-< fold) move to the front, dead rays to the
            # tail.  ONE 7-column gather moves rays + t_init; the tail
            # chunks fold into a FRESH best state (seeded with the permuted
            # running best, so pruning strength is unchanged) and merge
            # back by strict-< after the loop — the head state is never
            # permuted.
            live = jnp.any(gate[:, s + 1:] < best_t[:, None], axis=1)
            _, tail_perm = jax.lax.sort_key_val(
                (~live).astype(jnp.int32), jnp.arange(R, dtype=jnp.int32),
                is_stable=True,
            )
            odt = jnp.concatenate(
                [origins, dirs, best_t[:, None]], axis=1
            )[tail_perm]
            origins, dirs = odt[:, 0:3], odt[:, 3:6]
            if anyhit_thresh is not None:
                anyhit_thresh = anyhit_thresh[tail_perm]
            head = (best_t, best_tri, best_chunk, best_u, best_v)
            best_t = odt[:, 6]
            best_tri = jnp.zeros((R,), jnp.int32)
            best_chunk = jnp.zeros((R,), jnp.int32)
            best_u = jnp.zeros((R,), jnp.float32)
            best_v = jnp.zeros((R,), jnp.float32)

    if compact is not None:
        # Unpermute the tail fold (inverse via one sort — cheaper than a
        # scatter at this R) and merge: the tail can only win by strict <
        # of its seeded t_init, so equal-t keeps the head's hit.
        _, inv_p = jax.lax.sort_key_val(
            tail_perm, jnp.arange(R, dtype=jnp.int32), is_stable=True
        )
        tail = jnp.concatenate(
            [best_t[:, None], best_u[:, None], best_v[:, None],
             jax.lax.bitcast_convert_type(best_tri, jnp.float32)[:, None],
             jax.lax.bitcast_convert_type(best_chunk, jnp.float32)[:, None]],
            axis=1,
        )[inv_p]
        head_t, head_tri, head_chunk, head_u, head_v = head
        win = tail[:, 0] < head_t
        best_t = jnp.where(win, tail[:, 0], head_t)
        best_u = jnp.where(win, tail[:, 1], head_u)
        best_v = jnp.where(win, tail[:, 2], head_v)
        best_tri = jnp.where(
            win, jax.lax.bitcast_convert_type(tail[:, 3], jnp.int32), head_tri
        )
        best_chunk = jnp.where(
            win, jax.lax.bitcast_convert_type(tail[:, 4], jnp.int32), head_chunk
        )
    gtri = cbvh.sscene.global_tri[best_chunk, best_tri]
    # Miss ⇒ tri = 0 (the reference's quirk, kept by every engine).
    gtri = jnp.where(best_t < C.MAX_FLOAT, gtri, 0)
    if ray_perm is not None:
        # Unpermute: scatter-of-iota + ONE packed 4-column gather.
        inv_r = jnp.zeros((R,), jnp.int32).at[ray_perm].set(
            jnp.arange(R, dtype=jnp.int32), unique_indices=True
        )
        packed = jnp.stack(
            [best_t, jax.lax.bitcast_convert_type(gtri, jnp.float32),
             best_u, best_v],
            axis=1,
        )[inv_r]
        best_t, best_u, best_v = packed[:, 0], packed[:, 2], packed[:, 3]
        gtri = jax.lax.bitcast_convert_type(packed[:, 1], jnp.int32)
    return HitRecord(t=best_t, tri=gtri, u=best_u, v=best_v)


def render_hits_chunked(
    scene: Scene, cbvh: ChunkedBvh, cam, impl: str = "auto",
    route: bool = False,
    compact: int | None | str = "auto",
) -> HitRecord:
    """Primary-ray trace of a chunked scene in tile-major packet order
    (mirrors ops/dispatch.camera_trace — reshape/transpose reordering, no
    permutation gathers); ``scene`` is the original unchunked scene, used
    only for shape/shading downstream.

    ``route`` defaults OFF here (tile-major camera rays are already
    chunk-coherent) and ON in trace_chunked for generic batches."""
    from unitysimpleraytracing.core.camera import generate_rays
    from unitysimpleraytracing.ops.dispatch import _row_major, _tile_major

    origins, dirs = generate_rays(cam)
    h, w = cam.height, cam.width
    if h % 32 == 0 and w % 32 == 0:
        hits = trace_chunked(
            cbvh,
            _tile_major(origins, h, w, 32),
            _tile_major(dirs, h, w, 32),
            impl=impl,
            route=route,
            compact=compact,
        )
        return HitRecord(
            t=_row_major(hits.t, h, w, 32),
            tri=_row_major(hits.tri, h, w, 32),
            u=_row_major(hits.u, h, w, 32),
            v=_row_major(hits.v, h, w, 32),
        )
    return trace_chunked(
        cbvh, origins, dirs, impl=impl, route=route, compact=compact,
    )


def occluded_chunked(
    cbvh: ChunkedBvh, origins, dirs, impl: str = "auto", eps: float = 4e-3,
    origin_bound=None,
):
    """Chunked occlusion query (dispatch.occluded's semantics over a chunked
    scene): traced backward from outside the whole scene with the any-hit
    early exit per chunk; t_init threads the collapse across chunks.

    ``origin_bound`` optionally replaces the batch-derived ``max|origins|``
    term of the far scale with a caller bound — the frame-invariant form
    (render.py's _shadow_origin_bound) that makes batched multi-frame shadow
    passes bit-identical to per-frame calls by construction."""
    roots_min = cbvh.bvhs.node_aabb_min[:, 0]
    roots_max = cbvh.bvhs.node_aabb_max[:, 0]
    ext = jnp.maximum(
        jnp.max(jnp.abs(jnp.nan_to_num(roots_min, posinf=0.0, neginf=0.0))),
        jnp.max(jnp.abs(jnp.nan_to_num(roots_max, posinf=0.0, neginf=0.0))),
    )
    obound = (
        jnp.max(jnp.abs(origins)) if origin_bound is None else origin_bound
    )
    far = 4.0 * ext + obound + 1.0
    back_origins = origins + dirs * far
    thresh = jnp.broadcast_to(far - eps, (origins.shape[0],)).astype(jnp.float32)
    hits = trace_chunked(
        cbvh, back_origins, -dirs, impl=impl, anyhit_thresh=thresh
    )
    return hits.hit & (hits.t < far - eps)


def render_rgba_chunked(
    scene: Scene, cbvh: ChunkedBvh, cam, tex, impl: str = "auto",
    shadows: bool = False,
):
    """Traced layer of a chunked (beyond single-kernel capacity) scene —
    the render path for scenes split into chunks.
    Mirrors pipeline/render.render_rgba including the shadow pass's
    guaranteed-miss substitution for miss pixels."""
    from unitysimpleraytracing.core.camera import generate_rays
    from unitysimpleraytracing.ops import trace as trace_ops
    from unitysimpleraytracing.ops.dispatch import _row_major, _tile_major

    hits = render_hits_chunked(scene, cbvh, cam, impl=impl)
    shadow = None
    if shadows:
        o, d = generate_rays(cam)
        origins, dirs, origin_bound = _shadow_rays_chunked(cbvh, hits, o, d)
        h, w = cam.height, cam.width
        if h % 32 == 0 and w % 32 == 0:
            occ = occluded_chunked(
                cbvh, _tile_major(origins, h, w, 32),
                _tile_major(dirs, h, w, 32), impl=impl,
                origin_bound=origin_bound,
            )
            shadow = _row_major(occ, h, w, 32) & hits.hit
        else:
            shadow = occluded_chunked(
                cbvh, origins, dirs, impl=impl, origin_bound=origin_bound
            ) & hits.hit
    rgba = trace_ops.shade(scene, tex, hits, shadow=shadow)
    return rgba.reshape(cam.height, cam.width, 4)


def _shadow_rays_chunked(cbvh: ChunkedBvh, hits: HitRecord, o, d):
    """Shadow-ray construction over a chunked scene (render._shadow_mask's
    recipe): hit points from origin + t·dir, guaranteed-miss substitutes for
    miss pixels, and a FRAME-INVARIANT origin bound derived from the chunk
    roots alone — so batched multi-frame shadow passes are bit-identical to
    per-frame calls by construction (the ADVICE-r3 fix, applied here too)."""
    light = jnp.full((3,), 1.0 / jnp.sqrt(jnp.float32(3.0)), jnp.float32)
    root_max = jnp.max(
        jnp.nan_to_num(cbvh.bvhs.node_aabb_max[:, 0], posinf=0.0, neginf=0.0),
        axis=0,
    )
    roots_min = jnp.nan_to_num(
        cbvh.bvhs.node_aabb_min[:, 0], posinf=0.0, neginf=0.0
    )
    miss_o = root_max + jnp.maximum(jnp.max(jnp.abs(root_max)), 1.0)
    miss_d = jnp.asarray([1.0, 0.0, 0.0], jnp.float32)
    hitm = hits.hit[:, None]
    p = o + jnp.where(hitm, hits.t[:, None], 0.0) * d
    dirs = jnp.where(hitm, light[None, :], miss_d[None, :])
    origins = jnp.where(hitm, p + light[None, :] * 1e-3, miss_o[None, :])
    ext = jnp.maximum(jnp.max(jnp.abs(roots_min)), jnp.max(jnp.abs(root_max)))
    origin_bound = jnp.maximum(jnp.max(jnp.abs(miss_o)), ext + 1.0)
    return origins, dirs, origin_bound


def render_frame_chunked(
    scene: Scene, cbvh: ChunkedBvh, cam, tex, background,
    impl: str = "auto", shadows: bool = False,
):
    """Full composited frame over a chunked scene (render.render_frame's
    contract for scenes beyond the single-kernel capacity)."""
    from unitysimpleraytracing.ops import trace as trace_ops

    traced = render_rgba_chunked(scene, cbvh, cam, tex, impl=impl, shadows=shadows)
    bg = jnp.broadcast_to(
        jnp.asarray(background, jnp.float32), (cam.height, cam.width, 3)
    )
    return trace_ops.compose(bg, traced)


def render_frames_chunked(
    scene: Scene, cbvh: ChunkedBvh, cams, tex, background,
    impl: str = "auto", shadows: bool = False,
):
    """Batched animation render over a CHUNKED scene: (F, H, W, 4) frames
    from F stacked camera poses — render.render_frames' offline-throughput
    path extended past the single-kernel capacity.

    All F frames' tile-major rays concatenate into ONE chunk-streaming fold,
    so each chunk's table gather and launch fixed costs are paid once per
    ANIMATION instead of once per frame — exactly the cost the per-chunk
    schedule multiplies by S.  Matches F independent `render_frame_chunked`
    calls bit-for-bit (per-ray fold; the shadow far scale is
    frame-invariant by construction, see _shadow_rays_chunked) up to two
    bounded edges: the near-first chunk schedule comes from the BATCH mean
    origin (EXACT cross-chunk t-ties may resolve to a different chunk),
    and when H·W is not a packet multiple, frame boundaries split packets
    (exact-t tie class again)."""
    from unitysimpleraytracing.core.camera import generate_rays
    from unitysimpleraytracing.ops import trace as trace_ops
    from unitysimpleraytracing.ops.dispatch import _row_major, _tile_major

    f = int(jnp.asarray(cams.cam_to_world).shape[0])
    h, w = cams.height, cams.width
    assert h % 32 == 0 and w % 32 == 0, "batched frames need 32-divisible dims"
    o, d = jax.vmap(generate_rays)(cams)
    ot = jax.vmap(lambda x: _tile_major(x, h, w, 32))(o).reshape(f * h * w, 3)
    dt = jax.vmap(lambda x: _tile_major(x, h, w, 32))(d).reshape(f * h * w, 3)
    hits = trace_chunked(cbvh, ot, dt, impl=impl, route=False)

    shadow = None
    if shadows:
        origins, dirs, origin_bound = _shadow_rays_chunked(cbvh, hits, ot, dt)
        shadow = occluded_chunked(
            cbvh, origins, dirs, impl=impl, origin_bound=origin_bound
        ) & hits.hit

    def unbatch(x):
        x = x.reshape(f, h * w)
        return jax.vmap(lambda r: _row_major(r, h, w, 32))(x).reshape(f * h * w)

    hits = HitRecord(
        t=unbatch(hits.t), tri=unbatch(hits.tri),
        u=unbatch(hits.u), v=unbatch(hits.v),
    )
    if shadow is not None:
        shadow = unbatch(shadow)
    rgba = trace_ops.shade(scene, tex, hits, shadow=shadow).reshape(f, h, w, 4)
    bg = jnp.broadcast_to(jnp.asarray(background, jnp.float32), (h, w, 3))
    return jax.vmap(lambda fr: trace_ops.compose(bg, fr))(rgba)
