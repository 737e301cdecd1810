"""Sweep-SAH topology over the Morton-sorted leaf order — the opt-in
high-quality builder (``build_bvh(..., builder="sah")``).

The reference builds only the Karras radix tree (BVH.compute:94-149), whose
splits are Morton bit boundaries.  Its hit CONTRACT, though, is independent of
topology: the traversal keeps the strict-< nearest intersection, so ANY
binary tree over the same leaves returns the same hit (exact-t ties are the
same bounded class the distributed combines already accept).  This builder
keeps the reference's capability and output while choosing better splits:
full sweep SAH (not binned) restricted to the Morton-sorted order — measured
1.2-1.4x lower SAH cost than the Karras tree on the bench scenes, i.e. that
many fewer expected box tests per ray.

Why it drops into the existing machinery unchanged
---------------------------------------------------
Every node of a top-down split tree over the sorted leaf sequence covers a
CONTIGUOUS range, so the range-query refit (ops/lbvh.refit) applies verbatim.
And any such tree can be numbered the Karras way — children at (split,
split+1) — by naming each left child after its range's LAST index and each
right child after its range's FIRST index: the two names can never collide
(two internal nodes [f,x] and [x,l] would share leaf x with neither
containing the other), and the n-1 names are exactly {0..n-2}.  The Bvh
pytree, the refit, the BVH4 record packer and all traversal kernels therefore
consume the SAH tree with zero changes.

Vectorized formulation
----------------------
Top-down recursion is reshaped LEVEL-SYNCHRONOUSLY: one ``lax.while_loop``
iteration splits EVERY current segment at once, with per-leaf-position state
(my segment's [first, last] and node id) and zero gathers or scatters in the
loop — everything is segmented scans (``lax.associative_scan`` with head
flags) plus elementwise selects:

- prefix/suffix segment boxes → per-position left/right SAH costs;
- a segmented lexicographic argmin (cost, position) forward + backward gives
  every element its segment's best split;
- the element whose index EQUALS its segment's node id writes that node's
  (first, last, split) — elementwise, because the node id is always one of
  the segment's own endpoints.

Split-axis ordering hint: the argmin scan carries the (right-child centroid −
left-child centroid) payload; the emitted axis is its argmax component —
same role as the Karras split axis (near-child ordering in the kernels,
never correctness).  Segments still unsplit at ``max_sah_depth`` fall back to
median splits, bounding the loop at ~max_sah_depth + log2(n) iterations
(every split strictly shrinks both sides, so termination is structural).

Works with traced (ragged-shard) counts and under vmap, like
lbvh.build_topology; unique keys are NOT required (no delta()), so
distribute_keys is unnecessary on this path.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from unitysimpleraytracing.core.types import Bvh
from unitysimpleraytracing.ops import lbvh


def _half_area(p):
    """Half surface area from a (cap, 6) running box (-min, max)."""
    e = p[:, 3:] + p[:, :3]
    return e[:, 0] * e[:, 1] + e[:, 1] * e[:, 2] + e[:, 2] * e[:, 0]


def _seg_cummax(v, heads, reverse=False):
    """Segmented running max of (cap, k) ``v``; ``heads`` marks segment heads
    in scan direction (segment starts forward, segment ends reversed)."""

    def comb(a, b):
        fa, va = a
        fb, vb = b
        return fa | fb, jnp.where(fb[..., None], vb, jnp.maximum(va, vb))

    _, out = jax.lax.associative_scan(comb, (heads, v), reverse=reverse)
    return out


def _seg_argmin(cost, idx, payload, heads, reverse=False):
    """Segmented running (leftmost) argmin of ``cost`` with an attached
    (cap, k) payload selected alongside the winner."""

    def comb(a, b):
        fa, ca, ia, pa = a
        fb, cb, ib, pb = b
        tb = fb | (cb < ca) | ((cb == ca) & (ib < ia))
        return (
            fa | fb,
            jnp.where(tb, cb, ca),
            jnp.where(tb, ib, ia),
            jnp.where(tb[..., None], pb, pa),
        )

    _, c, i, p = jax.lax.associative_scan(
        comb, (heads, cost, idx, payload), reverse=reverse
    )
    return c, i, p


@functools.partial(jax.jit, static_argnames=("with_parents", "max_sah_depth"))
def build_topology_sah(
    sorted_tri,
    tri_aabb_min,
    tri_aabb_max,
    count,
    with_parents: bool = True,
    max_sah_depth: int = 40,
):
    """All internal nodes of the sweep-SAH tree over the sorted leaf order.

    Same output tuple as lbvh.build_topology: (left, right, left_is_leaf,
    right_is_leaf, internal_parent, leaf_parent, range_first, range_last,
    split_axis), each (capacity,), sentinel -1 on invalid rows.
    """
    cap = sorted_tri.shape[0]
    n = jnp.asarray(count, jnp.int32)
    ids = jnp.arange(cap, dtype=jnp.int32)
    in_scene = ids < n

    # Sorted-leaf boxes as (-min, max) so both scan directions use max.
    s6 = jnp.concatenate([-tri_aabb_min, tri_aabb_max], axis=1)[sorted_tri]
    INF = jnp.float32(jnp.inf)
    neg1 = jnp.full((cap,), -1, jnp.int32)

    state = (
        jnp.int32(0),                                   # level
        jnp.where(in_scene, 0, ids),                    # seg_first
        jnp.where(in_scene, n - 1, ids),                # seg_last
        jnp.where(in_scene, 0, -1),                     # node_id
        in_scene & (n >= 2),                            # active
        neg1, neg1, neg1, jnp.zeros((cap,), jnp.int32), # out f/l/split/axis
    )

    def cond(st):
        return jnp.any(st[4])

    def body(st):
        level, f, l, nid, act, o_f, o_l, o_s, o_ax = st
        starts = ids == f
        ends = ids == l

        P = _seg_cummax(s6, starts)                   # box over [first, i]
        S = _seg_cummax(s6, ends, reverse=True)       # box over [i, last]
        S1 = jnp.concatenate([S[1:], S[-1:]], axis=0)  # box over [i+1, last]

        cnt_l = (ids - f + 1).astype(jnp.float32)
        cnt_r = (l - ids).astype(jnp.float32)
        can = act & (ids < l)
        cost = jnp.where(can, _half_area(P) * cnt_l + _half_area(S1) * cnt_r, INF)

        # Payload: right-child centroid − left-child centroid at this split
        # candidate (split-axis hint for near-child ordering).
        diff = 0.5 * (S1[:, 3:] - S1[:, :3]) - 0.5 * (P[:, 3:] - P[:, :3])

        cF, iF, pF = _seg_argmin(cost, ids, diff, starts)
        cB, iB, pB = _seg_argmin(cost, ids, diff, ends, reverse=True)
        tb = (cB < cF) | ((cB == cF) & (iB < iF))
        best = jnp.where(tb, iB, iF)
        bp = jnp.where(tb[:, None], pB, pF)

        deep = level >= max_sah_depth  # median fallback bounds the loop
        best = jnp.where(deep, (f + l) >> 1, best)
        best = jnp.clip(best, f, jnp.maximum(l - 1, f))
        axis = jnp.where(deep, 0, jnp.argmax(bp, axis=1).astype(jnp.int32))

        # The segment's node id is one of its own endpoints, so the element
        # AT that index writes the node — no scatter.
        emit = act & (ids == nid)
        o_f = jnp.where(emit, f, o_f)
        o_l = jnp.where(emit, l, o_l)
        o_s = jnp.where(emit, best, o_s)
        o_ax = jnp.where(emit, axis, o_ax)

        # Children: [f, best] named best (left), [best+1, l] named best+1.
        in_left = ids <= best
        l2 = jnp.where(act & in_left, best, l)
        f2 = jnp.where(act & ~in_left, best + 1, f)
        nid2 = jnp.where(act, jnp.where(in_left, best, best + 1), nid)
        return (level + 1, f2, l2, nid2, act & (f2 < l2), o_f, o_l, o_s, o_ax)

    _, _, _, _, _, o_f, o_l, o_s, o_ax = jax.lax.while_loop(cond, body, state)

    valid = o_s >= 0  # exactly ids < n-1: the names cover {0..n-2}
    left = jnp.where(valid, o_s, -1)
    right = jnp.where(valid, o_s + 1, -1)
    left_is_leaf = valid & (o_s == o_f)
    right_is_leaf = valid & (o_s + 1 == o_l)
    if with_parents:
        internal_parent, leaf_parent = lbvh.parent_links(
            left, right, left_is_leaf, right_is_leaf, valid
        )
    else:
        internal_parent = jnp.full(cap, -1, jnp.int32)
        leaf_parent = jnp.full(cap, -1, jnp.int32)
    split_axis = jnp.where(valid, o_ax, 0)
    return (
        left, right, left_is_leaf, right_is_leaf,
        internal_parent, leaf_parent, o_f, o_l, split_axis,
    )


def _ordered_uint(x: jnp.ndarray) -> jnp.ndarray:
    """Monotone f32 → uint32 transform (total order matching float <):
    flip all bits of negatives, set the sign bit of non-negatives."""
    u = jax.lax.bitcast_convert_type(x, jnp.uint32)
    neg = (u >> jnp.uint32(31)) == 1
    return jnp.where(neg, ~u, u | jnp.uint32(0x80000000))


@functools.partial(jax.jit, static_argnames=("with_parents", "max_sah_depth"))
def build_topology_sah_free(
    init_order,
    tri_aabb_min,
    tri_aabb_max,
    count,
    with_parents: bool = True,
    max_sah_depth: int = 40,
):
    """FREE-ORDER sweep SAH: the builder REORDERS leaves instead of inheriting
    the Morton order (VERDICT r4 item 2).

    ``build_topology_sah`` above can only choose split POSITIONS in the fixed
    Morton-sorted sequence; this builder additionally chooses each node's
    partition: per level every active segment picks its largest-extent
    centroid axis, re-sorts its own leaves along that axis, then runs the
    same full per-position SAH sweep.  That is the classic object-median-free
    top-down sweep SAH (the quality tier above both the Karras radix tree,
    BVH.compute:94-149, and the restricted sweep) — the last records/ray
    lever the fetch-floor analysis left open.

    Mechanics: the per-segment re-sort is ONE global stable
    lexicographic ``lax.sort`` on (segment_first, centroid_key) per level —
    segments are contiguous with globally ordered, per-segment-constant
    ``first``, so the sort permutes leaves only WITHIN segments and the whole
    layout stays contiguous.  Only the leaf permutation rides the sort as a
    value; all per-position segment state (first/last/node id/outputs) is
    constant within each segment and stays put.  Emitted node boundaries are
    never crossed by later sorts (children re-sort strictly inside their own
    half), so the recorded (first, last, split) ranges all refer to the FINAL
    permutation — which is returned and becomes ``Bvh.sorted_tri``; the
    range-query refit, the BVH4 packer and every traversal kernel consume a
    contiguous-range tree over ANY leaf order unchanged (module docstring).

    Returns the build_topology output tuple + the final leaf permutation.
    """
    cap = init_order.shape[0]
    n = jnp.asarray(count, jnp.int32)
    ids = jnp.arange(cap, dtype=jnp.int32)
    in_scene = ids < n

    # Global-order leaf data, gathered per level through the current perm.
    s6_g = jnp.concatenate([-tri_aabb_min, tri_aabb_max], axis=1)  # (cap, 6)
    cent_g = 0.5 * (tri_aabb_min + tri_aabb_max)                   # (cap, 3)
    ckey_g = _ordered_uint(cent_g)                                 # (cap, 3)
    c6_g = jnp.concatenate([-cent_g, cent_g], axis=1)              # (cap, 6)
    INF = jnp.float32(jnp.inf)
    neg1 = jnp.full((cap,), -1, jnp.int32)

    state = (
        jnp.int32(0),                                   # level
        jnp.where(in_scene, 0, ids),                    # seg_first
        jnp.where(in_scene, n - 1, ids),                # seg_last
        jnp.where(in_scene, 0, -1),                     # node_id
        in_scene & (n >= 2),                            # active
        jnp.asarray(init_order, jnp.int32),             # perm
        neg1, neg1, neg1, jnp.zeros((cap,), jnp.int32), # out f/l/split/axis
    )

    def cond(st):
        return jnp.any(st[4])

    def body(st):
        level, f, l, nid, act, perm, o_f, o_l, o_s, o_ax = st
        starts = ids == f
        ends = ids == l

        # Segment centroid bounds (same value at every position of a segment:
        # max(prefix [f..i], suffix [i..l]) = the full-range reduction) →
        # largest-extent axis per segment.
        C = jnp.maximum(
            _seg_cummax(c6_g[perm], starts),
            _seg_cummax(c6_g[perm], ends, reverse=True),
        )
        ext = C[:, 3:] + C[:, :3]
        axis = jnp.argmax(ext, axis=1).astype(jnp.int32)

        # Re-sort every segment's leaves along its axis: stable lexicographic
        # (segment_first, centroid_key) sort; perm is the only moving payload.
        ckey = jnp.take_along_axis(ckey_g[perm], axis[:, None], axis=1)[:, 0]
        _, _, perm = jax.lax.sort((f, ckey, perm), num_keys=2, is_stable=True)

        s = s6_g[perm]
        P = _seg_cummax(s, starts)                    # box over [first, i]
        S = _seg_cummax(s, ends, reverse=True)        # box over [i, last]
        S1 = jnp.concatenate([S[1:], S[-1:]], axis=0)  # box over [i+1, last]

        cnt_l = (ids - f + 1).astype(jnp.float32)
        cnt_r = (l - ids).astype(jnp.float32)
        can = act & (ids < l)
        cost = jnp.where(can, _half_area(P) * cnt_l + _half_area(S1) * cnt_r, INF)

        dummy = jnp.zeros((cap, 1), jnp.float32)
        cF, iF, _ = _seg_argmin(cost, ids, dummy, starts)
        cB, iB, _ = _seg_argmin(cost, ids, dummy, ends, reverse=True)
        tb = (cB < cF) | ((cB == cF) & (iB < iF))
        best = jnp.where(tb, iB, iF)

        deep = level >= max_sah_depth  # median fallback bounds the loop
        best = jnp.where(deep, (f + l) >> 1, best)
        best = jnp.clip(best, f, jnp.maximum(l - 1, f))

        # The segment's node id is one of its own endpoints, so the element
        # AT that index writes the node — no scatter.  The axis hint is the
        # actual partition axis (children truly separate along it).
        emit = act & (ids == nid)
        o_f = jnp.where(emit, f, o_f)
        o_l = jnp.where(emit, l, o_l)
        o_s = jnp.where(emit, best, o_s)
        o_ax = jnp.where(emit, axis, o_ax)

        # Children: [f, best] named best (left), [best+1, l] named best+1.
        in_left = ids <= best
        l2 = jnp.where(act & in_left, best, l)
        f2 = jnp.where(act & ~in_left, best + 1, f)
        nid2 = jnp.where(act, jnp.where(in_left, best, best + 1), nid)
        return (level + 1, f2, l2, nid2, act & (f2 < l2), perm,
                o_f, o_l, o_s, o_ax)

    _, _, _, _, _, perm, o_f, o_l, o_s, o_ax = jax.lax.while_loop(
        cond, body, state
    )

    valid = o_s >= 0
    left = jnp.where(valid, o_s, -1)
    right = jnp.where(valid, o_s + 1, -1)
    left_is_leaf = valid & (o_s == o_f)
    right_is_leaf = valid & (o_s + 1 == o_l)
    if with_parents:
        internal_parent, leaf_parent = lbvh.parent_links(
            left, right, left_is_leaf, right_is_leaf, valid
        )
    else:
        internal_parent = jnp.full(cap, -1, jnp.int32)
        leaf_parent = jnp.full(cap, -1, jnp.int32)
    split_axis = jnp.where(valid, o_ax, 0)
    return (
        left, right, left_is_leaf, right_is_leaf,
        internal_parent, leaf_parent, o_f, o_l, split_axis,
    ), perm


def build_bvh_sah_free(
    init_order,
    tri_aabb_min,
    tri_aabb_max,
    count,
    static_count: int | None = None,
    diagnostics: bool = False,
    max_sah_depth: int = 40,
) -> Bvh:
    """Free-order sweep-SAH Bvh (``builder="sah_free"``): REORDERS the leaves
    and emits the permutation as ``sorted_tri``.  ``init_order`` seeds the
    permutation (any valid triangle-index order; the Morton-sorted order from
    the build pipeline is fine — the top levels re-sort it immediately)."""
    if static_count is None:
        if not isinstance(count, int):
            raise TypeError("traced count requires an explicit static_count")
        static_count = count
    (
        left, right, left_is_leaf, right_is_leaf,
        internal_parent, leaf_parent, range_first, range_last, split_axis,
    ), sorted_tri = build_topology_sah_free(
        init_order, tri_aabb_min, tri_aabb_max, count,
        with_parents=diagnostics, max_sah_depth=max_sah_depth,
    )
    if diagnostics:
        depth = lbvh.compute_depths(internal_parent, count)
    else:
        depth = jnp.full(init_order.shape[0], -1, jnp.int32)
    node_min, node_max = lbvh.refit(
        range_first, range_last, sorted_tri, tri_aabb_min, tri_aabb_max, count
    )
    return Bvh(
        left=left,
        right=right,
        left_is_leaf=left_is_leaf,
        right_is_leaf=right_is_leaf,
        internal_parent=internal_parent,
        leaf_parent=leaf_parent,
        range_first=range_first,
        range_last=range_last,
        split_axis=split_axis,
        node_aabb_min=node_min,
        node_aabb_max=node_max,
        sorted_tri=sorted_tri,
        depth=depth,
        count=static_count,
    )


def build_bvh_sah_from_sorted(
    sorted_tri,
    tri_aabb_min,
    tri_aabb_max,
    count,
    static_count: int | None = None,
    diagnostics: bool = False,
    max_sah_depth: int = 40,
) -> Bvh:
    """Sweep-SAH Bvh from a Morton-sorted triangle order (the ``builder="sah"``
    analog of lbvh.build_bvh_from_sorted; no unique keys needed)."""
    if static_count is None:
        if not isinstance(count, int):
            raise TypeError("traced count requires an explicit static_count")
        static_count = count
    (
        left, right, left_is_leaf, right_is_leaf,
        internal_parent, leaf_parent, range_first, range_last, split_axis,
    ) = build_topology_sah(
        sorted_tri, tri_aabb_min, tri_aabb_max, count,
        with_parents=diagnostics, max_sah_depth=max_sah_depth,
    )
    if diagnostics:
        depth = lbvh.compute_depths(internal_parent, count)
    else:
        depth = jnp.full(sorted_tri.shape[0], -1, jnp.int32)
    node_min, node_max = lbvh.refit(
        range_first, range_last, sorted_tri, tri_aabb_min, tri_aabb_max, count
    )
    return Bvh(
        left=left,
        right=right,
        left_is_leaf=left_is_leaf,
        right_is_leaf=right_is_leaf,
        internal_parent=internal_parent,
        leaf_parent=leaf_parent,
        range_first=range_first,
        range_last=range_last,
        split_axis=split_axis,
        node_aabb_min=node_min,
        node_aabb_max=node_max,
        sorted_tri=sorted_tri,
        depth=depth,
        count=static_count,
    )
