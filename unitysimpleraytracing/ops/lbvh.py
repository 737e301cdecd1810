"""Karras LBVH construction: topology + deterministic atomics-free AABB refit.

Topology produces EXACTLY the Karras 2012 binary radix tree of
``Assets/_Shaders/BVH/BVH.compute`` (``delta`` :23-33, ``DetermineRange``
:35-52, ``FindSplit`` :54-92, child/parent linking :111-148), but not by
transcribing its per-node binary searches: every search probe would be an
XLA gather, and the reference's exponential + binary + split searches cost
~95 sequential gather rounds.  Instead the searches are REFORMULATED over the adjacent-delta array
``adj[k] = delta(k, k+1)``, using two facts that hold for the sorted distinct
keys ``distribute_keys`` guarantees:

1. ``delta(x, y) = min(adj[x..y-1])`` (common prefix over a sorted range is
   the min of adjacent common prefixes), and adjacent deltas are never equal
   (two consecutive equal deltas would need the middle key to carry both a 0
   and a 1 at the same bit), so ``d = sign(delta(i,i+1) - delta(i,i-1))`` is
   always ±1 and:
   - d=+1: ``last  = min{k >= i  : adj[k] <= adj[i-1]}`` (sentinel n-1),
   - d=-1: ``first = max{k <  i  : adj[k] <= adj[i]} + 1`` (sentinel -1+1=0)
   — next/prev-smaller-or-equal queries.  ``adj`` values live in [-1, 31]
   (clz of a 31-bit nonzero xor; -1 = out-of-range sentinel,
   BVH.compute:29-32), so ALL 33 thresholds are answered at once by one
   reverse cummin / forward cummax over a (33, cap) masked-iota table —
   cumulative scans, zero gathers — and a per-node one-hot select.
2. ``FindSplit``'s result is the LEFTMOST ARGMIN of ``adj`` over
   [first, last-1]: its binary search keeps the highest split with
   ``delta(first, split) > delta(first, last)``, i.e. every adj strictly
   before the split exceeds the range minimum — the split lands on the
   first position attaining it.  One sparse-table range-min query over
   keys ``(adj+1) << 25 | index`` (min = smallest adj, then smallest
   index) answers every node with 2 gathers — the only gathers left.

Because children are always ``split`` and ``split+1``, the child arrays need
no scatter; only parent links do (4 masked scatters).

The reference's bottom-up refit uses a per-node ``InterlockedCompareExchange``
gate — one thread per leaf races up the parent chain and the second arrival
merges (BVH.compute:172-220).  Here the refit is atomics-free and
deterministic, redesigned around a structural fact of the Karras tree: internal node i covers the CONTIGUOUS sorted-leaf range
``[first_i, last_i]`` (DetermineRange, BVH.compute:35-52), so its AABB is
exactly the elementwise min/max of the leaf AABBs over that range — identical,
bit for bit, to the recursive merge of children (min/max are associative,
commutative and exact in f32).  The refit therefore builds a sparse table
(power-of-2 windowed min/max, ``log2(cap)`` unrolled shift-and-min passes —
no gathers, no ``while_loop``) and answers every node with two overlapping
window lookups — O(log n) cheap vector passes replacing the level-ordered
sweep's ≤32 full-capacity gather passes, with the same contract: every
internal AABB is the merge of its children; leaf AABBs resolve through the
sorted-triangle indirection (BVH.compute:203,212).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from unitysimpleraytracing.core.types import Bvh


def _clz_xor(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Common-prefix length of two uint32 codes (BVH.compute:18-21 clz32)."""
    return jax.lax.clz(a ^ b).astype(jnp.int32)


_ADJ_VALS = tuple(range(-1, 32))  # every value delta(k, k+1) can take


@functools.partial(jax.jit, static_argnames=("with_parents",))
def build_topology(codes: jnp.ndarray, count, with_parents: bool = True):
    """All internal-node ranges/splits at once (scan/RMQ Karras — see module
    docstring for the gather-free derivation; output is bit-identical to the
    reference searches, tested against the scalar transcription).

    Returns (left, right, left_is_leaf, right_is_leaf, internal_parent,
    leaf_parent, range_first, range_last, split_axis), each shaped
    (capacity,), int32/bool; invalid rows (i >= count-1) carry sentinel -1
    links.
    ``range_first/last`` is node i's covered sorted-leaf interval
    (DetermineRange's [first, last], BVH.compute:35-52) — the refit consumes
    it as a range-min/max query span.
    """
    cap = codes.shape[0]
    n = jnp.asarray(count, jnp.int32)
    ids = jnp.arange(cap, dtype=jnp.int32)

    # adj[k] = delta(k, k+1), with the reference's out-of-range sentinel -1
    # (BVH.compute:29-32) at every k >= n-1 — which also fences the range
    # walks at the array ends exactly like the reference's validity test.
    nxt_codes = jnp.concatenate([codes[1:], codes[-1:]])
    adj = jnp.where(ids <= n - 2, _clz_xor(codes, nxt_codes), -1)
    adj_prev = jnp.concatenate([jnp.full((1,), -1, jnp.int32), adj[:-1]])

    # d = sign(delta(i,i+1) - delta(i,i-1)); never 0 for distinct keys.
    d_pos = adj > adj_prev
    dmin = jnp.where(d_pos, adj_prev, adj)

    # next/prev-smaller-or-equal for all 33 thresholds at once, with the
    # boundary's adj VALUE riding in the low 6 bits of the packed word
    # (position-major: (pos << 6) | (adj+2), adj+2 ∈ [1, 33]), so threshold
    # queries answer both "where is the boundary" and "what delta is there"
    # with zero gathers:
    #   nxt[v, i] packs min{k >= i : adj[k] <= v}   (sentinel INT_MAX)
    #   prv[v, i] packs max{k <  i : adj[k] <= v}   (sentinel -1)
    vals = jnp.asarray(_ADJ_VALS, jnp.int32)[:, None]          # (33, 1)
    leq = adj[None, :] <= vals                                  # (33, cap)
    iota = jnp.broadcast_to(ids[None, :], leq.shape)
    packed_pv = (iota << 6) | (adj[None, :] + 2)
    nxt = jax.lax.cummin(
        jnp.where(leq, packed_pv, jnp.int32(2**31 - 1)), axis=1, reverse=True
    )
    prv_inc = jax.lax.cummax(jnp.where(leq, packed_pv, jnp.int32(-1)), axis=1)
    prv = jnp.concatenate(
        [jnp.full((len(_ADJ_VALS), 1), -1, jnp.int32), prv_inc[:, :-1]], axis=1
    )

    # One-hot select each node's threshold row (dmin ∈ [-1, 31]); positions
    # are the packed words' high bits (sentinels -1 and INT_MAX shift to -1
    # and a large positive — same clamping as before).
    sel = dmin[None, :] == vals                                 # (33, cap)
    last_sel = jnp.sum(jnp.where(sel, nxt, 0), axis=0) >> 6
    first_sel = (jnp.sum(jnp.where(sel, prv, 0), axis=0) >> 6) + 1
    first = jnp.where(d_pos, ids, first_sel)
    last = jnp.where(d_pos, last_sel, ids)

    # Split per node WITHOUT the sparse-table RMQ (its table build + two
    # full-capacity element gathers dominated 1M topology): invert the
    # node→split map.  Every adj position k is the leftmost argmin of
    # exactly one node's range [f_k, l_k] (the Karras ranges are the
    # Cartesian-tree ranges of adj), and both the range and the NAME of
    # that node follow from two more threshold selects on the same tables:
    #   f_k = prv[adj[k]][k] + 1          (ties on the left excluded —
    #                                      leftmost-argmin convention)
    #   l_k = pos of nxt[adj[k]-1][k+1]   (strictly-smaller boundary; ties
    #                                      on the right are inside)
    #   name = f_k iff the LEFT boundary delta exceeds the right one (the
    #   parent's split sits at the larger boundary delta; out-of-range
    #   boundaries are -inf, the root special-cases to 0), else l_k.
    # One masked scatter of ((adj+1) << 25 | k) then lands every node's
    # split + split-delta in the same packed form the RMQ produced.
    a = adj
    sel_a = a[None, :] == vals
    pk_prv = jnp.sum(jnp.where(sel_a, prv, 0), axis=0)
    f_pos = (pk_prv >> 6) + 1
    f_val = (pk_prv & 63) - 2                                   # adj at f_k-1
    sel_lt = (a - 1)[None, :] == vals
    nxt_excl = jnp.concatenate(
        [nxt[:, 1:], jnp.full((len(_ADJ_VALS), 1), 2**31 - 1, jnp.int32)],
        axis=1,
    )
    pk_nxt = jnp.sum(jnp.where(sel_lt, nxt_excl, 0), axis=0)
    l_pos = jnp.minimum(pk_nxt >> 6, n - 1)
    NEG = jnp.int32(-100)
    adj_left = jnp.where(f_pos > 0, f_val, NEG)
    adj_right = jnp.where(l_pos < n - 1, (pk_nxt & 63) - 2, NEG)
    name = jnp.where(adj_left > adj_right, f_pos, l_pos)
    name = jnp.where((f_pos == 0) & (l_pos == n - 1), 0, name)
    valid_k = ids <= n - 2
    scat = jnp.zeros((cap,), jnp.int32).at[
        jnp.where(valid_k, name, cap)
    ].set(((a + 1) << 25) | ids, mode="drop")
    rmq = scat
    split = rmq & ((1 << 25) - 1)

    # Traversal ordering hint, free from the RMQ result: the split separates
    # codes at bit (31 - adj[split]); with the x-major interleave
    # ``xx*4 + yy*2 + zz`` (core/morton.py) bit b belongs to axis
    # 2 - b % 3 ∈ {0:x, 1:y, 2:z}.  The left child covers the LOWER half
    # along that axis, so "near child" = left iff the ray direction's
    # component on that axis is positive.  Heuristic only (distribute_keys
    # perturbs low bits): affects traversal order, never the hit set.
    adj_split = (rmq >> 25) - 1
    bit_pos = jnp.maximum(31 - adj_split, 0)
    split_axis = 2 - (bit_pos % 3)

    valid = ids < n - 1
    left = jnp.where(valid, split, -1)
    right = jnp.where(valid, split + 1, -1)
    left_is_leaf = valid & (split == first)
    right_is_leaf = valid & (split + 1 == last)

    # Parent links via masked scatters (drop out-of-range → masked rows
    # inert).  Diagnostic-only: nothing in the render path reads parents, so
    # the 4 scatters are skippable.
    if with_parents:
        internal_parent, leaf_parent = parent_links(
            left, right, left_is_leaf, right_is_leaf, valid
        )
    else:
        internal_parent = jnp.full(cap, -1, jnp.int32)
        leaf_parent = jnp.full(cap, -1, jnp.int32)

    range_first = jnp.where(valid, first, -1)
    range_last = jnp.where(valid, last, -1)
    split_axis = jnp.where(valid, split_axis, 0)
    return (
        left, right, left_is_leaf, right_is_leaf,
        internal_parent, leaf_parent, range_first, range_last, split_axis,
    )


def parent_links(left, right, left_is_leaf, right_is_leaf, valid):
    """Parent arrays from child links via 4 masked scatters (drop mode →
    out-of-range rows inert).  Works for ANY contiguous-range binary tree
    (Karras or the sweep-SAH builder, ops/sah.py); diagnostic-only data."""
    cap = left.shape[0]
    ids = jnp.arange(cap, dtype=jnp.int32)
    drop = jnp.int32(cap)
    internal_parent = jnp.full(cap, -1, jnp.int32)
    leaf_parent = jnp.full(cap, -1, jnp.int32)
    li = jnp.where(valid & ~left_is_leaf, left, drop)
    ri = jnp.where(valid & ~right_is_leaf, right, drop)
    internal_parent = internal_parent.at[li].set(ids, mode="drop")
    internal_parent = internal_parent.at[ri].set(ids, mode="drop")
    ll = jnp.where(valid & left_is_leaf, left, drop)
    rl = jnp.where(valid & right_is_leaf, right, drop)
    leaf_parent = leaf_parent.at[ll].set(ids, mode="drop")
    leaf_parent = leaf_parent.at[rl].set(ids, mode="drop")
    return internal_parent, leaf_parent


@jax.jit
def compute_depths(internal_parent: jnp.ndarray, count) -> jnp.ndarray:
    """Depth of every internal node from the root (node 0) by POINTER DOUBLING.

    Invariant: when ``jump[i] == -1``, ``dist[i] == depth(i)``; when
    ``jump[i] == j >= 0``, ``dist[i] == depth(i) - depth(j)``.  Each pass
    composes every chain with itself (``jump' = jump[jump]``), so the chase
    converges in ceil(log2(max_depth)) + 1 ≈ 6 passes of two gathers — versus
    the naive parent-chase's ≤33 single-gather passes (tree depth for 32-bit
    distinct keys post-distribute_keys is ≤ 33).  This depth array is
    diagnostic/validation data only; the refit no longer consumes it.
    """
    cap = internal_parent.shape[0]
    ids = jnp.arange(cap, dtype=jnp.int32)
    valid = ids < count - 1
    jump = jnp.where(valid, internal_parent, -1)
    dist = (jump >= 0).astype(jnp.int32)

    def cond(carry):
        jump, _ = carry
        return jnp.any(jump >= 0)

    def body(carry):
        jump, dist = carry
        alive = jump >= 0
        j = jnp.clip(jump, 0, cap - 1)
        dist = jnp.where(alive, dist + dist[j], dist)
        jump = jnp.where(alive, jump[j], -1)
        return jump, dist

    _, dist = jax.lax.while_loop(cond, body, (jump, dist))
    return jnp.where(valid, dist, -1)


@jax.jit
def refit(
    range_first,
    range_last,
    sorted_tri,
    tri_aabb_min,
    tri_aabb_max,
    count,
):
    """Range-query AABB refit (deterministic replacement for
    BVH.compute:172-220).

    Node i's AABB == elementwise min/max of the sorted-leaf AABBs over its
    contiguous covered range [first_i, last_i] — bit-identical to the
    recursive merge of children (min/max are exact, associative, idempotent),
    with leaf boxes resolved via ``tri_aabb[sorted_tri[leaf]]`` exactly like
    BVH.compute:203,212.  A sparse table of power-of-2 windowed min/max is
    built in log2(cap) UNROLLED shift+min passes (pure vector code — no
    gathers, no while_loop), then every node reads two overlapping windows:
    ``[first, first+2^k) ∪ [last-2^k+1, last+1)`` with k = floor(log2(len)).
    """
    cap = range_first.shape[0]
    ids = jnp.arange(cap, dtype=jnp.int32)
    valid = ids < count - 1

    # Sorted-leaf AABB sequence, min NEGATED so both halves combine with a
    # single elementwise max — one 6-wide gather per lookup instead of two
    # 3-wide ones (the gathers dominate refit at 1M tris).
    s = jnp.concatenate([-tri_aabb_min, tri_aabb_max], axis=1)[sorted_tri]

    levels = max(int(cap).bit_length(), 1)  # window sizes 2^0 .. 2^(levels-1)
    tabs = [s]
    w = 1
    for _ in range(levels - 1):
        p = tabs[-1]
        # Rows past cap-w read -inf pads; valid queries never touch them
        # (their window always fits inside [0, count)).
        tabs.append(
            jnp.maximum(p, jnp.concatenate([p[w:], jnp.full((w, 6), -jnp.inf)]))
        )
        w *= 2
    table = jnp.concatenate(tabs)  # (levels*cap, 6)

    first = jnp.clip(range_first, 0, cap - 1)
    last = jnp.clip(range_last, 0, cap - 1)
    length = jnp.maximum(last - first + 1, 1)
    k = 31 - jax.lax.clz(length)  # floor(log2(length))
    second = last + 1 - (jnp.int32(1) << k)
    merged = jnp.maximum(table[k * cap + first], table[k * cap + second])
    node_min = jnp.where(valid[:, None], -merged[:, 0:3], 0.0)
    node_max = jnp.where(valid[:, None], merged[:, 3:6], 0.0)
    return node_min, node_max


def build_bvh_from_sorted(
    codes: jnp.ndarray,
    sorted_tri: jnp.ndarray,
    tri_aabb_min: jnp.ndarray,
    tri_aabb_max: jnp.ndarray,
    count,
    static_count: int | None = None,
    diagnostics: bool = False,
) -> Bvh:
    """Full LBVH from uniquified sorted codes (the reference's
    ConstructTree + ConstructBVH sequence, BVHConstructor.cs:61-69).

    ``count`` may be traced (ragged shards); pytree containers need static
    metadata, so ``static_count`` (a plain int, e.g. the capacity) must be
    supplied in that case and is what lands in ``Bvh.count``.

    ``diagnostics=False`` (default) skips the parent-link scatters and the
    per-node depth array — validation-only data nothing in the render path
    reads; -1 filled.  Pass True — or use
    :func:`attach_diagnostics` later — where validation wants them."""
    if static_count is None:
        if not isinstance(count, int):
            raise TypeError("traced count requires an explicit static_count")
        static_count = count
    (
        left,
        right,
        left_is_leaf,
        right_is_leaf,
        internal_parent,
        leaf_parent,
        range_first,
        range_last,
        split_axis,
    ) = build_topology(codes, count, with_parents=diagnostics)
    if diagnostics:
        depth = compute_depths(internal_parent, count)
    else:
        depth = jnp.full(codes.shape[0], -1, jnp.int32)
    node_min, node_max = refit(
        range_first,
        range_last,
        sorted_tri,
        tri_aabb_min,
        tri_aabb_max,
        count,
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


def attach_diagnostics(bvh: Bvh) -> Bvh:
    """Fill the diagnostic parent links + depth array of a Bvh built without
    them (recomputed from the child links; identical to a diagnostics=True
    build)."""
    cap = bvh.left.shape[0]
    ids = jnp.arange(cap, dtype=jnp.int32)
    valid = ids < bvh.count - 1
    drop = jnp.int32(cap)
    internal_parent = jnp.full(cap, -1, jnp.int32)
    leaf_parent = jnp.full(cap, -1, jnp.int32)
    li = jnp.where(valid & ~bvh.left_is_leaf, bvh.left, drop)
    ri = jnp.where(valid & ~bvh.right_is_leaf, bvh.right, drop)
    internal_parent = internal_parent.at[li].set(ids, mode="drop")
    internal_parent = internal_parent.at[ri].set(ids, mode="drop")
    ll = jnp.where(bvh.left_is_leaf, bvh.left, drop)
    rl = jnp.where(bvh.right_is_leaf, bvh.right, drop)
    leaf_parent = leaf_parent.at[ll].set(ids, mode="drop")
    leaf_parent = leaf_parent.at[rl].set(ids, mode="drop")
    return bvh.replace(
        internal_parent=internal_parent,
        leaf_parent=leaf_parent,
        depth=compute_depths(internal_parent, bvh.count),
    )
