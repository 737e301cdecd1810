"""Pipeline validators, promoted from the reference's inline runtime checks.

The reference has no test framework; instead it re-derives expected results on
the CPU after every GPU pass (SURVEY §4.1): sortedness + duplicate census
(``ComputeBufferSorter.cs:150-177``), per-digit histogram permutation checks
(:193-224), per-block histogram equality (:226-254), prefix-sum recurrence
(:256-271), and null-sentinel corruption scans
(``MeshBufferContainer.cs:181-195``).  Here those mechanisms are first-class
library functions the test suite (and users) call on demand.

All functions take numpy-compatible arrays and raise AssertionError with a
diagnostic on failure.
"""
from __future__ import annotations

import numpy as np

from unitysimpleraytracing import constants as C
from unitysimpleraytracing.core.types import Bvh


def check_sorted(keys, count: int) -> None:
    """Ascending order over the logical prefix (ComputeBufferSorter.cs:150-162)."""
    k = np.asarray(keys)[:count]
    bad = np.nonzero(k[1:] < k[:-1])[0]
    assert bad.size == 0, f"sort order violated at indices {bad[:10]}"


def check_permutation(keys_in, keys_out, count: int) -> None:
    """Output is a permutation of input: full multiset equality (stronger than
    the reference's 256-bucket histogram diff, ComputeBufferSorter.cs:193-224)."""
    a = np.sort(np.asarray(keys_in)[:count])
    b = np.sort(np.asarray(keys_out)[:count])
    assert np.array_equal(a, b), "sort output is not a permutation of its input"


def check_stability(keys_in, values_in, keys_out, values_out, count: int) -> None:
    """Stable ties: equal keys keep their original value order."""
    ki = np.asarray(keys_in)[:count]
    vi = np.asarray(values_in)[:count]
    ko = np.asarray(keys_out)[:count]
    vo = np.asarray(values_out)[:count]
    order = np.argsort(ki, kind="stable")
    assert np.array_equal(ko, ki[order]), "keys mismatch vs stable oracle"
    assert np.array_equal(vo, vi[order]), "values violate stability"


def check_scan_recurrence(raw, scanned) -> None:
    """Exclusive-scan recurrence scanned[i] == raw[i-1] + scanned[i-1]
    (ComputeBufferSorter.cs:256-271)."""
    raw = np.asarray(raw, dtype=np.int64)
    s = np.asarray(scanned, dtype=np.int64)
    assert s[0] == 0, f"scan[0] = {s[0]} != 0"
    expect = np.cumsum(raw)[:-1]
    bad = np.nonzero(s[1:] != expect)[0]
    assert bad.size == 0, f"scan recurrence violated at {bad[:10] + 1}"


def check_digit_histogram(keys_in, keys_out, shift: int) -> None:
    """Per-pass permutation check via 256-bucket histogram diff of the pass's
    digit — exactly the reference's in-situ check
    (ComputeBufferSorter.cs:193-224)."""
    din = (np.asarray(keys_in).astype(np.uint64) >> np.uint64(shift)) & np.uint64(
        C.NUM_BUCKETS - 1
    )
    dout = (np.asarray(keys_out).astype(np.uint64) >> np.uint64(shift)) & np.uint64(
        C.NUM_BUCKETS - 1
    )
    hin = np.bincount(din.astype(np.int64), minlength=C.NUM_BUCKETS)
    hout = np.bincount(dout.astype(np.int64), minlength=C.NUM_BUCKETS)
    bad = np.nonzero(hin != hout)[0]
    assert bad.size == 0, (
        f"digit-pass histogram diff at buckets {bad[:10]} (shift {shift})"
    )


def check_block_histograms(keys_in, hist_t, shift: int, block: int) -> None:
    """The engine's own per-block histogram (the transposed ``sizesData``
    layout, LocalRadixSort.compute:132) equals a host recount — the
    reference's per-block check (ComputeBufferSorter.cs:226-254)."""
    k = np.asarray(keys_in).astype(np.uint64)
    n = k.shape[0]
    assert n % block == 0
    nblocks = n // block
    d = ((k >> np.uint64(shift)) & np.uint64(C.NUM_BUCKETS - 1)).astype(np.int64)
    want = np.zeros((nblocks, C.NUM_BUCKETS), np.int64)
    for b in range(nblocks):
        want[b] = np.bincount(d[b * block:(b + 1) * block], minlength=C.NUM_BUCKETS)
    got = np.asarray(hist_t, dtype=np.int64).reshape(C.NUM_BUCKETS, nblocks).T
    assert np.array_equal(got, want), "per-block histogram mismatch vs host recount"


def check_pass_stable(keys_in, values_in, keys_out, values_out, shift: int) -> None:
    """One digit pass's full contract: output = stable sort of input by this
    pass's digit alone (the invariant every LSD pass must preserve)."""
    ki = np.asarray(keys_in)
    d = (ki.astype(np.uint64) >> np.uint64(shift)) & np.uint64(C.NUM_BUCKETS - 1)
    order = np.argsort(d, kind="stable")
    assert np.array_equal(np.asarray(keys_out), ki[order]), (
        f"pass (shift {shift}) keys != stable digit sort"
    )
    assert np.array_equal(np.asarray(values_out), np.asarray(values_in)[order]), (
        f"pass (shift {shift}) values violate stability"
    )


def validate_sort_pass(
    keys_in, values_in, keys_out, values_out, hist_t, scanned,
    shift: int, block: int,
) -> None:
    """All of the reference's per-digit-pass in-situ checks on one pass's
    observables (ComputeBufferSorter.cs:107-125 runs these after every GPU
    pass): scan recurrence, per-block histogram recount, digit histogram
    permutation, and the stable-digit-sort contract."""
    check_scan_recurrence(hist_t, scanned)
    check_block_histograms(keys_in, hist_t, shift, block)
    check_digit_histogram(keys_in, keys_out, shift)
    check_pass_stable(keys_in, values_in, keys_out, values_out, shift)


def validate_sort_per_pass(keys, values, impl: str = "radix") -> None:
    """Drive every digit pass of the decomposed sort engines standalone and
    validate each pass's intermediates — the per-pass parity of the
    reference's ``Sort()`` loop (ComputeBufferSorter.cs:102-125).

    ``impl``: "radix" (the XLA-expressed pass decomposition).  The production
    ``impl="xla"`` engine is a fused ``lax.sort`` with no per-pass
    observables — its end-to-end output is checked by check_sorted/
    check_permutation/check_stability instead."""
    import jax.numpy as jnp

    from unitysimpleraytracing.ops import sort as sort_ops

    keys = jnp.asarray(keys)
    values = jnp.asarray(values)
    n = keys.shape[0]
    assert impl == "radix", impl
    block = min(C.SORT_BLOCK, n)
    pass_fn = sort_ops.radix_pass_debug
    # Pad to a block multiple with tail-sorting max keys (the reference's
    # padding convention, MeshBufferContainer.cs:108-109) — capacity-padded
    # scene arrays are not generally block multiples.
    pad = -n % block
    if pad:
        keys = jnp.concatenate(
            [keys, jnp.full((pad,), C.KEY_PADDING, keys.dtype)]
        )
        values = jnp.concatenate([values, jnp.zeros((pad,), values.dtype)])
    for p in range(C.NUM_PASSES):
        shift = p * C.RADIX_BITS
        keys_out, values_out, hist_t, scanned = pass_fn(keys, values, shift)
        validate_sort_pass(
            keys, values, keys_out, values_out, hist_t, scanned, shift, block
        )
        keys, values = keys_out, values_out
    check_sorted(keys, keys.shape[0])


def check_unique_strictly_increasing(keys, count: int) -> None:
    """distribute_keys postcondition (BVH.compute:29's precondition)."""
    k = np.asarray(keys)[:count].astype(np.int64)
    assert k[0] == 0, f"first key {k[0]} != 0"
    d = np.diff(k)
    bad = np.nonzero(d < 1)[0]
    assert bad.size == 0, f"keys not strictly increasing at {bad[:10]}"


def check_topology(bvh: Bvh) -> None:
    """Structural invariants of the Karras tree.

    - every node (except root) has exactly one parent, matching child links
    - the n leaves and n-1 internal nodes are each referenced exactly once
    - no null-sentinel links among valid nodes (the reference's "CORRUPTED"
      scan, MeshBufferContainer.cs:181-195)
    """
    n = bvh.count
    left = np.asarray(bvh.left)[: n - 1]
    right = np.asarray(bvh.right)[: n - 1]
    lleaf = np.asarray(bvh.left_is_leaf)[: n - 1]
    rleaf = np.asarray(bvh.right_is_leaf)[: n - 1]
    iparent = np.asarray(bvh.internal_parent)[: n - 1]
    lparent = np.asarray(bvh.leaf_parent)[:n]

    assert np.all(left >= 0) and np.all(right >= 0), "null child link"
    assert np.all(lparent >= 0), "leaf with no parent (LEAF CORRUPTED)"
    if n > 1:
        assert iparent[0] == C.NULL_INDEX, "root must have sentinel parent"
        assert np.all(iparent[1:] >= 0), "internal node with no parent"

    leaf_refs = np.zeros(n, np.int64)
    internal_refs = np.zeros(n - 1, np.int64)
    for child, is_leaf in ((left, lleaf), (right, rleaf)):
        np.add.at(leaf_refs, child[is_leaf], 1)
        np.add.at(internal_refs, child[~is_leaf], 1)
    assert np.all(leaf_refs == 1), f"leaf reference counts wrong: {np.nonzero(leaf_refs != 1)[0][:10]}"
    expected = np.ones(n - 1, np.int64)
    expected[0] = 0  # root is nobody's child
    assert np.array_equal(internal_refs, expected), "internal reference counts wrong"

    # Parent links agree with child links.
    for i in range(n - 1):
        if lleaf[i]:
            assert lparent[left[i]] == i, f"leaf {left[i]} parent mismatch"
        else:
            assert iparent[left[i]] == i, f"internal {left[i]} parent mismatch"
        if rleaf[i]:
            assert lparent[right[i]] == i, f"leaf {right[i]} parent mismatch"
        else:
            assert iparent[right[i]] == i, f"internal {right[i]} parent mismatch"


def check_refit(bvh: Bvh, tri_aabb_min, tri_aabb_max) -> None:
    """Every internal AABB equals the exact merge of its children — the
    recursive recomputation the reference's atomic refit promises
    (BVH.compute:191-215). Verified bottom-up on the host, bit-exact."""
    n = bvh.count
    left = np.asarray(bvh.left)[: n - 1]
    right = np.asarray(bvh.right)[: n - 1]
    lleaf = np.asarray(bvh.left_is_leaf)[: n - 1]
    rleaf = np.asarray(bvh.right_is_leaf)[: n - 1]
    # Level order derived from parent links on the host (independent of the
    # optional bvh.depth diagnostic array; parents may have HIGHER ids than
    # children in a Karras tree, so chase each chain).
    iparent = np.asarray(bvh.internal_parent)[: n - 1]
    depth = np.zeros(n - 1, np.int64)
    for i in range(n - 1):
        p, d = iparent[i], 0
        while p >= 0:
            p, d = iparent[p], d + 1
        depth[i] = d
    sorted_tri = np.asarray(bvh.sorted_tri)
    node_min = np.asarray(bvh.node_aabb_min)[: n - 1]
    node_max = np.asarray(bvh.node_aabb_max)[: n - 1]
    tmin = np.asarray(tri_aabb_min)
    tmax = np.asarray(tri_aabb_max)

    exp_min = np.zeros_like(node_min)
    exp_max = np.zeros_like(node_max)
    for level in range(int(depth.max()), -1, -1):
        for i in np.nonzero(depth == level)[0]:
            if lleaf[i]:
                lmin, lmax_ = tmin[sorted_tri[left[i]]], tmax[sorted_tri[left[i]]]
            else:
                lmin, lmax_ = exp_min[left[i]], exp_max[left[i]]
            if rleaf[i]:
                rmin, rmax_ = tmin[sorted_tri[right[i]]], tmax[sorted_tri[right[i]]]
            else:
                rmin, rmax_ = exp_min[right[i]], exp_max[right[i]]
            exp_min[i] = np.minimum(lmin, rmin)
            exp_max[i] = np.maximum(lmax_, rmax_)
    assert np.array_equal(node_min, exp_min), "refit min mismatch"
    assert np.array_equal(node_max, exp_max), "refit max mismatch"


def check_depths(bvh: Bvh) -> None:
    """Depth array consistency: root 0, child = parent + 1."""
    n = bvh.count
    depth = np.asarray(bvh.depth)[: n - 1]
    iparent = np.asarray(bvh.internal_parent)[: n - 1]
    assert depth[0] == 0
    for i in range(1, n - 1):
        assert depth[i] == depth[iparent[i]] + 1, f"depth broken at {i}"
