"""Key/value sort — the framework's L2 parallel primitive.

The reference implements a 4-pass, 8-bit-digit LSD radix sort as three HLSL
kernels driven from C# (``Assets/_Scripts/ComputeBufferSorter.cs:100-126``,
``Assets/_Shaders/Sorting/*.compute``), built on Nvidia wave intrinsics.
Here the engines are plain XLA behind one API:

- ``impl="xla"``: ``jax.lax.sort_key_val`` — XLA's native variadic sort,
  stable for ANY values (this module's generic default).
- ``impl="lex2"``: two-key lexicographic NON-stable ``lax.sort`` — for
  distinct values the value tiebreak reproduces the stable permutation
  exactly without ``is_stable``; the build pipeline's default (its values
  are distinct iota indices, satisfying the tiebreak precondition).
- ``impl="packed"``: ONE ``lax.sort`` of a single uint64 ``key<<32 | value``
  array (stable for distinct values by construction; needs the x64 context).
- ``impl="radix"``: an LSD radix sort with the same pass structure as the
  reference (per-block digit histograms in a transposed layout, exclusive scan
  over the flattened histogram, rank = global bucket base + intra-block rank),
  expressed as vectorized one-hot/cumsum math.  The final data movement is a
  gather by inverse rank rather than a scatter — the gather formulation of
  GlobalRadixSort.compute:35-39.  It is the per-pass validators' reference
  (utils/validate.py).

For distinct values all four return the stable permutation, which is
bit-compatible with the reference sort's output (the output permutation of
a stable LSD radix sort is unique).  Which engine is fastest on the GPU is
not measured yet.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from unitysimpleraytracing import constants as C


def sort_key_val(
    keys: jnp.ndarray, values: jnp.ndarray, impl: str = "xla"
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Ascending sort of uint32 ``keys`` with ``values`` carried along.

    ``xla`` and ``radix`` are stable for any values; ``lex2`` and
    ``packed`` return the stable permutation only when equal keys carry
    distinct values (the build's iota values always do)."""
    if impl == "xla":
        return jax.lax.sort_key_val(keys, values, is_stable=True)
    if impl == "packed":
        return packed_sort_key_val(keys, values)
    if impl == "lex2":
        return lex2_sort_key_val(keys, values)
    if impl == "radix":
        return radix_sort_key_val(keys, values)
    raise ValueError(f"unknown sort impl {impl!r}")


def packed_sort_key_val(
    keys: jnp.ndarray, values: jnp.ndarray
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Single-word sort: pack (key, value) into ONE uint64 ``key<<32 | value``
    and sort that one array (VERDICT r4 item 3).

    Stability is by construction: values in the build pipeline are distinct
    iota indices, so ascending-word order IS ascending-key order with ties
    broken by original position — exactly the stable pair sort's permutation
    (the reference sorts one (key, value) stream the same way,
    ComputeBufferSorter.cs:100-126).  The hypothesis under test: halving
    ``lax.sort``'s operand count halves its per-stage data movement.  For
    general (possibly duplicated) values the result still matches the stable
    pair sort whenever equal keys carry distinct values.

    Requires the x64 context; whether it beats the variadic pair sort is
    measured by benchmarks/sort_bench.py.
    """
    vdtype = values.dtype
    with jax.enable_x64():
        w = (keys.astype(jnp.uint64) << jnp.uint64(32)) | values.astype(
            jnp.uint32
        ).astype(jnp.uint64)
        w = jax.lax.sort(w, is_stable=False)
        k = (w >> jnp.uint64(32)).astype(jnp.uint32)
        v = w.astype(jnp.uint32)
    return k, v.view(jnp.int32).astype(vdtype) if vdtype != jnp.uint32 else v


def lex2_sort_key_val(
    keys: jnp.ndarray, values: jnp.ndarray
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Two-key lexicographic NON-stable sort: ``lax.sort((keys, values),
    num_keys=2)``.  For distinct values this returns exactly the stable pair
    sort's permutation (the value is the tiebreak), while dropping
    ``is_stable``'s extra machinery — the same trick as ``packed`` without
    the uint64/x64 dependency."""
    k, v = jax.lax.sort((keys, values), num_keys=2, is_stable=False)
    return k, v


def _digit(keys: jnp.ndarray, shift: int) -> jnp.ndarray:
    return ((keys >> jnp.uint32(shift)) & jnp.uint32(C.NUM_BUCKETS - 1)).astype(
        jnp.int32
    )


def _rank_pass(keys: jnp.ndarray, shift: int, block: int):
    """Global stable rank of every element for one digit pass.

    Mirrors the reference's decomposition (SURVEY §3.3): per-block bucket
    histograms written transposed (LocalRadixSort.compute:132:
    ``sizes[group + radix*BLOCK_SIZE]``) so a flat exclusive scan yields
    bucket-major global bases, plus the intra-block rank that the reference
    obtains from its wave-scan local sort (LocalRadixSort.compute:64-91).
    """
    n = keys.shape[0]
    assert n % block == 0, f"n={n} must be a multiple of block={block}"
    nblocks = n // block
    d = _digit(keys, shift).reshape(nblocks, block)

    # One-hot digit occupancy per block: (nblocks, block, NUM_BUCKETS).
    onehot = (d[:, :, None] == jnp.arange(C.NUM_BUCKETS)[None, None, :]).astype(
        jnp.int32
    )
    # Intra-block running count of each bucket → intra-block rank.
    run = jnp.cumsum(onehot, axis=1)
    local_rank = jnp.take_along_axis(run, d[:, :, None], axis=2)[:, :, 0] - 1

    # Per-block histogram, transposed to (NUM_BUCKETS, nblocks) — the same
    # layout trick as the reference — then flat exclusive scan for bases.
    hist = run[:, -1, :]  # (nblocks, NUM_BUCKETS)
    hist_t = hist.T.reshape(-1)
    bases = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), jnp.cumsum(hist_t)[:-1]]
    ).reshape(C.NUM_BUCKETS, nblocks)

    block_ids = jnp.arange(nblocks, dtype=jnp.int32)[:, None]
    base = bases[d, block_ids]  # (nblocks, block) gather
    # hist_t / bases returned for the per-pass validators (the reference
    # checks its sizesData + scan recurrence in situ per digit pass,
    # ComputeBufferSorter.cs:226-271).
    return (base + local_rank).reshape(n), hist_t, bases.reshape(-1)


@functools.partial(jax.jit, static_argnames=("block",))
def radix_sort_key_val(
    keys: jnp.ndarray, values: jnp.ndarray, block: int = C.SORT_BLOCK
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """4-pass LSD radix sort (stable) of uint32 keys + carried values."""
    n = keys.shape[0]
    block = min(block, n)
    idx = jnp.arange(n, dtype=jnp.int32)
    for p in range(C.NUM_PASSES):
        rank, _, _ = _rank_pass(keys, p * C.RADIX_BITS, block)
        # rank is a permutation: dst[i] = rank[i]. Realize the pass with a
        # gather by the inverse permutation (scatter-free):
        # inv[rank[i]] = i via one scatter-of-iota, then take.
        inv = jnp.zeros(n, jnp.int32).at[rank].set(idx, mode="drop")
        keys = jnp.take(keys, inv, axis=0)
        values = jnp.take(values, inv, axis=0)
    return keys, values


@functools.partial(jax.jit, static_argnames=("shift", "block"))
def radix_pass_debug(
    keys: jnp.ndarray, values: jnp.ndarray, shift: int,
    block: int = C.SORT_BLOCK,
):
    """ONE digit pass of the radix engine with its intermediates exposed:
    ``(keys_out, values_out, hist_t, scanned)`` where ``hist_t`` is the
    bucket-major flattened per-block histogram (the reference's transposed
    ``sizesData``, LocalRadixSort.compute:132) and ``scanned`` its exclusive
    scan (the ``scannedSizes`` the reference validates per pass,
    ComputeBufferSorter.cs:256-271).  Consumed by
    utils/validate.validate_sort_pass."""
    n = keys.shape[0]
    block = min(block, n)
    rank, hist_t, scanned = _rank_pass(keys, shift, block)
    inv = jnp.zeros(n, jnp.int32).at[rank].set(
        jnp.arange(n, dtype=jnp.int32), mode="drop"
    )
    return (
        jnp.take(keys, inv, axis=0), jnp.take(values, inv, axis=0),
        hist_t, scanned,
    )


def argsort_by_key(keys: jnp.ndarray, impl: str = "xla") -> jnp.ndarray:
    """Stable permutation that sorts ``keys`` ascending."""
    idx = jnp.arange(keys.shape[0], dtype=jnp.int32)
    _, perm = sort_key_val(keys, idx, impl=impl)
    return perm
