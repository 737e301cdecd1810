"""End-to-end BVH build: sort → uniquify → topology → refit.

The reference performs this once in ``Awake`` as a sequence of host-driven
GPU dispatches with CPU round-trips between stages
(``RaytracingMeshDrawer.cs:30-55``, SURVEY §3.1).  Here the whole build is a
single jitted device program: XLA fuses the stages and nothing returns to the
host.  The sort carries the triangle indices exactly like the reference's
(key, value) pair sort; ``distribute_keys`` then replaces the reference's
GPU→CPU→GPU uniquification round-trip (MeshBufferContainer.cs:154-169).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from unitysimpleraytracing import constants as C
from unitysimpleraytracing.core.types import Bvh, Scene
from unitysimpleraytracing.ops import lbvh, sah, sort, unique


@functools.partial(jax.jit, static_argnames=("sort_impl", "diagnostics", "builder"))
def _build_bvh_jit(
    scene: Scene,
    sort_impl: str = "lex2",
    diagnostics: bool = False,
    builder: str = "karras",
) -> Bvh:
    keys, sorted_tri = sort.sort_key_val(
        scene.morton, scene.tri_index, impl=sort_impl
    )
    if builder == "sah":
        # Sweep SAH over the Morton order (ops/sah.py): better splits, same
        # hit contract; needs no unique keys, so distribute_keys is skipped.
        return sah.build_bvh_sah_from_sorted(
            sorted_tri, scene.aabb_min, scene.aabb_max, scene.count,
            diagnostics=diagnostics,
        )
    if builder == "sah_free":
        # Free-order sweep SAH (ops/sah.py): additionally re-partitions the
        # leaves per node (one lexicographic sort per level); the emitted
        # permutation replaces the Morton order as sorted_tri.
        return sah.build_bvh_sah_free(
            sorted_tri, scene.aabb_min, scene.aabb_max, scene.count,
            diagnostics=diagnostics,
        )
    assert builder == "karras", builder
    keys = unique.distribute_keys(keys, scene.count)
    return lbvh.build_bvh_from_sorted(
        keys, sorted_tri, scene.aabb_min, scene.aabb_max, scene.count,
        diagnostics=diagnostics,
    )


def build_bvh(
    scene: Scene,
    sort_impl: str = "lex2",
    diagnostics: bool = False,
    validate: bool = False,
    builder: str | None = None,
) -> Bvh:
    """Construct the BVH for a scene. Requires scene.count >= 2.

    ``sort_impl`` defaults to "lex2" (two-key lexicographic non-stable
    sort): the build's sort values are distinct iota indices, so the value
    tiebreak reproduces the stable pair sort's permutation exactly without
    ``is_stable`` (ops/sort.py).

    ``builder``: "karras" (the reference's radix tree, BVH.compute:94-149,
    bit-parity surface), "sah" (sweep SAH over the Morton order, ops/sah.py
    — lower SAH cost, same hit contract), or "sah_free" (free-order sweep
    SAH — re-partitions leaves per node, lowest SAH cost).  The default
    (``None``): concrete builds resolve to "sah_free" (a static scene is
    traced many times, so the one-time build buys every frame), traced
    builds (inside a caller's jit — per-frame rebuild loops, where build
    SPEED is the metric) resolve to "karras".  build_bvh_chunked keeps
    "sah", whose chunk build is faster cold.

    ``diagnostics`` adds the parent links + per-node depth array
    (validation only; nothing in the render path reads them).

    ``validate=True`` runs the promoted runtime validators in situ on the
    user's actual scene — the reference validates every sort pass inside the
    real pipeline the same way (ComputeBufferSorter.cs:107-125, readback +
    permutation/order checks; MeshBufferContainer.cs:181-195 corruption
    scan).  Host-side readbacks: debug-grade cost, raises AssertionError on
    the first violated invariant.  Requires concrete (non-traced) inputs.
    """
    if isinstance(scene.count, int) and scene.count < 2:
        raise ValueError("LBVH needs at least 2 triangles (reference assumes the same)")
    if builder is None:
        traced = isinstance(jnp.asarray(scene.morton), jax.core.Tracer)
        builder = "karras" if traced else "sah_free"
    if not validate:
        return _build_bvh_jit(scene, sort_impl, diagnostics, builder)

    from unitysimpleraytracing.utils import validate as V

    if isinstance(jnp.asarray(scene.morton), jax.core.Tracer):
        raise ValueError("validate=True needs concrete inputs (outside jit)")
    count = int(scene.count)
    bvh = _build_bvh_jit(scene, sort_impl, diagnostics=True, builder=builder)
    # Sort pass (re-run standalone so pre/post states are observable — the
    # fused build never materializes them).
    keys_sorted, tri_sorted = sort.sort_key_val(
        scene.morton, scene.tri_index, impl=sort_impl
    )
    V.check_sorted(keys_sorted, count)
    V.check_permutation(scene.morton, keys_sorted, count)
    V.check_stability(scene.morton, scene.tri_index, keys_sorted, tri_sorted, count)
    # DistributeKeys postcondition (BVH.compute:29's precondition).
    V.check_unique_strictly_increasing(
        unique.distribute_keys(keys_sorted, count), count
    )
    # Per-digit-pass validation of the radix decomposition — the reference
    # validates after EVERY pass inside the running pipeline
    # (ComputeBufferSorter.cs:107-125): scan recurrence, per-block histogram
    # recount, digit-histogram permutation, stable-digit contract.  The
    # production engines are fused lax.sorts with no pass observables; the
    # radix decomposition is validated on the scene's actual keys.
    V.validate_sort_per_pass(scene.morton, scene.tri_index, impl="radix")
    # Tree topology + refit coverage (the "CORRUPTED" scans).
    V.check_topology(bvh)
    V.check_depths(bvh)
    V.check_refit(bvh, scene.aabb_min, scene.aabb_max)
    # The validated build carries the diagnostic links either way (a
    # superset of the diagnostics=False result; nothing downstream reads
    # them) — no second build.
    return bvh


@jax.jit
def deform_scene(scene: Scene, positions) -> Scene:
    """Replace vertex positions (T, 3, 3), keeping topology-related fields.

    For per-frame vertex animation: per-triangle AABBs are recomputed (the
    refit inputs), while Morton codes and the sorted order are intentionally
    left stale — `refit_bvh` stays correct under any deformation (every node
    box still bounds its subtree), the tree merely loses quality as geometry
    drifts from its original Morton order; re-run `build_bvh` to re-optimize.
    """
    a, b, c = positions[:, 0], positions[:, 1], positions[:, 2]
    amin = jnp.minimum(jnp.minimum(a, b), c) - C.AABB_INFLATION
    amax = jnp.maximum(jnp.maximum(a, b), c) + C.AABB_INFLATION
    tris = scene.triangles.replace(a=a, b=b, c=c)
    return scene.replace(triangles=tris, aabb_min=amin, aabb_max=amax)


def refit_bvh(scene: Scene, bvh: Bvh) -> Bvh:
    """Refit node AABBs to the scene's current triangle AABBs, keeping the
    tree topology (the fast path for deforming meshes — the reference has no
    equivalent: it rebuilds everything each Awake).

    O(log n) unrolled vector passes (sparse-table range min/max over the
    node leaf ranges); exact: output equals a fresh refit of the same
    topology over the new leaf boxes.

    Deliberately NOT jitted at this level (the inner ``lbvh.refit`` is): the
    ``replace`` below then keeps the topology arrays' object identity, which
    the BVH4 table packer's per-topology cache keys on — a refit-per-frame
    render loop skips the depth chase when repacking (trace_gpu).
    Inside a caller's jit everything still fuses.
    """
    node_min, node_max = lbvh.refit(
        bvh.range_first,
        bvh.range_last,
        bvh.sorted_tri,
        scene.aabb_min,
        scene.aabb_max,
        bvh.count,
    )
    return bvh.replace(node_aabb_min=node_min, node_aabb_max=node_max)
