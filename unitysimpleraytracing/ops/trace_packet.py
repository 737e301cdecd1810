"""Packet BVH traversal in plain XLA.

The per-ray-stack traversal (`trace.traverse`, mirroring the reference's one
thread per pixel, Raytracing.compute:129-176) needs six vector gathers per
loop step (node AABB + links indexed by every ray's current node).  This
module replaces them with *packet
traversal*: rays are grouped into spatially coherent tiles that share ONE
traversal stack.  Each step pops a single node (scalar), box-tests the whole
tile against it (pure vector math, node broadcast), pushes a child if ANY ray
hit, and intersects leaf triangles tile-wide.  All memory access is scalar
dynamic-slicing of node/triangle tables + dense vector ops — zero vector
gathers.

Exactness: results are bit-identical to the per-ray traversal, because

- a ray only intersects a leaf when its own slab test passed on the popped
  node (same per-ray gate as the reference), and a ray that misses a node's
  box also misses every descendant box (descendant boxes are contained in the
  ancestor's, and the slab test is monotone under box inclusion), so the
  packet's extra visits can never add a hit the solo traversal lacks;
- pruning never *reorders* a DFS, so equal-t ties resolve to the same
  "first visited" triangle (strict < at Raytracing.compute:95).

Tiles should be spatially coherent (image tiles for primary rays — the same
coherence the reference gets from its 32×32 thread groups).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from unitysimpleraytracing import constants as C
from unitysimpleraytracing.core.types import Bvh, HitRecord, Scene
from unitysimpleraytracing.ops.intersect import ray_box, ray_triangle

PACKET = 1024  # rays per packet: one 32×32 image tile


def _leaf_intersect(scene: Scene, tri_idx, gate, o, d, inv, state):
    """Tile-wide CheckTriangle against ONE triangle (scalar index)."""
    t_cur, tri_cur, u_cur, v_cur = state
    bmin = jax.lax.dynamic_slice_in_dim(scene.aabb_min, tri_idx, 1, 0)[0]
    bmax = jax.lax.dynamic_slice_in_dim(scene.aabb_max, tri_idx, 1, 0)[0]
    box_ok = ray_box(bmin, bmax, o, inv)

    def one(arr):
        return jax.lax.dynamic_slice_in_dim(arr, tri_idx, 1, 0)[0]

    t_new, u_new, v_new = ray_triangle(
        o, d, one(scene.triangles.a), one(scene.triangles.b), one(scene.triangles.c)
    )
    accept = gate & box_ok & (t_new < t_cur)
    return (
        jnp.where(accept, t_new, t_cur),
        jnp.where(accept, tri_idx, tri_cur),
        jnp.where(accept, u_new, u_cur),
        jnp.where(accept, v_new, v_cur),
    )


@jax.jit
def _traverse_one_packet(scene: Scene, bvh: Bvh, o, d):
    """Shared-stack DFS for one coherent packet of rays (P, 3)."""
    P = o.shape[0]
    inv = 1.0 / d

    stack = jnp.zeros((C.TRAVERSAL_STACK_DEPTH,), jnp.int32)
    sp = jnp.int32(1)
    t0 = jnp.full((P,), C.MAX_FLOAT, jnp.float32)
    tri0 = jnp.zeros((P,), jnp.int32)
    z = jnp.zeros((P,), jnp.float32)

    def cond(carry):
        _, sp, *_ = carry
        return sp > 0

    def body(carry):
        stack, sp, t, tri, u, v = carry
        node = stack[sp - 1]
        sp = sp - 1

        bmin = jax.lax.dynamic_slice_in_dim(bvh.node_aabb_min, node, 1, 0)[0]
        bmax = jax.lax.dynamic_slice_in_dim(bvh.node_aabb_max, node, 1, 0)[0]
        hit = ray_box(bmin, bmax, o, inv)  # (P,) per-ray gate
        any_hit = jnp.any(hit)

        left = bvh.left[node]
        right = bvh.right[node]
        left_leaf = bvh.left_is_leaf[node]
        right_leaf = bvh.right_is_leaf[node]

        # Left child: push internal (if any ray proceeds) or intersect leaf.
        push_l = any_hit & ~left_leaf
        stack = jax.lax.dynamic_update_index_in_dim(stack, left, sp, 0)
        sp_l = sp + push_l.astype(jnp.int32)
        tri_l = bvh.sorted_tri[left]
        t, tri, u, v = _leaf_intersect(
            scene, tri_l, hit & left_leaf & any_hit, o, d, inv, (t, tri, u, v)
        )

        push_r = any_hit & ~right_leaf
        stack = jax.lax.dynamic_update_index_in_dim(stack, right, sp_l, 0)
        sp_r = sp_l + push_r.astype(jnp.int32)
        tri_r = bvh.sorted_tri[right]
        t, tri, u, v = _leaf_intersect(
            scene, tri_r, hit & right_leaf & any_hit, o, d, inv, (t, tri, u, v)
        )

        return stack, sp_r, t, tri, u, v

    _, _, t, tri, u, v = jax.lax.while_loop(
        cond, body, (stack, sp, t0, tri0, z, z)
    )
    return t, tri, u, v


@functools.partial(jax.jit, static_argnames=("packet_size", "serial"))
def traverse_packets(
    scene: Scene,
    bvh: Bvh,
    origins: jnp.ndarray,
    dirs: jnp.ndarray,
    packet_size: int = PACKET,
    serial: bool = False,
) -> HitRecord:
    """Nearest-hit traversal over (R, 3) rays in coherent packets.

    R must be a multiple of ``packet_size``; callers order rays so that
    consecutive rays are spatially coherent (see `tiled_ray_order`).
    Bit-identical to `trace.traverse`.

    ``serial=False`` (default) runs all packets in lockstep (vmapped
    while_loop): one loop step advances every packet's DFS at once, so the
    sequential-step overhead amortizes across the whole frame and the gathers
    are tiny per-packet scalars.  ``serial=True`` runs packets one after
    another (lax.map) — less peak memory, useful for huge frames.
    """
    R = origins.shape[0]
    assert R % packet_size == 0, f"{R} rays not divisible by packet {packet_size}"
    T = R // packet_size
    o = origins.reshape(T, packet_size, 3)
    d = dirs.reshape(T, packet_size, 3)

    if serial:
        t, tri, u, v = jax.lax.map(
            lambda od: _traverse_one_packet(scene, bvh, od[0], od[1]), (o, d)
        )
    else:
        t, tri, u, v = jax.vmap(
            lambda oo, dd: _traverse_one_packet(scene, bvh, oo, dd)
        )(o, d)
    return HitRecord(
        t=t.reshape(R), tri=tri.reshape(R), u=u.reshape(R), v=v.reshape(R)
    )


def tiled_ray_order(height: int, width: int, tile: int = 32):
    """Permutation mapping row-major pixel order → 2D-tile-major order
    (the reference's 32×32 thread-group locality), plus its inverse.

    Width/height must be multiples of ``tile`` (pad the image if not).
    Returns (perm, inv_perm): ``rays[perm]`` is tile-major;
    ``hits[inv_perm]`` restores row-major.
    """
    import numpy as np

    assert height % tile == 0 and width % tile == 0
    idx = np.arange(height * width).reshape(height, width)
    tiles = idx.reshape(height // tile, tile, width // tile, tile)
    perm = tiles.transpose(0, 2, 1, 3).reshape(-1)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size)
    return perm, inv
