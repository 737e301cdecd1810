"""Batched BVH traversal, shading, and brute-force oracle.

The reference traverses per-pixel with an explicit ``uint stack[64]`` DFS in
one GPU thread per ray (``Raytracing.compute:105-176``).  This module is
the plain XLA form of that design, *batched*: every ray in the
batch carries its own stack row in a (R, 64) array, and one
``lax.while_loop`` iteration performs one stack pop for every still-active ray
with masked updates.  The pop/push/intersect sequence inside an iteration is
ordered exactly like the reference body (box-test popped node → left child:
push or intersect → right child: push or intersect), so nearest-hit
tie-breaking ("first visited wins", strict ``<`` at Raytracing.compute:95) is
bit-identical.

The hit result is (t, tri, u, v); ``tri`` stays 0 on miss and shading then
reads triangle 0's data, matching Raytracing.compute:129-131,178-184.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from unitysimpleraytracing import constants as C
from unitysimpleraytracing.core.texture import Texture, sample_bilinear
from unitysimpleraytracing.core.types import Bvh, HitRecord, Scene
from unitysimpleraytracing.ops.intersect import ray_box, ray_triangle


def _check_triangle(scene: Scene, tri_idx, mask, origins, dirs, inv_dirs, state):
    """CheckTriangle (Raytracing.compute:89-103): triangle-AABB pre-test, then
    Möller–Trumbore; accept strictly closer hits only, masked by ``mask``."""
    t_cur, tri_cur, u_cur, v_cur = state
    bmin = scene.aabb_min[tri_idx]
    bmax = scene.aabb_max[tri_idx]
    box_ok = ray_box(bmin, bmax, origins, inv_dirs)
    t_new, u_new, v_new = ray_triangle(
        origins,
        dirs,
        scene.triangles.a[tri_idx],
        scene.triangles.b[tri_idx],
        scene.triangles.c[tri_idx],
    )
    accept = mask & box_ok & (t_new < t_cur)
    t = jnp.where(accept, t_new, t_cur)
    tri = jnp.where(accept, tri_idx, tri_cur)
    u = jnp.where(accept, u_new, u_cur)
    v = jnp.where(accept, v_new, v_cur)
    return t, tri, u, v


def _stack_write(stack, pos, value, mask):
    """stack[r, pos[r]] = value[r] where mask[r], vectorized over rays."""
    cols = jnp.arange(stack.shape[1], dtype=jnp.int32)[None, :]
    sel = (cols == pos[:, None]) & mask[:, None]
    return jnp.where(sel, value[:, None], stack)


@functools.partial(jax.jit, static_argnames=())
def traverse(scene: Scene, bvh: Bvh, origins: jnp.ndarray, dirs: jnp.ndarray) -> HitRecord:
    """Nearest-hit BVH traversal for a batch of rays.

    origins/dirs: (R, 3) f32, dirs unit length. Returns HitRecord over R rays.
    """
    R = origins.shape[0]
    cap = bvh.capacity
    inv_dirs = 1.0 / dirs

    stack = jnp.zeros((R, C.TRAVERSAL_STACK_DEPTH), jnp.int32)
    sp = jnp.ones((R,), jnp.int32)  # stack = [root]; Raytracing.compute:133-136
    t0 = jnp.full((R,), C.MAX_FLOAT, jnp.float32)
    tri0 = jnp.zeros((R,), jnp.int32)
    uv0 = jnp.zeros((R,), jnp.float32)

    def cond(carry):
        _, sp, *_ = carry
        return jnp.any(sp > 0)

    def body(carry):
        stack, sp, t, tri, u, v = carry
        active = sp > 0
        spm1 = jnp.maximum(sp - 1, 0)
        node = jnp.take_along_axis(stack, spm1[:, None], axis=1)[:, 0]
        node = jnp.clip(node, 0, cap - 1)

        box_ok = ray_box(
            bvh.node_aabb_min[node], bvh.node_aabb_max[node], origins, inv_dirs
        )
        proceed = active & box_ok

        left = jnp.clip(bvh.left[node], 0, cap - 1)
        right = jnp.clip(bvh.right[node], 0, cap - 1)
        left_leaf = bvh.left_is_leaf[node]
        right_leaf = bvh.right_is_leaf[node]

        # Left child: push internal / intersect leaf (Raytracing.compute:148-159).
        push_l = proceed & ~left_leaf
        stack = _stack_write(stack, spm1, left, push_l)
        sp_l = spm1 + push_l.astype(jnp.int32)
        tri_l = bvh.sorted_tri[left]
        t, tri, u, v = _check_triangle(
            scene, tri_l, proceed & left_leaf, origins, dirs, inv_dirs, (t, tri, u, v)
        )

        # Right child (Raytracing.compute:161-175).
        push_r = proceed & ~right_leaf
        stack = _stack_write(stack, sp_l, right, push_r)
        sp_r = sp_l + push_r.astype(jnp.int32)
        tri_r = bvh.sorted_tri[right]
        t, tri, u, v = _check_triangle(
            scene, tri_r, proceed & right_leaf, origins, dirs, inv_dirs, (t, tri, u, v)
        )

        sp = jnp.where(active, sp_r, sp)
        return stack, sp, t, tri, u, v

    _, _, t, tri, u, v = jax.lax.while_loop(
        cond, body, (stack, sp, t0, tri0, uv0, uv0)
    )
    return HitRecord(t=t, tri=tri, u=u, v=v)


def brute_force_trace(
    scene: Scene, origins: jnp.ndarray, dirs: jnp.ndarray, chunk: int = 1024
) -> HitRecord:
    """Oracle: test every ray against every real triangle, in ascending
    triangle-id order with strict-< acceptance and the same AABB pre-test.

    Matches `traverse` everywhere hit distances are untied (ties may resolve
    differently since DFS visit order ≠ id order); tests use tie-free scenes.
    """
    R = origins.shape[0]
    inv_dirs = 1.0 / dirs
    n = scene.count

    t = jnp.full((R,), C.MAX_FLOAT, jnp.float32)
    tri = jnp.zeros((R,), jnp.int32)
    u = jnp.zeros((R,), jnp.float32)
    v = jnp.zeros((R,), jnp.float32)

    def body(i, state):
        idx = jnp.full((R,), i, jnp.int32)
        return _check_triangle(
            scene, idx, jnp.ones((R,), bool), origins, dirs, inv_dirs, state
        )

    t, tri, u, v = jax.lax.fori_loop(0, n, body, (t, tri, u, v))
    return HitRecord(t=t, tri=tri, u=u, v=v)


def shade(
    scene: Scene, tex: Texture, hits: HitRecord, shadow: jnp.ndarray | None = None
) -> jnp.ndarray:
    """Lambert shading + texture (Raytracing.compute:178-184): barycentric
    UV/normal interpolation (normals NOT renormalized), bilinear sample,
    ``max(0.4, dot(L, N))`` with L = normalize(1,1,1); alpha = hit flag.

    ``shadow`` (R,) bool — optional occlusion mask from a shadow-ray pass
    (a capability beyond the reference): shadowed pixels drop to the
    reference's 0.4 ambient floor.

    (The reference assigns normalize(float3(1,1,1)) to a scalar float and lets
    HLSL re-broadcast it in ``dot`` — algebraically identical to the proper
    dot product, so no quirk flag is needed.)
    """
    tri = hits.tri
    w = 1.0 - hits.u - hits.v
    bary = (w[:, None], hits.u[:, None], hits.v[:, None])
    # ONE 15-column row-gather instead of six attribute gathers.
    t = scene.triangles
    attr = jnp.concatenate(
        [t.a_uv, t.b_uv, t.c_uv, t.a_normal, t.b_normal, t.c_normal], axis=1
    )  # (cap, 15)
    rec = attr[tri]
    uv = bary[0] * rec[:, 0:2] + bary[1] * rec[:, 2:4] + bary[2] * rec[:, 4:6]
    normal = (
        bary[0] * rec[:, 6:9] + bary[1] * rec[:, 9:12] + bary[2] * rec[:, 12:15]
    )
    inv_sqrt3 = jnp.float32(1.0) / jnp.sqrt(jnp.float32(3.0))
    lambert = jnp.maximum(0.4, inv_sqrt3 * jnp.sum(normal, axis=-1))
    if shadow is not None:
        lambert = jnp.where(shadow, jnp.float32(0.4), lambert)
    texel = sample_bilinear(tex, uv[:, 0], uv[:, 1])
    rgb = texel[:, :3] * lambert[:, None]
    alpha = hits.hit.astype(jnp.float32)
    return jnp.concatenate([rgb, alpha[:, None]], axis=1)


def compose(background_rgb: jnp.ndarray, traced_rgba: jnp.ndarray) -> jnp.ndarray:
    """ImageComposer.shader:44-53: lerp(raster, traced, traced.a), alpha 1."""
    a = traced_rgba[..., 3:4]
    rgb = background_rgb[..., :3] * (1.0 - a) + traced_rgba[..., :3] * a
    return jnp.concatenate([rgb, jnp.ones_like(a)], axis=-1)
