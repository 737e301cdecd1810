"""Ray-box (slab) and ray-triangle (Möller–Trumbore) tests, batched.

Bit-parity targets (SURVEY §7 hard part 4):

- Slab test (``Raytracing.compute:75-87``): acceptance is exactly
  ``tmax > tmin && tmax > 0`` — no near-plane clip, no ordering of children.
  HLSL ``min``/``max`` follow D3D semantics (NaN in one operand returns the
  other operand); ``jnp.minimum``/``maximum`` propagate NaN, so D3D-semantics
  helpers are used.  NaNs arise when a zero direction component (inv_dir=±inf)
  meets a coincident slab (0·inf).
- Möller–Trumbore (``Raytracing.compute:37-73``): rejects ``|det| < 1e-8``,
  ``u∉[0,1]``, ``v<0 or u+v>1`` — and accepts *negative* t exactly like the
  reference (no t>0 test; the triangle-AABB pre-test usually culls behind-ray
  hits, but not when the origin is inside the box).
"""
from __future__ import annotations

import jax.numpy as jnp

from unitysimpleraytracing import constants as C


def d3d_min(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """HLSL min: if one operand is NaN, returns the other."""
    return jnp.where(jnp.isnan(a), b, jnp.where(jnp.isnan(b), a, jnp.minimum(a, b)))


def d3d_max(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    return jnp.where(jnp.isnan(a), b, jnp.where(jnp.isnan(b), a, jnp.maximum(a, b)))


def ray_box(
    box_min: jnp.ndarray,  # (..., 3)
    box_max: jnp.ndarray,  # (..., 3)
    origin: jnp.ndarray,   # (..., 3)
    inv_dir: jnp.ndarray,  # (..., 3)
) -> jnp.ndarray:
    """Slab test; returns bool (...). Matches Raytracing.compute:75-87."""
    t1 = (box_min - origin) * inv_dir
    t2 = (box_max - origin) * inv_dir
    tmin3 = d3d_min(t1, t2)
    tmax3 = d3d_max(t1, t2)
    tmin = d3d_max(tmin3[..., 0], d3d_max(tmin3[..., 1], tmin3[..., 2]))
    tmax = d3d_min(tmax3[..., 0], d3d_min(tmax3[..., 1], tmax3[..., 2]))
    return (tmax > tmin) & (tmax > 0)


def ray_triangle(
    origin: jnp.ndarray,  # (..., 3)
    direction: jnp.ndarray,  # (..., 3)
    v0: jnp.ndarray,
    v1: jnp.ndarray,
    v2: jnp.ndarray,
):
    """Möller–Trumbore. Returns (t, u, v) with t = MAX_FLOAT on reject.

    Matches Raytracing.compute:37-73 including NaN fall-through: a NaN
    intermediate fails every reject test but also fails the final
    ``t < best`` comparison, so it never becomes a hit.
    """
    e1 = v1 - v0
    e2 = v2 - v0
    pvec = jnp.cross(direction, e2)
    det = jnp.sum(e1 * pvec, axis=-1)
    reject_det = (det < 1e-8) & (det > -1e-8)

    inv_det = 1.0 / det
    tvec = origin - v0
    u = jnp.sum(tvec * pvec, axis=-1) * inv_det
    reject_u = (u < 0) | (u > 1)

    qvec = jnp.cross(tvec, e1)
    v = jnp.sum(direction * qvec, axis=-1) * inv_det
    reject_v = (v < 0) | (u + v > 1)

    t = jnp.sum(e2 * qvec, axis=-1) * inv_det
    reject = reject_det | reject_u | reject_v
    t = jnp.where(reject, jnp.float32(C.MAX_FLOAT), t)
    return t, u, v
