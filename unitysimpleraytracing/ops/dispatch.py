"""Traversal implementation dispatch.

Three interchangeable traversal engines, one contract (hit records equal up
to exact-t ties; see trace_packet.py for the exactness argument):

- ``gpu``    — the GPU kernel (trace_gpu): one ray per lane with a private
  DFS stack over wide BVH4 records, compiled through Pallas's Triton route.
  On the CPU it runs only in the Pallas interpreter, for tests.
- ``packet`` — XLA shared-stack packets (trace_packet).
- ``perray`` — XLA per-ray stacks, the direct analog of the reference's one
  thread per pixel; the plain reference.

``auto`` picks ``gpu`` on a GPU backend and ``packet`` elsewhere.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from unitysimpleraytracing.core.types import Bvh, HitRecord, Scene
from unitysimpleraytracing.ops import trace, trace_gpu, trace_packet

CapacityError = trace_gpu.CapacityError

# Ray-count granule per engine: trace_rays pads R up to a multiple.
_GRANULE = {"gpu": trace_gpu.BLOCK, "packet": trace_packet.PACKET}


def resolve_impl(impl: str, capacity: int) -> str:
    """Concrete engine name for ``impl``.  ``auto`` takes the GPU kernel on
    a GPU backend (raising `CapacityError` past its id bound rather than
    falling back to a slower engine) and the XLA packet engine elsewhere."""
    if impl != "auto":
        return impl
    if jax.default_backend() == "gpu":
        trace_gpu.check_capacity(capacity)
        return "gpu"
    return "packet"


def trace_rays(
    scene: Scene,
    bvh: Bvh,
    origins: jnp.ndarray,
    dirs: jnp.ndarray,
    impl: str = "auto",
    tables=None,
    t_init=None,
    anyhit_thresh=None,
) -> HitRecord:
    """Trace an (R, 3) ray batch with the chosen engine, padding R as needed.

    Rays should arrive in a coherent order (image-tile order for camera rays).
    ``tables`` optionally carries `trace_gpu.prepare_tables` output so a
    static scene is packed once, not per frame.  ``t_init`` (optional (R,)
    f32) is an exact pruning bound from a previous traversal (chunk/hop);
    engines that cannot exploit it ignore it — results are identical either
    way (a candidate at or beyond the bound can never win the caller's
    strict-< fold).  ``anyhit_thresh`` (optional (R,) f32, 0 = off) is the
    occlusion early-exit: engines that support it collapse a ray's t to 0 at
    the first hit strictly below the threshold (the occlusion BOOLEAN
    ``hit & (t < thresh)`` is identical either way — the nearest hit is
    minimal, so one below-threshold hit exists iff the nearest is below).
    """
    impl = resolve_impl(impl, bvh.capacity)
    if impl == "perray":
        return trace.traverse(scene, bvh, origins, dirs)
    if impl not in _GRANULE:
        raise ValueError(f"unknown traversal impl {impl!r}")

    R = origins.shape[0]
    pad = (-R) % _GRANULE[impl]
    if pad:
        origins = jnp.concatenate([origins, jnp.broadcast_to(origins[:1], (pad, 3))])
        dirs = jnp.concatenate([dirs, jnp.broadcast_to(dirs[:1], (pad, 3))])
        if t_init is not None:
            t_init = jnp.concatenate(
                [t_init, jnp.zeros((pad,), jnp.float32)]  # padding: cull all
            )
        if anyhit_thresh is not None:
            anyhit_thresh = jnp.concatenate(
                [anyhit_thresh, jnp.zeros((pad,), jnp.float32)]
            )

    if impl == "gpu":
        hits = trace_gpu.traverse(
            scene, bvh, origins, dirs, tables=tables, t_init=t_init,
            anyhit_thresh=anyhit_thresh,
            interpret=jax.default_backend() == "cpu",
        )
    else:
        hits = trace_packet.traverse_packets(scene, bvh, origins, dirs)

    if pad:
        hits = HitRecord(
            t=hits.t[:R], tri=hits.tri[:R], u=hits.u[:R], v=hits.v[:R]
        )
    return hits


def occluded(
    scene: Scene,
    bvh: Bvh,
    origins: jnp.ndarray,
    dirs: jnp.ndarray,
    impl: str = "auto",
    eps: float = 4e-3,
    tables=None,
    origin_bound: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """Shadow/occlusion query: True where geometry blocks the ray beyond
    ``eps`` of its origin.  A capability beyond the reference (its shading
    has no shadow rays); BASELINE.json config 3 stresses it.

    Traced BACKWARD from a point outside the scene toward the origin: the
    parity-exact engines inherit the reference's acceptance quirk of keeping
    negative-t intersections whenever the origin sits inside a triangle's
    inflated AABB (Raytracing.compute:89-103 has no t>0 test), which poisons
    forward queries that start ON a surface — the self-hit at t≈-ε wins the
    nearest-hit compare.  Starting from outside the scene no box contains the
    origin, so every accepted t is positive; anything strictly between the
    far point and ``origin + eps·dir`` is a real occluder.

    ``origin_bound``: optional scalar upper bound on ``max|origins|``.  By
    default the far scale is derived from the actual batch, which makes the
    arithmetic depend on which rays share the call — callers that need
    batch-invariant results (the shadow passes, which must be bit-identical
    whether frames are rendered one at a time or batched) pass a bound
    derived from the scene alone.
    """
    ext = jnp.maximum(
        jnp.max(jnp.abs(scene.aabb_min)), jnp.max(jnp.abs(scene.aabb_max))
    )
    if origin_bound is None:
        origin_bound = jnp.max(jnp.abs(origins))
    far = 4.0 * ext + origin_bound + 1.0
    back_origins = origins + dirs * far
    # Occlusion needs a boolean, not the nearest hit: the any-hit threshold
    # lets the kernel retire a ray at its FIRST qualifying hit (t collapses
    # to 0, which still satisfies hit & t < far-eps below).  Engines without
    # any-hit support ignore it and answer via their nearest hit — the
    # boolean is identical (the nearest hit is minimal).
    thresh = jnp.broadcast_to(far - eps, (origins.shape[0],)).astype(jnp.float32)
    hits = trace_rays(
        scene, bvh, back_origins, -dirs, impl=impl, tables=tables,
        anyhit_thresh=thresh,
    )
    return hits.hit & (hits.t < far - eps)


def _tile_major(x: jnp.ndarray, h: int, w: int, tile: int) -> jnp.ndarray:
    """Row-major (H*W, ...) → 2D-tile-major, as a reshape/transpose (the
    permutation of trace_packet.tiled_ray_order without a gather)."""
    rest = x.shape[1:]
    x = x.reshape(h // tile, tile, w // tile, tile, *rest)
    x = jnp.swapaxes(x, 1, 2)
    return x.reshape(h * w, *rest)


def _row_major(x: jnp.ndarray, h: int, w: int, tile: int) -> jnp.ndarray:
    """Inverse of `_tile_major`."""
    rest = x.shape[1:]
    x = x.reshape(h // tile, w // tile, tile, tile, *rest)
    x = jnp.swapaxes(x, 1, 2)
    return x.reshape(h * w, *rest)


def camera_trace(
    scene: Scene, bvh: Bvh, cam, impl: str = "auto", tables=None
) -> HitRecord:
    """Primary-ray trace in tile-major order (the reference's 32×32 thread
    groups, RaytracingMeshDrawer.cs:83), results returned in row-major pixel
    order."""
    from unitysimpleraytracing.core.camera import generate_rays

    origins, dirs = generate_rays(cam)
    h, w = cam.height, cam.width
    if h % 32 == 0 and w % 32 == 0:
        hits = trace_rays(
            scene,
            bvh,
            _tile_major(origins, h, w, 32),
            _tile_major(dirs, h, w, 32),
            impl=impl,
            tables=tables,
        )
        return HitRecord(
            t=_row_major(hits.t, h, w, 32),
            tri=_row_major(hits.tri, h, w, 32),
            u=_row_major(hits.u, h, w, 32),
            v=_row_major(hits.v, h, w, 32),
        )
    return trace_rays(scene, bvh, origins, dirs, impl=impl, tables=tables)
