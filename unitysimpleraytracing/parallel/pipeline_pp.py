"""Pipeline parallelism: build and trace stages overlapped across devices.

SURVEY §2 marks PP "optional: stage sort→build→trace across steps" — the one
parallelism row round 1 left empty.  For a raytracer the natural pipeline is
the DYNAMIC-scene frame loop (BASELINE config 4): every frame needs a full
re-sort + rebuild AND a trace; on one device they serialize.  Here a 2-stage
``pp`` mesh axis overlaps them:

    step i:   stage 0  builds frame i's LBVH        (deform → sort → build)
              stage 1  traces frame i-1's BVH       (received last step)
              ppermute hands stage 0's build output to stage 1

Steady-state throughput = max(build, trace) instead of build + trace, at a
one-frame latency — the classic GPipe-style fill/drain, with the BVH playing
the role of the microbatch activations and ``ppermute`` the stage link.

Exactness: the pipelined stream equals the serial per-frame render, shifted
by one step (tested on the CPU mesh).  Stages diverge by ``lax.cond`` on
``axis_index`` — each device runs only its stage's work.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from unitysimpleraytracing import constants as C
from unitysimpleraytracing.core.types import HitRecord, Scene
from unitysimpleraytracing.ops import lbvh, sort, unique
from unitysimpleraytracing.pipeline.build import deform_scene


def make_pp_mesh(devices=None) -> Mesh:
    """A 2-device (build, trace) pipeline mesh."""
    import numpy as np

    devices = devices if devices is not None else jax.devices()
    assert len(devices) >= 2, "pipeline needs 2 devices"
    return Mesh(np.asarray(devices[:2]), ("pp",))


def render_frames_pipelined(
    scene: Scene,
    positions: jnp.ndarray,  # (F, cap, 3, 3) per-frame vertex positions
    origins: jnp.ndarray,
    dirs: jnp.ndarray,
    mesh: Mesh,
    impl: str = "auto",
):
    """Trace F dynamic frames with build (stage 0) and trace (stage 1)
    overlapped.  Returns per-frame HitRecord arrays shaped (F, R).

    The scan runs F+1 steps (fill + drain): step i builds frame i and traces
    frame i-1.  Per-frame results are bit-identical to a serial
    deform → build_bvh → traverse of the same frame with the same ``impl``.

    ``impl`` selects the trace stage's engine via the production dispatch
    (ops/dispatch.trace_rays): ``auto`` resolves to the GPU kernel on a GPU
    and XLA packets on CPU; ``perray`` is the reference/debug engine.
    """
    F = positions.shape[0]
    R = origins.shape[0]
    cap = scene.capacity

    # Pad the frame stream with one dummy step for the drain.
    pos_stream = jnp.concatenate([positions, positions[-1:]], axis=0)

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P(), P(), P()),
        out_specs=(P(), P()),
        check_vma=False,
    )
    def run(scene_r, pos_stream_r, origins_r, dirs_r):
        stage = jax.lax.axis_index("pp")

        def build_stage(pos):
            s2 = deform_scene(scene_r, pos)
            keys, sorted_tri = sort.sort_key_val(s2.morton, s2.tri_index)
            keys = unique.distribute_keys(keys, s2.count)
            bvh = lbvh.build_bvh_from_sorted(
                keys, sorted_tri, s2.aabb_min, s2.aabb_max, s2.count
            )
            # Stage link payload: everything trace needs from the build.
            return (
                bvh.left, bvh.right,
                bvh.left_is_leaf, bvh.right_is_leaf,
                bvh.range_first, bvh.range_last, bvh.split_axis,
                bvh.node_aabb_min, bvh.node_aabb_max, bvh.sorted_tri,
                s2.aabb_min, s2.aabb_max, pos,
            )

        def zeros_like_payload(pos):
            # A trivially-terminating placeholder tree (both root children
            # are leaves), so the fill-step trace on stage 1 — whose output
            # is discarded — cannot loop or read out of bounds.
            i32 = lambda: jnp.zeros((cap,), jnp.int32)
            ones = lambda: jnp.ones((cap,), bool)
            f3 = lambda: jnp.zeros((cap, 3), jnp.float32)
            return (
                i32(), i32(), ones(), ones(), i32(), i32(), i32(),
                f3(), f3(), i32(), f3(), f3(), jnp.zeros_like(pos),
            )

        def trace_stage(payload):
            from unitysimpleraytracing.ops import dispatch

            (left, right, lleaf, rleaf, rf, rl, ax,
             nmin, nmax, stri, amin, amax, pos) = payload
            s2 = deform_scene(scene_r, pos)
            bvh = _bvh_from(payload, cap)
            h = dispatch.trace_rays(s2, bvh, origins_r, dirs_r, impl=impl)
            return h.t, h.tri, h.u, h.v

        def _bvh_from(payload, cap):
            from unitysimpleraytracing.core.types import Bvh

            (left, right, lleaf, rleaf, rf, rl, ax,
             nmin, nmax, stri, amin, amax, pos) = payload
            neg = jnp.full((cap,), -1, jnp.int32)
            return Bvh(
                left=left, right=right,
                left_is_leaf=lleaf, right_is_leaf=rleaf,
                internal_parent=neg, leaf_parent=neg,
                range_first=rf, range_last=rl, split_axis=ax,
                node_aabb_min=nmin, node_aabb_max=nmax,
                sorted_tri=stri, depth=neg, count=scene_r.count,
            )

        def step(carry, pos_i):
            prev_payload = carry
            # Stage 1 traces the PREVIOUS frame's BVH (received last step) —
            # BEFORE this step's stage link, so the trace has no data
            # dependence on stage 0's concurrent build and the two stages
            # genuinely overlap.  (Round 2 ran the ppermute between build and
            # trace: stage 1 then waited for the CURRENT build before tracing
            # the previous frame, serializing every step to build + trace.)
            t, tri, u, v = jax.lax.cond(
                stage == 1,
                trace_stage,
                lambda _: (
                    jnp.full((R,), C.MAX_FLOAT, jnp.float32),
                    jnp.zeros((R,), jnp.int32),
                    jnp.zeros((R,), jnp.float32),
                    jnp.zeros((R,), jnp.float32),
                ),
                prev_payload,
            )
            # Stage 0 builds this frame; stage 1 skips the build work.
            payload = jax.lax.cond(
                stage == 0, build_stage, zeros_like_payload, pos_i
            )
            # Hand stage 0's output to stage 1 (one hop along pp).
            payload = tuple(
                jax.lax.ppermute(x, "pp", [(0, 1)]) for x in payload
            )
            return payload, (t, tri, u, v)

        init = zeros_like_payload(pos_stream_r[0])
        _, ys = jax.lax.scan(step, init, pos_stream_r)
        # ys rows are meaningful on stage 1 only (stage 0 emitted the miss
        # pattern); a cross-stage min/max makes both devices return the
        # stage-1 stream.
        t, tri, u, v = ys
        # psum-style broadcast: stage 0 contributed zeros/MAX_FLOAT rows.
        t = jax.lax.pmin(t, "pp")
        tri = jax.lax.pmax(tri, "pp")
        u = jax.lax.pmax(u, "pp")
        v = jax.lax.pmax(v, "pp")
        return (t[1:], tri[1:]), (u[1:], v[1:])

    (t, tri), (u, v) = run(scene, pos_stream, origins, dirs)
    return HitRecord(t=t, tri=tri, u=u, v=v)
