"""Animated-frame breakdown: the fused one-dispatch frame vs its stages.

Measures `make_animated_renderer`'s deform → refit → BVH4 slot-update →
trace frame (VERDICT r3 item 2's 60 Hz target) and the unfused stage costs
for attribution.  The fused frame is one dispatch; the unfused loop pays a
dispatch per stage — always compare the FUSED number.

    python benchmarks/anim_bench.py [--res 182] [--width 512]
"""
from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--res", type=int, default=182)  # 65,522 tris
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--height", type=int, default=512)
    args = ap.parse_args(argv)

    import jax

    from unitysimpleraytracing.utils import compile_cache

    compile_cache.enable()

    import jax.numpy as jnp

    import unitysimpleraytracing as rt
    from unitysimpleraytracing.pipeline.build import deform_scene, refit_bvh
    from unitysimpleraytracing.utils.profiling import measure

    mesh = rt.terrain_mesh(res=args.res, size=80.0, amplitude=9.0, seed=0)
    scene = rt.build_scene(mesh)
    bvh = rt.build_bvh(scene, builder="karras")
    cam = rt.make_camera(
        eye=(55.0, 45.0, 70.0), target=(0.0, 0.0, 0.0),
        width=args.width, height=args.height, fov_deg=60.0,
    )
    t = scene.triangles
    base = jnp.stack([t.a, t.b, t.c], axis=1)
    pos_fn = jax.jit(
        lambda ph: base.at[..., 1].add(0.5 * jnp.sin(base[..., 0] * 0.37 + ph))
    )
    anim = rt.make_animated_renderer(scene, bvh, cam)

    out = {"n_tris": scene.count, "rays": args.width * args.height}
    s = measure(lambda: anim(pos_fn(0.9)).t, iters=4, reps=8)
    out["fused_frame_ms"] = round(s * 1e3, 2)
    out["fused_frame_hz"] = round(1.0 / s, 1)
    print(f"[anim] fused frame: {out['fused_frame_ms']} ms "
          f"({out['fused_frame_hz']} Hz)", file=sys.stderr, flush=True)

    # Stage attribution (separately-dispatched, so sums exceed the fused
    # frame by the dispatch overhead the fusion removes).
    pos = pos_fn(0.9)
    s2 = deform_scene(scene, pos)
    b2 = refit_bvh(s2, bvh)
    out["deform_refit_ms"] = round(
        measure(lambda: refit_bvh(deform_scene(scene, pos), bvh).node_aabb_min,
                iters=3, reps=6) * 1e3, 2)
    out["trace_ms"] = round(
        measure(lambda: rt.render_hits(s2, b2, cam).t, iters=3, reps=6) * 1e3, 2)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
