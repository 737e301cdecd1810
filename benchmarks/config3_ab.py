"""Config-3 (260K tris, 1080p + shadows) same-session A/B of the shadow-ray
miss substitution (VERDICT r2 next-round item 1).

Variant "junk" reproduces round 2's `_shadow_mask`: miss pixels traced a
shadow ray from the WORLD ORIGIN (inside the terrain bounds) through the
whole scene, discarded by the `& hits.hit` mask afterwards.  Variant "subst"
is the shipped path: miss pixels get a guaranteed-miss ray whose whole line
stays outside the root box, so it ends at the root record.

    python benchmarks/config3_ab.py [--res 362] [--width 1920 --height 1056]
"""
from __future__ import annotations

import argparse
import functools
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--res", type=int, default=362)  # 260,642 tris
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1056)
    ap.add_argument("--iters", type=int, default=2)
    ap.add_argument("--reps", type=int, default=4)
    ap.add_argument("--builder", default="karras", choices=["karras", "sah"])
    args = ap.parse_args(argv)

    import jax

    from unitysimpleraytracing.utils import compile_cache

    compile_cache.enable()

    import jax.numpy as jnp
    import numpy as np

    import unitysimpleraytracing as rt
    from unitysimpleraytracing.core.camera import generate_rays
    from unitysimpleraytracing.ops import trace
    from unitysimpleraytracing.ops.dispatch import (
        _row_major, _tile_major, camera_trace, occluded, resolve_impl,
    )
    from unitysimpleraytracing.utils.profiling import measure

    mesh = rt.terrain_mesh(res=args.res, size=160.0, amplitude=20.0, seed=1)
    scene = rt.build_scene(mesh)
    bvh = rt.build_bvh(scene, builder=args.builder)
    cam = rt.make_camera(
        eye=(110.0, 90.0, 140.0), target=(0.0, 0.0, 0.0),
        width=args.width, height=args.height, fov_deg=60.0,
    )
    tex = rt.solid_texture((0.8, 0.7, 0.6, 1.0))
    from unitysimpleraytracing.pipeline.render import _prepared

    impl = resolve_impl("auto", bvh.capacity)
    tables = _prepared(scene, bvh, impl)
    h, w = cam.height, cam.width

    @functools.partial(jax.jit, static_argnames=("junk",))
    def frame(scene, bvh, cam, tex, tables, junk):
        hits = camera_trace(scene, bvh, cam, impl=impl, tables=tables)
        o, d = generate_rays(cam)
        light = jnp.full((3,), 1.0 / jnp.sqrt(jnp.float32(3.0)), jnp.float32)
        hitm = hits.hit[:, None]
        if junk:  # round 2: miss pixels -> p = 0, traced anyway
            p = jnp.where(hitm, o + hits.t[:, None] * d, 0.0)
            dirs = jnp.broadcast_to(light, p.shape)
            origins = p + dirs * 1e-3
        else:  # shipped: guaranteed-miss substitution
            base = jnp.nan_to_num(bvh.node_aabb_max[0], posinf=0.0, neginf=0.0)
            miss_o = base + jnp.maximum(jnp.max(jnp.abs(base)), 1.0)
            miss_d = jnp.asarray([1.0, 0.0, 0.0], jnp.float32)
            p = o + jnp.where(hitm, hits.t[:, None], 0.0) * d
            dirs = jnp.where(hitm, light[None, :], miss_d[None, :])
            origins = jnp.where(hitm, p + light[None, :] * 1e-3, miss_o[None, :])
        occ = occluded(
            scene, bvh,
            _tile_major(origins, h, w, 32), _tile_major(dirs, h, w, 32),
            impl=impl, tables=tables,
        )
        shadow = _row_major(occ, h, w, 32) & hits.hit
        rgba = trace.shade(scene, tex, hits, shadow=shadow)
        return rgba.reshape(h, w, 4)

    out = {"n_tris": scene.count, "res": f"{w}x{h}", "builder": args.builder,
           "impl": impl}
    fa = np.asarray(frame(scene, bvh, cam, tex, tables, False))
    fb = np.asarray(frame(scene, bvh, cam, tex, tables, True))
    out["frames_equal"] = bool(np.array_equal(fa, fb))
    miss_frac = 1.0 - float(
        rt.render_hits(scene, bvh, cam, impl=impl).hit.mean()
    )
    out["miss_frac"] = round(miss_frac, 4)
    for junk, name in ((True, "junk_ms"), (False, "subst_ms")):
        s = measure(
            lambda j=junk: frame(scene, bvh, cam, tex, tables, j),
            iters=args.iters, reps=args.reps,
        )
        out[name] = round(s * 1e3, 1)
        print(f"[ab] {name}: {out[name]} ms", file=sys.stderr, flush=True)
    out["speedup"] = round(out["junk_ms"] / out["subst_ms"], 3)
    out["mrays_per_s"] = round(2 * w * h / (out["subst_ms"] / 1e3) / 1e6, 2)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
