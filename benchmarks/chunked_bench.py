"""Chunked 1M-triangle trace breakdown.

Measures where the chunked frame goes: per-chunk kernel time in schedule
order (with the running t_init threaded exactly as trace_chunked does), the
fraction of rays whose gate (root-box overlap ∧ entry < best) is live per
chunk, and the whole-frame time for the production path vs engine variants.

    python benchmarks/chunked_bench.py [--res 708] [--impl auto|gpu|packet]
"""
from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

WIDTH = HEIGHT = 512


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--res", type=int, default=708)  # 999,698 tris
    ap.add_argument("--impl", default="auto")
    ap.add_argument("--chunk-capacity", type=int, default=None,
                    help="triangles per chunk (default: the kernel's bound, "
                    "pipeline/chunked.DEFAULT_CHUNK_CAPACITY)")
    ap.add_argument("--builder", default=None, choices=["karras", "sah", "sah_free"])
    ap.add_argument("--random-rays", action="store_true",
                    help="incoherent ray batch instead of camera rays (the "
                    "routing win case: packets start chunk-incoherent)")
    ap.add_argument("--per-chunk", action="store_true",
                    help="also time each chunk's launch separately")
    ap.add_argument("--compact", default="none,auto",
                    help="comma-separated compaction variants to A/B on the "
                    "camera frame: 'none', 'auto', or a single schedule "
                    "position (e.g. --compact none,auto,1)")
    ap.add_argument("--oracle", action="store_true",
                    help="also measure the perfect-knowledge pruning bound: "
                    "every chunk seeded with the FINAL per-ray t — no "
                    "schedule/compaction/routing can beat it)")
    args = ap.parse_args(argv)

    import jax

    from unitysimpleraytracing.utils import compile_cache

    compile_cache.enable()

    import jax.numpy as jnp
    import numpy as np

    import unitysimpleraytracing as rt
    from unitysimpleraytracing.core.camera import generate_rays
    from unitysimpleraytracing.ops.dispatch import _tile_major
    from unitysimpleraytracing.pipeline import chunked
    from unitysimpleraytracing.utils.profiling import measure

    big = rt.build_scene(
        rt.terrain_mesh(res=args.res, size=300.0, amplitude=30.0, seed=0)
    )
    cam = rt.make_camera(
        eye=(210.0, 170.0, 260.0), target=(0.0, 0.0, 0.0),
        width=WIDTH, height=HEIGHT, fov_deg=60.0,
    )
    import time

    t0 = time.perf_counter()
    cap = {} if args.chunk_capacity is None else {"chunk_capacity": args.chunk_capacity}
    cbvh = rt.build_bvh_chunked(big, builder=args.builder, **cap)
    cbvh.tables.block_until_ready()
    build_cold_s = time.perf_counter() - t0
    R = WIDTH * HEIGHT
    out = {"n_tris": big.count, "chunks": cbvh.num_chunks,
           "chunk_capacity": cbvh.capacity, "impl": args.impl,
           "builder": args.builder, "build_cold_s": round(build_cold_s, 2)}
    print(f"[chunk] {out}", file=sys.stderr, flush=True)

    from unitysimpleraytracing.pipeline import chunked as chunked_mod

    if args.random_rays:
        rng = np.random.default_rng(3)
        o_r = rng.uniform(-140, 140, size=(R, 3)).astype(np.float32)
        o_r[:, 1] = rng.uniform(35, 60, size=R).astype(np.float32)
        d_r = rng.normal(size=(R, 3)).astype(np.float32)
        d_r[:, 1] = -np.abs(d_r[:, 1]) - 0.2
        d_r /= np.linalg.norm(d_r, axis=1, keepdims=True)
        o_r, d_r = jnp.asarray(o_r), jnp.asarray(d_r)
        from unitysimpleraytracing.utils.profiling import measure_interleaved

        variants = {
            "routed": dict(route=True, compact=None),
            "unrouted": dict(route=False, compact=None),
        }
        if cbvh.num_chunks > 2:  # compact=1 needs chunks after position 1
            variants["routed_compact1"] = dict(route=True, compact=1)
            variants["unrouted_compact1"] = dict(route=False, compact=1)
        fns = {
            k: (lambda kw=kw: chunked_mod.trace_chunked(
                cbvh, o_r, d_r, impl=args.impl, **kw
            ).t.sum())
            for k, kw in variants.items()
        }
        res = measure_interleaved(fns, iters=5, reps=3)
        for k, (med, mn, samples) in res.items():
            out[f"ms_{k}"] = round(med * 1e3, 1)
            print(f"[chunk] random-rays {k}: med {med*1e3:.1f} ms "
                  f"samples={[round(s*1e3,1) for s in samples]}",
                  file=sys.stderr, flush=True)
        out["mrays_per_s"] = round(R / (out["ms_routed"] / 1e3) / 1e6, 2)
        out["rays"] = "random"
        print(json.dumps(out))
        return 0

    def parse_compact(spec):
        if spec == "none":
            return None
        if spec == "auto":
            return "auto"
        return int(spec)

    from unitysimpleraytracing.utils.profiling import measure_interleaved

    specs = args.compact.split(",")
    fns = {
        spec: (lambda c=parse_compact(spec): chunked_mod.render_hits_chunked(
            big, cbvh, cam, impl=args.impl, route=False, compact=c,
        ).t.sum())
        for spec in specs
    }
    # Routed variant interleaved WITH the others (a sequential slope row
    # here would mix methodologies across the drift the others cancel).
    fns["routed"] = lambda: chunked_mod.render_hits_chunked(
        big, cbvh, cam, impl=args.impl, route=True
    ).t.sum()
    # Interleaved amortized rounds: round-robin sampling hits every variant
    # with the same machine state; median-of-rounds compares.
    res = measure_interleaved(fns, iters=6, reps=3)
    out["frame_ms_routed"] = round(res["routed"][0] * 1e3, 1)
    print(f"[chunk] frame routed: {out['frame_ms_routed']} ms (interleaved)",
          file=sys.stderr, flush=True)
    for spec in specs:
        med, mn, samples = res[spec]
        out[f"frame_ms_compact_{spec}"] = round(med * 1e3, 1)
        out[f"frame_ms_min_compact_{spec}"] = round(mn * 1e3, 1)
        out[f"mrays_compact_{spec}"] = round(R / med / 1e6, 2)
        print(f"[chunk] frame compact={spec}: med {med*1e3:.1f} ms / min "
              f"{mn*1e3:.1f} ms ({out[f'mrays_compact_{spec}']} Mrays/s) "
              f"samples={[round(s*1e3,1) for s in samples]}",
              file=sys.stderr, flush=True)
    ref_hits = None
    for spec in specs:
        h = chunked_mod.render_hits_chunked(
            big, cbvh, cam, impl=args.impl, route=False,
            compact=parse_compact(spec),
        )
        if ref_hits is None:
            ref_hits = h
        else:
            # t is order-independent (strict-< fold); tri may differ only on
            # EXACT-t ties (packet re-composition changes traversal order).
            t_eq = bool(np.array_equal(np.asarray(h.t), np.asarray(ref_hits.t)))
            tri_diff = int((np.asarray(h.tri) != np.asarray(ref_hits.tri)).sum())
            out[f"parity_t_{spec}"] = t_eq
            out[f"tri_tie_flips_{spec}"] = tri_diff
            print(f"[chunk] parity {spec}: t_equal={t_eq} "
                  f"tri_flips={tri_diff}", file=sys.stderr, flush=True)
    # Headline = the production default ('auto', which resolves to compaction
    # OFF); fall back to the 'none' variant, NOT the minimum across variants
    # (that could label an oracle-ish best as the production frame time).
    fallback = out.get(
        "frame_ms_compact_none",
        next(v for k, v in out.items() if k.startswith("frame_ms_compact_")),
    )
    out["frame_ms"] = out.get("frame_ms_compact_auto", fallback)
    out["mrays_per_s"] = round(R / (out["frame_ms"] / 1e3) / 1e6, 2)

    if args.oracle:
        # Perfect-knowledge pruning bound: seed every chunk with the FINAL
        # per-ray t.  The production/oracle gap bounds what ANY smarter
        # schedule could recover; the oracle itself is the intrinsic union
        # traversal cost at this chunk granularity.
        from unitysimpleraytracing.ops.dispatch import trace_rays
        from unitysimpleraytracing.pipeline.chunked import (
            _chunk_bvh, _chunk_scene,
        )

        o0, d0 = generate_rays(cam)
        o0 = _tile_major(o0, HEIGHT, WIDTH, 32)
        d0 = _tile_major(d0, HEIGHT, WIDTH, 32)
        t_final = chunked_mod.trace_chunked(
            cbvh, o0, d0, impl=args.impl, route=False
        ).t
        S_, cap_ = cbvh.num_chunks, cbvh.capacity
        impl_o = args.impl

        @jax.jit
        def oracle_frame(t0):
            best = t0
            for s_ in range(S_):
                h = trace_rays(
                    _chunk_scene(cbvh.sscene, s_, cap_),
                    _chunk_bvh(cbvh.bvhs, s_, cap_), o0, d0,
                    impl=impl_o, t_init=best, tables=cbvh.tables[s_],
                )
                best = jnp.minimum(best, h.t)
            return best.sum()

        res_o = measure_interleaved(
            {
                "production": lambda: chunked_mod.trace_chunked(
                    cbvh, o0, d0, impl=args.impl, route=False
                ).t.sum(),
                "oracle": lambda: oracle_frame(t_final),
            },
            iters=6, reps=3,
        )
        out["frame_ms_oracle"] = round(res_o["oracle"][0] * 1e3, 1)
        out["frame_ms_production"] = round(res_o["production"][0] * 1e3, 1)
        out["schedule_headroom_x"] = round(
            res_o["production"][0] / res_o["oracle"][0], 2
        )
        print(f"[chunk] oracle bound: {out['frame_ms_oracle']} ms vs "
              f"production {out['frame_ms_production']} "
              f"(headroom {out['schedule_headroom_x']}x)",
              file=sys.stderr, flush=True)

    if args.per_chunk:
        # Time each chunk's launch separately (static chunk index, real
        # t_init threading) to see where the frame goes.
        from unitysimpleraytracing.ops.dispatch import trace_rays
        from unitysimpleraytracing.pipeline.chunked import (
            _chunk_bvh, _chunk_scene,
        )

        o0, d0 = generate_rays(cam)
        o0 = _tile_major(o0, HEIGHT, WIDTH, 32)
        d0 = _tile_major(d0, HEIGHT, WIDTH, 32)
        eye0 = np.asarray(jnp.mean(o0, axis=0))
        rmin = np.asarray(cbvh.bvhs.node_aabb_min[:, 0])
        rmax = np.asarray(cbvh.bvhs.node_aabb_max[:, 0])
        perm0 = np.argsort(
            np.sum((np.clip(eye0, rmin, rmax) - eye0) ** 2, axis=1)
        )
        impl0 = args.impl
        best_t = jnp.full((R,), rt.constants.MAX_FLOAT, jnp.float32)
        times = []
        for s_ in perm0:
            s_ = int(s_)
            scene_s = _chunk_scene(cbvh.sscene, s_, cbvh.capacity)
            bvh_s = _chunk_bvh(cbvh.bvhs, s_, cbvh.capacity)
            tab = cbvh.tables[s_]
            fn = jax.jit(
                lambda ti, sc=scene_s, bv=bvh_s, tb=tab: trace_rays(
                    sc, bv, o0, d0, impl=impl0, t_init=ti, tables=tb
                ).t
            )
            sec = measure(lambda: fn(best_t), iters=2, reps=4)
            times.append(round(sec * 1e3, 2))
            best_t = jnp.minimum(best_t, fn(best_t))
        out["per_chunk_ms"] = times
        print(f"[chunk] per-chunk ms (schedule order): {times}",
              file=sys.stderr, flush=True)

    # Gate statistics: what fraction of rays could a perfect router skip?
    o, d = generate_rays(cam)
    o = _tile_major(o, HEIGHT, WIDTH, 32)
    d = _tile_major(d, HEIGHT, WIDTH, 32)
    hits = chunked.trace_chunked(cbvh, o, d, impl=args.impl)
    eye = np.asarray(jnp.mean(o, axis=0))
    roots_min = np.asarray(cbvh.bvhs.node_aabb_min[:, 0])
    roots_max = np.asarray(cbvh.bvhs.node_aabb_max[:, 0])
    closest = np.clip(eye, roots_min, roots_max)
    perm = np.argsort(np.sum((closest - eye) ** 2, axis=1))
    o_np, d_np = np.asarray(o), np.asarray(d)
    with np.errstate(divide="ignore", invalid="ignore"):
        inv = 1.0 / d_np[:, None, :]
        t1 = (roots_min[None] - o_np[:, None, :]) * inv
        t2 = (roots_max[None] - o_np[:, None, :]) * inv
    tmin = np.max(np.minimum(t1, t2), axis=2)
    tmax = np.min(np.maximum(t1, t2), axis=2)
    overlap = (tmax > tmin) & (tmax > 0)              # (R, S)
    entry = np.where(overlap, np.maximum(tmin, 0.0), np.inf)
    # Replay the near-first fold on the host to get per-chunk live gates.
    best = np.full(R, np.float32(rt.constants.MAX_FLOAT))
    t_np = np.asarray(hits.t)
    live_frac, packets_live = [], []
    P = 1024
    for s_ in perm:
        gate = entry[:, s_] < best
        live_frac.append(round(float(gate.mean()), 4))
        packets_live.append(
            int(gate.reshape(-1, P).any(axis=1).sum())
        )
        # After tracing chunk s the best can only come from hits in s; replay
        # with the final t as a lower bound (approximates the fold).
        best = np.minimum(best, np.where(t_np <= best, t_np, best))
    out["live_ray_frac_per_chunk"] = live_frac
    out["live_packets_per_chunk"] = packets_live
    out["total_packets"] = R // P
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
