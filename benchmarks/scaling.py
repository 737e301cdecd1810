"""Rays/s scaling harness — 1 chip → N devices (BASELINE north star: >= 90%
linear scaling with exact hit parity).

Modes:
- strong: fixed total ray count, devices split it (dp), triangles split tp.
- weak:   rays per device fixed; total grows with the mesh.

On real multi-chip hardware this measures true scaling; on a virtual CPU mesh
(XLA_FLAGS=--xla_force_host_platform_device_count=N) the timings are
host-bound and only the parity checks are meaningful — use --smoke for that.

Usage:
    python benchmarks/scaling.py [--devices 1 2 4 8] [--tris 65536]
        [--rays 262144] [--mode strong|weak]
        [--engine ring|gather|shuffle] [--impl auto|gpu|packet|perray]
        [--smoke]

Prints one JSON line per mesh size plus a summary with scaling efficiency.
For the shuffle engine each row also reports ``overlap_fraction`` — the
share of (ray, shard) pairs whose root boxes overlap, i.e. the rows a
ragged exchange would send, over the R×S that the ring circulates and the
shuffle's padded exchange moves (the skew/overlap statistic of the
BASELINE north star).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _fetch(x):
    import jax
    import numpy as np

    return float(np.asarray(jax.tree_util.tree_leaves(x)[0]).ravel()[0])


def _timed(fn, reps=4):
    _fetch(fn())  # warm/compile
    t0 = time.perf_counter()
    r = None
    for _ in range(reps):
        r = fn()
    _fetch(r)
    return (time.perf_counter() - t0) / reps


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, nargs="+", default=None)
    ap.add_argument("--tris", type=int, default=65536)
    ap.add_argument("--rays", type=int, default=262144)
    ap.add_argument("--mode", choices=["strong", "weak"], default="strong")
    ap.add_argument("--engine", choices=["ring", "gather", "shuffle"], default="ring")
    ap.add_argument("--impl", choices=["auto", "gpu", "packet", "perray"],
                    default="auto", help="per-device traversal engine")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny sizes + CPU platform (virtual-mesh CI check)")
    ap.add_argument("--cpu", action="store_true",
                    help="force the 8-virtual-device CPU mesh at FULL sizes "
                    "(parity + overlap_fraction evidence; timings host-bound)")
    ap.add_argument("--out", default=None,
                    help="append result rows to this JSON-lines file")
    ap.add_argument("--reps", type=int, default=4,
                    help="timing reps per row (1 is fine for host-bound "
                    "virtual-mesh rows, where timings are not evidence)")
    args = ap.parse_args(argv)

    if args.smoke or args.cpu:
        os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
        import jax

        jax.config.update("jax_platforms", "cpu")
        if args.smoke:
            args.tris, args.rays = 1024, 4096

    import jax
    import jax.numpy as jnp
    import numpy as np

    import unitysimpleraytracing as rt
    from unitysimpleraytracing.ops import trace
    from unitysimpleraytracing.parallel import dist

    n_avail = len(jax.devices())
    sizes = args.devices or [d for d in (1, 2, 4, 8, 16) if d <= n_avail]

    mesh_data = rt.terrain_mesh(
        res=int((args.tris / 2) ** 0.5) + 1, size=80.0, amplitude=9.0, seed=0
    )
    scene = rt.build_scene(mesh_data)
    rng = np.random.default_rng(0)

    def rays_for(n):
        o = rng.uniform(-40, 40, size=(n, 3)).astype(np.float32)
        o[:, 1] = 50.0  # above the terrain, looking around
        d = rng.normal(size=(n, 3)).astype(np.float32)
        d[:, 1] = -np.abs(d[:, 1]) - 0.3
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        return jnp.asarray(o), jnp.asarray(d)

    results = []
    base_rate = None
    ref_t = None
    for ndev in sizes:
        dp, tp = (ndev, 1) if ndev == 1 else (ndev // 2, 2) if ndev == 2 else (
            ndev // 4, 4
        )
        n_rays = args.rays * (ndev if args.mode == "weak" else 1)
        n_rays = -(-n_rays // (dp * tp)) * (dp * tp)
        origins, dirs = rays_for(n_rays)
        mesh = dist.make_mesh(dp=dp, tp=tp)
        ss = dist.partition_scene(scene, tp)
        render = {
            "ring": dist.render_hits_ring,
            "gather": dist.render_hits_sharded,
            "shuffle": dist.render_hits_shuffle,
        }[args.engine]

        @jax.jit
        def step(ss, o, d):
            return render(ss, o, d, mesh, impl=args.impl)

        sec = _timed(lambda: step(ss, origins, dirs)[0], reps=args.reps)
        rate = n_rays / sec / 1e6
        row = {
            "devices": ndev, "dp": dp, "tp": tp, "rays": n_rays,
            "mrays_per_s": round(rate, 3),
        }
        # A single-point run has no cross-device trend to normalize against:
        # emit baseline: self instead of a vacuous efficiency of 1.0 (the
        # round-3 artifact's full-size rows invited over-reading).
        if len(sizes) == 1:
            row["baseline"] = "self"
        else:
            if base_rate is None:
                base_rate = rate / ndev
            row["scaling_efficiency"] = round(rate / (base_rate * ndev), 4)
        if args.engine == "shuffle":
            # Overlapping (ray, shard) pairs / the R*S pairs.
            o_np, d_np = np.asarray(origins), np.asarray(dirs)
            rmin = np.asarray(ss.range_min)[None]  # (1, S, 3)
            rmax = np.asarray(ss.range_max)[None]
            with np.errstate(divide="ignore", invalid="ignore"):
                inv = 1.0 / d_np[:, None, :]
                t1 = (rmin - o_np[:, None, :]) * inv
                t2 = (rmax - o_np[:, None, :]) * inv
            tmin = np.max(np.minimum(t1, t2), axis=2)
            tmax = np.min(np.maximum(t1, t2), axis=2)
            overlaps = (tmax > tmin) & (tmax > 0)
            row["overlap_fraction"] = round(
                float(overlaps.sum()) / (n_rays * tp), 4
            )
        # Parity check vs single-chip traversal on a subsample: exact for the
        # XLA engines; the GPU kernel's fp contraction differs at ULP
        # level (the BASELINE parity bar — identical hit masks, ULP-bounded t).
        t = np.asarray(step(ss, origins, dirs)[0])
        if ref_t is None or args.mode == "strong":
            bvh = rt.build_bvh(scene)
            sub = slice(0, min(4096, n_rays))
            want = np.asarray(trace.traverse(scene, bvh, origins[sub], dirs[sub]).t)
            got = t[sub]
            if args.impl in ("auto", "gpu"):
                hit = want < rt.constants.MAX_FLOAT
                ok = bool(np.array_equal(got < rt.constants.MAX_FLOAT, hit))
                ok = ok and bool(
                    np.allclose(got[hit], want[hit], rtol=4e-6, atol=0.0)
                )
            else:
                ok = bool(np.array_equal(got, want))
            row["parity"] = ok
        results.append(row)
        print(json.dumps(row), flush=True)

    summary = {
        "metric": "rays_scaling_efficiency",
        "value": (
            results[-1]["scaling_efficiency"]
            if results and "scaling_efficiency" in results[-1]
            else None
        ),
        "unit": "fraction_of_linear",
        "mode": args.mode, "engine": args.engine,
        "tris": args.tris, "rays": args.rays,
        "platform": jax.default_backend(),
        "timings_host_bound": jax.default_backend() == "cpu",
        "parity_all": all(r.get("parity", True) for r in results),
    }
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            for r in results:
                f.write(json.dumps({**r, "engine": args.engine,
                                    "tris": args.tris,
                                    "platform": jax.default_backend()}) + "\n")
            f.write(json.dumps(summary) + "\n")
    return 0 if summary["parity_all"] else 1


if __name__ == "__main__":
    sys.exit(main())
