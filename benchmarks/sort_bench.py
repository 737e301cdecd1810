"""Sort engine head-to-head: the XLA engines of ops/sort.py.

Times `sort_key_val` for each engine over a size sweep and prints one JSON
line per (engine, n).  The production default in ops/sort.py must match the
winner recorded here.

    python benchmarks/sort_bench.py [--sizes 20 22 24] [--engines xla lex2 radix]
"""
from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--sizes", type=int, nargs="+", default=[20, 22, 24],
                   help="log2 key counts")
    p.add_argument("--engines", nargs="+",
                   default=["xla", "packed", "lex2", "radix"])
    p.add_argument("--platform", choices=["gpu", "cpu"], default=None)
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--reps", type=int, default=4)
    p.add_argument("--interleaved", action="store_true",
                   help="drift-robust A/B: one amortized sample per engine "
                   "per round-robin round (utils.profiling.measure_"
                   "interleaved) instead of sequential slope blocks")
    p.add_argument("--chained", type=int, default=0, metavar="K",
                   help="device-time mode: K data-dependent sorts fused in "
                   "ONE jit with an on-device checksum — cancels the "
                   "per-dispatch latency (the build pipeline fuses its sort "
                   "the same way).  Implies --interleaved rounds.")
    args = p.parse_args()

    import jax

    if args.platform:
        jax.config.update("jax_platforms", {"gpu": "cuda"}.get(args.platform, args.platform))
    from unitysimpleraytracing.utils import compile_cache

    compile_cache.enable()

    import jax.numpy as jnp
    import numpy as np

    from unitysimpleraytracing.ops import sort as sort_ops
    from unitysimpleraytracing.utils.profiling import measure

    print(f"[sort_bench] device={jax.devices()[0]}", file=sys.stderr, flush=True)
    rng = np.random.default_rng(0)
    for lg in args.sizes:
        n = 1 << lg
        keys = jnp.asarray(
            rng.integers(0, 1 << 32, size=n, dtype=np.uint64).astype(np.uint32)
        )
        vals = jnp.arange(n, dtype=jnp.int32)
        variants = []
        for eng in args.engines:
            variants.append((eng, jax.jit(
                lambda k, v, e=eng: sort_ops.sort_key_val(k, v, impl=e)[0])))
        if args.chained:
            from unitysimpleraytracing.utils.profiling import (
                measure_interleaved,
            )

            K = args.chained

            def make_chained(eng):
                @jax.jit
                def f(k, v):
                    for _ in range(K):
                        k, v = sort_ops.sort_key_val(k, v, impl=eng)
                        # Data-dependent perturbation so XLA cannot CSE or
                        # dead-code any pass; keys stay ~uniform (v is a
                        # permutation of iota).  Identical for every engine.
                        k = k ^ (v.astype(jnp.uint32) * jnp.uint32(2654435761))
                    return k.sum() + v.astype(jnp.uint32).sum()  # mod-2^32 checksum
                return f

            fns = {
                eng: (lambda f=make_chained(eng): f(keys, vals))
                for eng in args.engines
            }
            res = measure_interleaved(fns, iters=7, warmup=2, reps=2)
            for name, (med, mn, samples) in res.items():
                disp = (max(samples) - min(samples)) / med if med else 0.0
                print(json.dumps({
                    "engine": name, "n": n, "chained": K,
                    "gkeys_per_s": round(n / (med / K) / 1e9, 4),
                    "gkeys_per_s_min": round(n / (mn / K) / 1e9, 4),
                    "ms_per_sort": round(med / K * 1e3, 3),
                    "dispersion": round(disp, 3),
                    "method": f"chained{K}_interleaved",
                }), flush=True)
            continue
        if args.interleaved:
            from unitysimpleraytracing.utils.profiling import (
                measure_interleaved,
            )

            fns = {}
            for name, fn in variants:
                np.testing.assert_array_equal(
                    np.asarray(fn(keys[:4096], vals[:4096])),
                    np.sort(np.asarray(keys[:4096])),
                )
                fns[name] = lambda f=fn: f(keys, vals)
            res = measure_interleaved(fns, iters=7, warmup=2, reps=16)
            for name, (med, mn, samples) in res.items():
                disp = (max(samples) - min(samples)) / med if med else 0.0
                print(json.dumps({
                    "engine": name, "n": n,
                    "gkeys_per_s": round(n / med / 1e9, 4),
                    "gkeys_per_s_min": round(n / mn / 1e9, 4),
                    "ms": round(med * 1e3, 3),
                    "dispersion": round(disp, 3),
                    "method": "interleaved_amortized",
                }), flush=True)
            continue
        for name, fn in variants:
            try:
                np.testing.assert_array_equal(
                    np.asarray(fn(keys[:4096], vals[:4096])),
                    np.sort(np.asarray(keys[:4096])),
                )
                s, method = measure(lambda: fn(keys, vals), iters=args.iters,
                                    reps=args.reps), "slope"
                print(
                    json.dumps(
                        {
                            "engine": name,
                            "n": n,
                            "gkeys_per_s": round(n / s / 1e9, 4),
                            "ms": round(s * 1e3, 3),
                            "method": method,
                        }
                    ),
                    flush=True,
                )
            except Exception as e:  # keep the sweep alive per-engine
                print(json.dumps({"engine": name, "n": n, "error": str(e)[:200]}),
                      flush=True)


if __name__ == "__main__":
    main()
