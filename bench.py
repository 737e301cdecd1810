"""Headline benchmark: traversal Mrays/s + every BASELINE config.

Prints ONE JSON line:
    {"metric": "traversal_mrays_per_s_per_chip", "value": N, "unit": "Mrays/s",
     "extra": {...}}

Covered configs (BASELINE.md):
- config 2 (headline): ~65K-tri terrain, 512x512 primary rays.
- config 3: ~260K-tri terrain, 1920x1056 + shadow rays.
- config 4: dynamic per-frame deform -> full re-sort + rebuild Hz, the
  refit-only fast path Hz, and the fused animated render Hz.
- build: LBVH ms at 65K AND ~1M tris; chunked 1M trace; sort engines
  head-to-head (Gkeys/s).
"""
from __future__ import annotations

import json
import sys

import numpy as np

WIDTH = HEIGHT = 512
TERRAIN_RES = 182        # 2*(res-1)^2 = 65,522 triangles (config 2)
SPONZA_RES = 362         # 260,642 triangles (config 3 class)
BIG_RES = 708            # 999,698 triangles (config 5 build bound)
SORT_N = 1 << 22


def _note(msg):
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def main() -> None:
    import jax

    from unitysimpleraytracing.utils import compile_cache

    compile_cache.enable()

    import jax.numpy as jnp

    import unitysimpleraytracing as rt
    from unitysimpleraytracing.ops import sort as sort_ops
    from unitysimpleraytracing.pipeline.build import deform_scene
    from unitysimpleraytracing.utils.profiling import measure

    dev = jax.devices()[0]
    extra = {"device": {"platform": dev.platform, "kind": dev.device_kind,
                        "count": len(jax.devices())}}

    # ---- config 2 headline: 65K terrain, 512x512 --------------------------
    mesh = rt.terrain_mesh(res=TERRAIN_RES, size=80.0, amplitude=9.0, seed=0)
    scene = rt.build_scene(mesh)
    n_tris = mesh.num_triangles
    cam = rt.make_camera(
        eye=(55.0, 45.0, 70.0), target=(0.0, 0.0, 0.0),
        width=WIDTH, height=HEIGHT, fov_deg=60.0,
    )
    _note("scene ready")

    # Build-SPEED metric stays on the karras radix tree (the LBVH algorithm,
    # round-over-round comparable); the traversal rows below use build_bvh's
    # measured DEFAULT (sweep-SAH for concrete static scenes).
    build_s = measure(lambda: rt.build_bvh(scene, builder="karras"), iters=3)
    _note(f"build 65K (karras): {build_s*1e3:.2f} ms")
    sah_build_s = measure(lambda: rt.build_bvh(scene), iters=3)
    _note(f"build 65K (default quality builder): {sah_build_s*1e3:.2f} ms")
    bvh = rt.build_bvh(scene)

    from unitysimpleraytracing.ops.dispatch import resolve_impl
    from unitysimpleraytracing.utils.profiling import measure_interleaved

    def robust_row(fn, reps=16, iters=7):
        """Amortized round-robin rounds: (median_s, min_s); each sample
        includes 1/reps of the fixed dispatch latency — a method-tagged
        overestimate."""
        med, mn, _ = measure_interleaved({"x": fn}, iters=iters, reps=reps)["x"]
        return med, mn

    trace_s, trace_s_min = robust_row(
        lambda: rt.render_hits(scene, bvh, cam).t.sum()
    )
    # Slope-median estimate alongside (cancels the fixed dispatch latency).
    trace_slope_s = measure(lambda: rt.render_hits(scene, bvh, cam).t.sum())
    mrays = WIDTH * HEIGHT / trace_s / 1e6
    engine = resolve_impl("auto", bvh.capacity)
    _note(f"trace[{engine}]: {trace_s*1e3:.2f} ms = {mrays:.2f} Mrays/s "
          f"(amortized; fast-phase {WIDTH*HEIGHT/trace_s_min/1e6:.2f}; "
          f"device-slope {WIDTH*HEIGHT/trace_slope_s/1e6:.2f})")
    hit_frac = float(rt.render_hits(scene, bvh, cam).hit.mean())
    extra.update(
        n_tris=n_tris, rays=WIDTH * HEIGHT, hit_frac=round(hit_frac, 4),
        lbvh_build_ms=round(build_s * 1e3, 3),
        sah_build_ms=round(sah_build_s * 1e3, 3),
        traversal_engine=engine, builder="sah_free",
        headline_method="interleaved_amortized_reps16",
        headline_mrays_fast_phase=round(WIDTH * HEIGHT / trace_s_min / 1e6, 2),
        headline_mrays_device_slope=round(
            WIDTH * HEIGHT / trace_slope_s / 1e6, 2
        ),
    )

    # Builder contrast: the karras radix tree (the reference's algorithm,
    # the bit-parity surface, and the traced/dynamic default), same engine —
    # same-session amortized contrast with the headline above.
    try:
        sbvh_k = rt.build_bvh(scene, builder="karras")
        s_k, _ = robust_row(lambda: rt.render_hits(scene, sbvh_k, cam).t.sum())
        extra["headline_karras_mrays"] = round(WIDTH * HEIGHT / s_k / 1e6, 2)
        _note(f"trace[karras tree]: {extra['headline_karras_mrays']} Mrays/s")
        del sbvh_k
    except Exception as e:
        _note(f"karras headline skipped: {e}")

    # ---- config 4: dynamic deform -> rebuild / refit ----------------------
    try:
        t = scene.triangles
        base = jnp.stack([t.a, t.b, t.c], axis=1)

        @jax.jit
        def dyn_rebuild(phase):
            pos = base.at[..., 1].add(0.5 * jnp.sin(base[..., 0] * 0.37 + phase))
            return rt.build_bvh(deform_scene(scene, pos)).node_aabb_min

        @jax.jit
        def dyn_refit(phase):
            pos = base.at[..., 1].add(0.5 * jnp.sin(base[..., 0] * 0.37 + phase))
            return rt.refit_bvh(deform_scene(scene, pos), bvh).node_aabb_min

        extra["dynamic_rebuild_hz"] = round(1.0 / measure(lambda: dyn_rebuild(0.7), iters=2), 1)
        extra["dynamic_refit_hz"] = round(1.0 / measure(lambda: dyn_refit(0.7), iters=2), 1)
        _note(f"dynamic rebuild {extra['dynamic_rebuild_hz']} Hz, "
              f"refit {extra['dynamic_refit_hz']} Hz")

        # Full animated RENDER loop (the reference renders every frame):
        # ONE jitted program per frame running deform -> refit -> BVH4 table
        # slot-update -> trace (make_animated_renderer): the topology plan is
        # computed once, each frame repays only the geometry gathers, and the
        # whole frame is a single dispatch.
        anim = rt.make_animated_renderer(scene, bvh, cam)
        pos_fn = jax.jit(
            lambda phase: base.at[..., 1].add(
                0.5 * jnp.sin(base[..., 0] * 0.37 + phase)
            )
        )

        def dyn_frame(phase):
            return anim(pos_fn(phase)).t

        extra["dynamic_render_hz"] = round(
            1.0 / measure(lambda: dyn_frame(0.9), iters=2), 1
        )
        _note(f"dynamic render {extra['dynamic_render_hz']} Hz")
    except Exception as e:
        _note(f"dynamic skipped: {e}")

    # ---- build + chunked trace at ~1M tris (config 5, single chip) --------
    try:
        big = rt.build_scene(
            rt.terrain_mesh(res=BIG_RES, size=300.0, amplitude=30.0, seed=0)
        )
        s = measure(lambda: rt.build_bvh(big, builder="karras"), iters=2, reps=4)
        extra["lbvh_build_1m_ms"] = round(s * 1e3, 2)
        extra["n_tris_1m"] = big.count
        _note(f"build 1M: {s*1e3:.1f} ms")

        # The chunked path: per-chunk tables through successive launches.
        bcam = rt.make_camera(
            eye=(210.0, 170.0, 260.0), target=(0.0, 0.0, 0.0),
            width=WIDTH, height=HEIGHT, fov_deg=60.0,
        )
        cbvh = rt.build_bvh_chunked(big)
        s = measure(
            lambda: rt.render_hits_chunked(big, cbvh, bcam).t, iters=2, reps=4
        )
        extra["chunked_1m_mrays"] = round(WIDTH * HEIGHT / s / 1e6, 2)
        extra["chunked_1m_chunks"] = cbvh.num_chunks
        extra["chunked_1m_builder"] = "sah"
        _note(f"chunked 1M trace: {extra['chunked_1m_mrays']} Mrays/s")
        del big, cbvh
    except Exception as e:
        _note(f"1M build/trace skipped: {e}")

    # ---- sort engines head-to-head ----------------------------------------
    rng = np.random.default_rng(0)
    keys = jnp.asarray(
        rng.integers(0, 1 << 32, size=SORT_N, dtype=np.uint64).astype(np.uint32)
    )
    vals = jnp.arange(SORT_N, dtype=jnp.int32)
    extra["sort_n"] = SORT_N
    # K data-dependent sorts fused in ONE jit with a scalar on-device
    # checksum (the build pipeline fuses its sort the same way), sampled in
    # interleaved rounds.
    K_CHAIN = 8

    def chained_sort(eng):
        @jax.jit
        def f(k, v):
            for _ in range(K_CHAIN):
                k, v = sort_ops.sort_key_val(k, v, impl=eng)
                k = k ^ (v.astype(jnp.uint32) * jnp.uint32(2654435761))
            return k.sum() + v.astype(jnp.uint32).sum()
        return lambda: f(keys, vals)

    try:
        res = measure_interleaved(
            {eng: chained_sort(eng) for eng in ("lex2", "packed", "xla")},
            iters=7, warmup=2, reps=2,
        )
        for eng, (med, _, _) in res.items():
            val = SORT_N / (med / K_CHAIN) / 1e9
            extra[f"sort_gkeys_{eng}"] = round(val, 4)
            extra[f"sort_gkeys_{eng}_method"] = f"chained{K_CHAIN}_interleaved"
            _note(f"sort[{eng}]: {extra[f'sort_gkeys_{eng}']} Gkeys/s (chained)")
    except Exception as e:
        _note(f"chained sort rows skipped: {e}")
    # Headline = the build pipeline's production engine (lex2).
    extra["sort_gkeys_per_s"] = extra.get(
        "sort_gkeys_lex2", extra.get("sort_gkeys_xla", 0.0)
    )

    # ---- config 3: 260K tris, 1080p-class + shadows ----------------------
    try:
        smesh = rt.terrain_mesh(res=SPONZA_RES, size=160.0, amplitude=20.0, seed=1)
        sscene = rt.build_scene(smesh)
        sbvh = rt.build_bvh(sscene)
        scam = rt.make_camera(
            eye=(110.0, 90.0, 140.0), target=(0.0, 0.0, 0.0),
            width=1920, height=1056, fov_deg=60.0,
        )
        tex = rt.solid_texture((0.8, 0.7, 0.6, 1.0))
        bg = np.asarray([0.1, 0.1, 0.12], np.float32)

        # Same-session A/B vs the JUNK miss-pixel shadow rays: identical
        # output, both times recorded, sampled in interleaved rounds.
        res = measure_interleaved(
            {
                "subst": lambda: rt.render_frame(
                    sscene, sbvh, scam, tex, bg, shadows=True
                ).sum(),
                "junk": lambda: rt.render_frame(
                    sscene, sbvh, scam, tex, bg, shadows=True,
                    shadow_substitute=False,
                ).sum(),
            },
            iters=5, reps=2,
        )
        s, s_junk = res["subst"][0], res["junk"][0]
        s_min, s_junk_min = res["subst"][1], res["junk"][1]
        # shadows => ~2 trace passes per pixel
        extra["sponza_class"] = {
            "n_tris": sscene.count,
            "res": "1920x1056",
            "shadows": True,
            "engine": resolve_impl("auto", sbvh.capacity),
            "frame_ms": round(s * 1e3, 1),
            "frame_ms_junk": round(s_junk * 1e3, 1),
            "frame_ms_min": round(s_min * 1e3, 1),
            "frame_ms_junk_min": round(s_junk_min * 1e3, 1),
            "subst_speedup": round(s_junk / s, 2),
            "mrays_per_s": round(2 * 1920 * 1056 / s / 1e6, 2),
            "mrays_per_s_fast_phase": round(2 * 1920 * 1056 / s_min / 1e6, 2),
        }
        _note(f"260K+shadows 1080p: {extra['sponza_class']}")
    except Exception as e:
        _note(f"sponza-class skipped: {e}")

    print(
        json.dumps(
            {
                "metric": "traversal_mrays_per_s_per_chip",
                "value": round(mrays, 3),
                "unit": "Mrays/s",
                "extra": extra,
            }
        )
    )


if __name__ == "__main__":
    main()
