#!/usr/bin/env python3
"""Chip smoke run: the render path end to end on a GPU, checked against the
plain references.

    python chip_smoke.py            # one GPU: every single-card phase
    python chip_smoke.py --cards 4  # four GPUs: the sharded phase only

Single-card phases, at BASELINE's sizes on seeded procedural terrain:

- ``static65k``:  65,522 tris, build_scene → build_bvh → render_frame, 512².
- ``shadows260k``: 260,642 tris, render_frame with shadow rays, 1920×1056
  (plus ``memory_analysis()`` of the compiled frame).
- ``animated65k``: make_animated_renderer, 3 deformed frames.
- ``batched65k``: render_frames over 4 camera poses, 512².
- ``cli1m``: 999,698 tris written as an OBJ and rendered by the CLI
  (its own routing, shadows on), then re-timed in process.

Each phase prints one line: the engine ``auto`` chose, compile seconds, the
steady median ms over ≥10 runs, and its parity result.  Parity compares the
engine with the per-ray XLA reference (``perray``) over the full frame and
with the scalar host traversal (utils/reference_impl) on 256 seeded rays:
identical hit masks, triangle ids equal except at exact-t ties (at most
``TIE_BOUND`` per batch), t within ``T_ULP`` f32 ULPs.  The timed frame
itself is compared, pixel by pixel, with the same frame rendered by
``perray``: at most ``PIXEL_BOUND`` pixels may differ by more than 2/255.
Camera rays come from an f32 matmul at HIGHEST precision, so they match the
CPU goldens rather than TF32.

Exits non-zero when JAX finds no GPU, when run outside a checkout, or when
any phase fails; the last stdout line is the JSON result only on success.
Everything runs in this one process (one JAX process per card).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
# Bounds, each a small multiple of the most seen on an H100 over the
# smoke runs: t at most 2 ULPs apart, at most 3 tied id flips per batch.
T_ULP = 8  # t tolerance, in f32 ULPs
TIE_BOUND = 8  # triangle ids that may differ at equal t (shared-edge ties)
SAMPLE_RAYS = 256
REPS = 10
# Rays, or pixels, that may differ between two programs that each generate
# the camera rays themselves (last-bit ray differences at grazing
# silhouettes, and the shadow rays cast from them).
FLIP_BOUND = 8
PIXEL_BOUND = 64


def _die(msg: str, code: int = 2):
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(code)


def _card() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        ).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        out = f"nvidia-smi unavailable: {e}"
    return out


class Ctx:
    """Shared scenes across phases (built once)."""

    def __init__(self, out_dir):
        self.out_dir = out_dir
        self.cache = {}


def _timed(fn, reps=REPS):
    """(compile seconds of the first call, steady median ms, steady min ms)."""
    import jax
    import numpy as np

    t0 = time.perf_counter()
    jax.block_until_ready(fn())
    first = time.perf_counter() - t0
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return first, float(np.median(ts)) * 1e3, float(np.min(ts)) * 1e3


def _hit_parity(got, ref):
    """Compare two hit records; returns (passed, description)."""
    import numpy as np

    from unitysimpleraytracing import constants as C

    t_g, t_r = np.asarray(got[0]), np.asarray(ref[0])
    tri_g, tri_r = np.asarray(got[1]), np.asarray(ref[1])
    hit_g, hit_r = t_g != C.MAX_FLOAT, t_r != C.MAX_FLOAT
    mask_diff = int(np.sum(hit_g != hit_r))
    both = hit_g & hit_r
    ulp = _ulps(t_g, t_r)
    mism = (tri_g != tri_r) & both
    tied = mism & (ulp <= T_ULP)
    untied = int(np.sum(mism & ~tied))
    n_hit = int(np.sum(hit_r))
    max_ulp = int(ulp[both].max()) if both.any() else 0
    passed = (
        mask_diff == 0 and untied == 0 and int(np.sum(tied)) <= TIE_BOUND
        and max_ulp <= T_ULP
    )
    desc = (
        f"tol(masks equal, t<={T_ULP} ulp, ties<={TIE_BOUND}) "
        f"rays={t_r.size} hits={n_hit} mask_diff={mask_diff} "
        f"tri_ties={int(np.sum(tied))}/{TIE_BOUND} tri_untied={untied} "
        f"t_max_ulp={max_ulp}"
    )
    return passed, desc


def _ulps(a, b):
    """Distance in f32 ULPs between non-negative t values."""
    import numpy as np

    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


def _pixels_vs_perray(frame, fn_perray):
    """The timed frame against the same frame rendered by ``perray``:
    pixels with any channel off by more than 2/255."""
    import numpy as np

    want = np.asarray(fn_perray())
    off = int(np.sum(np.any(np.abs(np.asarray(frame) - want) > 2 / 255, axis=-1)))
    return off <= PIXEL_BOUND, f"vs perray frame: pixels_off={off}/{PIXEL_BOUND}"


def _ray_flips(got, ref):
    """Rays whose hit mask, t (beyond T_ULP) or untied triangle differ."""
    import numpy as np

    far = _ulps(got.t, ref.t) > T_ULP
    differ = (np.asarray(got.hit) != np.asarray(ref.hit)) | (
        np.asarray(ref.hit) & (far | ((np.asarray(got.tri) != np.asarray(ref.tri)) & far))
    )
    return int(np.sum(differ))


def _host_reference(scene, bvh, origins, dirs, idx):
    """Scalar host traversal of the sampled rays (utils/reference_impl)."""
    import numpy as np

    from unitysimpleraytracing.utils.reference_impl import traverse_one_ray

    g = lambda x: np.asarray(x)  # noqa: E731
    tri = scene.triangles
    arrs = (
        g(bvh.node_aabb_min), g(bvh.node_aabb_max), g(bvh.left), g(bvh.right),
        g(bvh.left_is_leaf), g(bvh.right_is_leaf), g(bvh.sorted_tri),
        g(scene.aabb_min), g(scene.aabb_max), g(tri.a), g(tri.b), g(tri.c),
    )
    o, d = g(origins), g(dirs)
    ts, tris = [], []
    for i in idx:
        t, k, _, _ = traverse_one_ray(o[i], d[i], *arrs)
        ts.append(np.float32(t))
        tris.append(int(k))
    return np.asarray(ts, np.float32), np.asarray(tris, np.int32)


def _frame_rays(cam):
    """Camera rays in 32×32 tile-major order, as concrete arrays.  Every
    engine under comparison traces these same arrays: rays generated in
    two differently fused programs can differ in the last bit, and at
    grazing silhouettes that alone flips a hit."""
    import jax

    from unitysimpleraytracing.core.camera import generate_rays
    from unitysimpleraytracing.ops.dispatch import _tile_major

    def tiled():
        o, d = generate_rays(cam)
        return (_tile_major(o, cam.height, cam.width, 32),
                _tile_major(d, cam.height, cam.width, 32))

    return jax.jit(tiled)()


def _check_parity(scene, bvh, o, d, seed, ref_bvh=None):
    """The ``auto`` engine vs ``perray`` on the same rays (full batch) and
    vs the host traversal (256 seeded rays).  ``ref_bvh`` optionally gives
    the references another tree (the nearest hit does not depend on the
    tree, up to exact-t ties).  Returns (passed, description, engine hits,
    perray hits)."""
    import numpy as np

    from unitysimpleraytracing.ops import dispatch

    ref_bvh = bvh if ref_bvh is None else ref_bvh
    hits = dispatch.trace_rays(scene, bvh, o, d)
    ref = dispatch.trace_rays(scene, ref_bvh, o, d, impl="perray")
    ok_full, full = _hit_parity((hits.t, hits.tri), (ref.t, ref.tri))
    rng = np.random.default_rng(seed)
    hit_idx = np.flatnonzero(np.asarray(ref.hit))
    idx = np.concatenate([
        rng.choice(hit_idx, SAMPLE_RAYS // 2, replace=False),
        rng.choice(np.asarray(ref.t).size, SAMPLE_RAYS // 2, replace=False),
    ])
    ht, htri = _host_reference(scene, ref_bvh, o, d, idx)
    ok_host, host = _hit_parity(
        (np.asarray(hits.t)[idx], np.asarray(hits.tri)[idx]), (ht, htri)
    )
    return ok_full and ok_host, f"vs perray [{full}] vs host [{host}]", hits, ref


def _terrain(ctx, res, size, amp, seed):
    import unitysimpleraytracing as rt

    key = ("terrain", res)
    if key not in ctx.cache:
        scene = rt.build_scene(rt.terrain_mesh(res=res, size=size, amplitude=amp, seed=seed))
        t0 = time.perf_counter()
        bvh = rt.build_bvh(scene)
        bvh.node_aabb_min.block_until_ready()
        ctx.cache[key] = (scene, bvh, time.perf_counter() - t0)
    return ctx.cache[key]


def _look(eye, w, h):
    import unitysimpleraytracing as rt

    return rt.make_camera(eye=eye, target=(0.0, 0.0, 0.0), width=w, height=h, fov_deg=60.0)


def _texture_bg():
    import numpy as np

    import unitysimpleraytracing as rt

    return rt.solid_texture((0.8, 0.7, 0.6, 1.0)), np.asarray([0.1, 0.1, 0.12], np.float32)


def _frame_ok(frame, shape):
    import numpy as np

    f = np.asarray(frame)
    return f.shape == shape and bool(np.isfinite(f).all())


def phase_static65k(ctx):
    import unitysimpleraytracing as rt
    from unitysimpleraytracing.ops.dispatch import resolve_impl

    scene, bvh, build_s = _terrain(ctx, 182, 80.0, 9.0, 0)
    cam = _look((55.0, 45.0, 70.0), 512, 512)
    tex, bg = _texture_bg()
    impl = resolve_impl("auto", bvh.capacity)
    fn = lambda: rt.render_frame(scene, bvh, cam, tex, bg)  # noqa: E731
    first, med, mn = _timed(fn)
    frame = fn()
    ok_frame = _frame_ok(frame, (cam.height, cam.width, 4))
    ok_px, px = _pixels_vs_perray(
        frame, lambda: rt.render_frame(scene, bvh, cam, tex, bg, impl="perray")
    )
    ok, par, _, _ = _check_parity(scene, bvh, *_frame_rays(cam), 1)
    ok = ok and ok_px
    return ok and ok_frame, (
        f"tris={scene.count} engine={impl} build_s={build_s:.2f} "
        f"compile_s={first:.2f} steady_ms={med:.3f} (min {mn:.3f}, n={REPS}) "
        f"frame_ok={ok_frame} parity={'PASS' if ok else 'FAIL'} {px} {par}"
    )


def phase_shadows260k(ctx):
    import jax
    import numpy as np

    import unitysimpleraytracing as rt
    from unitysimpleraytracing.ops import dispatch
    from unitysimpleraytracing.pipeline import render

    scene, bvh, build_s = _terrain(ctx, 362, 160.0, 20.0, 1)
    cam = _look((110.0, 90.0, 140.0), 1920, 1056)
    tex, bg = _texture_bg()
    impl = dispatch.resolve_impl("auto", bvh.capacity)
    fn = lambda: rt.render_frame(scene, bvh, cam, tex, bg, shadows=True)  # noqa: E731
    first, med, mn = _timed(fn)
    frame = fn()
    ok_frame = _frame_ok(frame, (cam.height, cam.width, 4))
    ok_px, px = _pixels_vs_perray(
        frame,
        lambda: rt.render_frame(scene, bvh, cam, tex, bg, impl="perray", shadows=True),
    )
    tables = render._prepared(scene, bvh, impl)
    mem = render._render_frame_impl.lower(
        scene, bvh, cam, tex, bg, tables, impl, True
    ).compile().memory_analysis()
    print(f"  shadows260k memory_analysis: {mem}", flush=True)
    o, d = _frame_rays(cam)
    ok, par, _, ref = _check_parity(scene, bvh, o, d, 2)
    # Shadows: one set of shadow rays (from the reference's primary hits)
    # through the engine's any-hit path and through perray's nearest hit;
    # the occlusion booleans must agree.
    so, sd, bound = jax.jit(lambda h: render.shadow_rays(scene, bvh, h, o, d))(ref)
    occ_e = np.asarray(dispatch.occluded(scene, bvh, so, sd, impl=impl, origin_bound=bound))
    occ_r = np.asarray(dispatch.occluded(scene, bvh, so, sd, impl="perray", origin_bound=bound))
    occ_e, occ_r = occ_e & np.asarray(ref.hit), occ_r & np.asarray(ref.hit)
    occ_diff = int(np.sum(occ_e != occ_r))
    ok = ok and ok_px and occ_diff == 0
    return ok and ok_frame, (
        f"tris={scene.count} engine={impl} build_s={build_s:.2f} "
        f"compile_s={first:.2f} steady_ms={med:.3f} (min {mn:.3f}, n={REPS}) "
        f"frame_ok={ok_frame} parity={'PASS' if ok else 'FAIL'} {px} {par} "
        f"shadow_rays={occ_e.size} occluded={int(occ_r.sum())} occlusion_diff={occ_diff}"
    )


def phase_animated65k(ctx):
    import jax
    import jax.numpy as jnp

    import unitysimpleraytracing as rt
    from unitysimpleraytracing.ops.dispatch import resolve_impl

    scene, bvh, _ = _terrain(ctx, 182, 80.0, 9.0, 0)
    cam = _look((55.0, 45.0, 70.0), 512, 512)
    impl = resolve_impl("auto", bvh.capacity)
    t = scene.triangles
    base = jnp.stack([t.a, t.b, t.c], axis=1)
    pos_fn = jax.jit(lambda p: base.at[..., 1].add(0.5 * jnp.sin(base[..., 0] * 0.37 + p)))
    poses = [pos_fn(p) for p in (0.3, 0.6, 0.9)]
    frame = rt.make_animated_renderer(scene, bvh, cam)
    i = [0]

    def step():
        i[0] += 1
        return frame(poses[i[0] % 3]).t

    first, med, mn = _timed(step)
    o, d = _frame_rays(cam)
    oks, descs = [], []
    for k, pos in enumerate(poses):
        s2 = rt.deform_scene(scene, pos)
        b2 = rt.refit_bvh(s2, bvh)
        ok, par, _, _ = _check_parity(s2, b2, o, d, 10 + k)
        # The fused frame itself against the per-frame path on the same
        # deformed scene: both generate their rays in their own programs.
        flips = _ray_flips(frame(pos), rt.render_hits(s2, b2, cam))
        ok_frame = flips <= FLIP_BOUND
        oks.append(ok and ok_frame)
        descs.append(f"frame{k}: {par} fused-vs-render_hits flips={flips}/{FLIP_BOUND}")
    return all(oks), (
        f"tris={scene.count} engine={impl} frames=3 compile_s={first:.2f} "
        f"steady_ms={med:.3f} (min {mn:.3f}, n={REPS}) "
        f"parity={'PASS' if all(oks) else 'FAIL'} " + " | ".join(descs)
    )


def phase_batched65k(ctx):
    import jax
    import jax.numpy as jnp
    import numpy as np

    import unitysimpleraytracing as rt
    from unitysimpleraytracing.cli import orbit_eyes
    from unitysimpleraytracing.ops.dispatch import resolve_impl

    scene, bvh, _ = _terrain(ctx, 182, 80.0, 9.0, 0)
    tex, bg = _texture_bg()
    impl = resolve_impl("auto", bvh.capacity)
    cams = [_look(tuple(e), 512, 512) for e in orbit_eyes((55.0, 45.0, 70.0), (0, 0, 0), 4)]
    stack = jax.tree.map(lambda *xs: jnp.stack(xs), *cams)
    fn = lambda: rt.render_frames(scene, bvh, stack, tex, bg)  # noqa: E731
    first, med, mn = _timed(fn)
    frames = np.asarray(fn())
    ok_frame = _frame_ok(frames, (4, cams[0].height, cams[0].width, 4))
    oks, descs = [], []
    for k, cam in enumerate(cams):
        ok_k, desc = _pixels_vs_perray(
            frames[k], lambda cam=cam: rt.render_frame(scene, bvh, cam, tex, bg, impl="perray")
        )
        oks.append(ok_k)
        descs.append(f"view{k} {desc}")
    ok = all(oks)
    return ok and ok_frame, (
        f"tris={scene.count} engine={impl} views=4 compile_s={first:.2f} "
        f"steady_ms={med:.3f} (min {mn:.3f}, n={REPS}) frame_ok={ok_frame} "
        f"parity={'PASS' if ok else 'FAIL'} " + " ".join(descs)
    )


def _write_obj(path, mesh):
    """Indexed OBJ of a MeshData (shared corners deduplicated)."""
    import numpy as np

    pos = mesh.positions.reshape(-1, 3)
    verts, inv = np.unique(pos, axis=0, return_inverse=True)
    faces = inv.reshape(-1, 3) + 1
    with open(path, "w") as f:
        np.savetxt(f, verts, fmt="v %.9g %.9g %.9g")
        np.savetxt(f, faces, fmt="f %d %d %d")


def phase_cli1m(ctx):
    import numpy as np

    import unitysimpleraytracing as rt
    from unitysimpleraytracing import cli
    from unitysimpleraytracing.io.png import read_png
    from unitysimpleraytracing.ops import dispatch
    from unitysimpleraytracing.ops.dispatch import resolve_impl

    os.makedirs(ctx.out_dir, exist_ok=True)
    obj = os.path.join(ctx.out_dir, "terrain_1m.obj")
    png = os.path.join(ctx.out_dir, "terrain_1m.png")
    _write_obj(obj, rt.terrain_mesh(res=708, size=300.0, amplitude=30.0, seed=0))
    if os.path.exists(png):
        os.remove(png)
    t0 = time.perf_counter()
    cli.main([obj, png, "--shadows", "--platform", "gpu"])
    cli_s = time.perf_counter() - t0
    img = read_png(png)
    ok_png = img.shape[:2] == (480, 640)

    # The same route in process, timed, and its hits checked.
    mesh = rt.load_obj(obj)
    scene = rt.build_scene(mesh)
    n = mesh.num_triangles
    lo, hi = mesh.positions.min(axis=(0, 1)), mesh.positions.max(axis=(0, 1))
    center = (lo + hi) / 2
    eye = center + np.array([0.8, 0.6, 1.2]) * float(np.linalg.norm(hi - lo))
    cam = rt.make_camera(eye=eye, target=center, width=640, height=480, fov_deg=60.0)
    tex, bg = _texture_bg()
    o, d = _frame_rays(cam)
    if cli.use_chunked(n):
        route = "chunked"
        struct = rt.build_bvh_chunked(scene)
        fn = lambda impl="auto": rt.render_frame_chunked(  # noqa: E731
            scene, struct, cam, tex, bg, impl=impl, shadows=True)
        hits = rt.trace_chunked(struct, o, d)
        impl = resolve_impl("auto", struct.capacity)
    else:
        route = "single"
        struct = rt.build_bvh(scene)
        fn = lambda impl="auto": rt.render_frame(  # noqa: E731
            scene, struct, cam, tex, bg, impl=impl, shadows=True)
        hits = dispatch.trace_rays(scene, struct, o, d)
        impl = resolve_impl("auto", struct.capacity)
    first, med, mn = _timed(fn)
    ok_px, px = _pixels_vs_perray(fn(), lambda: fn("perray"))
    # References on the same rays: perray over a karras tree of the same
    # scene (the nearest hit does not depend on the tree, up to exact-t
    # ties) and the host traversal on 256 seeded rays.
    ktree = rt.build_bvh(scene, builder="karras")
    ref = dispatch.trace_rays(scene, ktree, o, d, impl="perray")
    ok_a, par_a = _hit_parity((hits.t, hits.tri), (ref.t, ref.tri))
    rng = np.random.default_rng(3)
    idx = np.concatenate([
        rng.choice(np.flatnonzero(np.asarray(ref.hit)), SAMPLE_RAYS // 2, replace=False),
        rng.choice(o.shape[0], SAMPLE_RAYS // 2, replace=False),
    ])
    ht, htri = _host_reference(scene, ktree, o, d, idx)
    ok_b, par_b = _hit_parity(
        (np.asarray(hits.t)[idx], np.asarray(hits.tri)[idx]), (ht, htri)
    )
    ok = ok_a and ok_b and ok_px
    return ok and ok_png, (
        f"tris={n} route={route} engine={impl} cli_wall_s={cli_s:.1f} png_ok={ok_png} "
        f"compile_s={first:.2f} steady_ms={med:.3f} (min {mn:.3f}, n={REPS}) "
        f"parity={'PASS' if ok else 'FAIL'} {px} vs perray [{par_a}] vs host [{par_b}]"
    )


def phase_sharded4(ctx):
    import jax
    import jax.numpy as jnp
    import numpy as np

    import unitysimpleraytracing as rt
    from unitysimpleraytracing.ops import dispatch
    from unitysimpleraytracing.parallel import dist

    scene = rt.build_scene(rt.terrain_mesh(res=708, size=300.0, amplitude=30.0, seed=0))
    bvh = rt.build_bvh(scene)
    ss = dist.partition_scene(scene, 4)
    mesh = dist.make_mesh(dp=1, tp=4)
    impl = dispatch.resolve_impl("auto", ss.shard_capacity)
    rng = np.random.default_rng(5)
    # BASELINE config 5's 4096-ray batch, skewed: half the rays start over
    # one quadrant of the terrain, all look down and around.
    o = rng.uniform(-150.0, 150.0, size=(4096, 3)).astype(np.float32)
    o[:2048, [0, 2]] = rng.uniform(0.0, 150.0, size=(2048, 2))
    o[:, 1] = 100.0
    d = rng.normal(size=(4096, 3)).astype(np.float32)
    d[:, 1] = -np.abs(d[:, 1]) - 0.3
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    cam = _look((210.0, 160.0, 260.0), 512, 512)
    co, cd = _frame_rays(cam)
    batches = {"batch4096": (jnp.asarray(o), jnp.asarray(d)), "frame512": (co, cd)}
    engines = {
        "gather": dist.render_hits_sharded,
        "ring": dist.render_hits_ring,
        "shuffle": dist.render_hits_shuffle,
    }
    oks, descs = [], []
    for bname, (bo, bd) in batches.items():
        ref = dispatch.trace_rays(scene, bvh, bo, bd)
        for ename, fn in engines.items():
            step = jax.jit(lambda s_, o_, d_, fn=fn: fn(s_, o_, d_, mesh)[:2])
            run = lambda: step(ss, bo, bd)  # noqa: E731
            first, med, _ = _timed(run)
            t, gtri = run()
            ok, par = _hit_parity((t, gtri), (ref.t, ref.tri))
            oks.append(ok)
            descs.append(
                f"{bname}/{ename}: compile_s={first:.2f} steady_ms={med:.3f} "
                f"{'PASS' if ok else 'FAIL'} [{par}]"
            )
    return all(oks), (
        f"tris={scene.count} cards=4 mesh=dp1xtp4 engine={impl} vs one-card "
        f"trace of the same rays (cross-shard ties counted as ties): "
        + " | ".join(descs)
    )


SINGLE = [
    ("static65k", phase_static65k),
    ("shadows260k", phase_shadows260k),
    ("animated65k", phase_animated65k),
    ("batched65k", phase_batched65k),
    ("cli1m", phase_cli1m),
]
FOUR = [("sharded4", phase_sharded4)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, default=1, choices=[1, 4])
    ap.add_argument(
        "--out", default=os.path.join(HERE, ".smoke_out"),
        help="directory for the OBJ and PNG the CLI phase writes",
    )
    args = ap.parse_args(argv)

    if not os.path.isdir(os.path.join(HERE, "unitysimpleraytracing")):
        _die("the unitysimpleraytracing package is not beside this script")
    sys.path.insert(0, HERE)
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        _die(f"JAX found no GPU (platform {devices[0].platform!r})")
    if len(devices) < args.cards:
        _die(f"--cards {args.cards} needs {args.cards} GPUs, JAX found {len(devices)}")

    from unitysimpleraytracing.utils import compile_cache

    compile_cache.enable()
    card = _card()
    print(f"card: {card}", flush=True)
    print(f"jax {jax.__version__} devices={devices}", flush=True)

    phases = FOUR if args.cards == 4 else SINGLE
    ctx = Ctx(args.out)
    failed = []
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            ok, line = fn(ctx)
        except Exception:
            traceback.print_exc()
            ok, line = False, "raised (traceback on stderr)"
        status = "PASS" if ok else "FAIL"
        print(f"phase {name}: {status} wall_s={time.perf_counter() - t0:.1f} {line}", flush=True)
        if not ok:
            failed.append(name)
    if failed:
        _die(f"phases failed: {', '.join(failed)}", code=1)
    print(f"card: {card}")
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": devices[0].platform,
            "kind": devices[0].device_kind,
            "count": len(devices),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
