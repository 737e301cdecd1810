"""Headless CLI: render an OBJ (+ optional PNG texture) to a PNG image.

The reference's only entry point is a Unity MonoBehaviour wired in a scene
(``RaytracingMeshDrawer.cs``); this is the framework-native equivalent:

    python -m unitysimpleraytracing.cli scene.obj out.png \
        --texture tex.png --width 640 --height 480 --eye 3 2 4

Per-frame loop parity: ``--orbit N`` renders an N-frame camera orbit around
the target — the reference re-dispatches the traversal every ``Update()``
against the Awake-built BVH (RaytracingMeshDrawer.cs:76-84); here the packed
kernel tables are likewise built once and reused across frames (the table
cache), and the steady-state per-frame ms is reported.  ``--background-image``
composites over a real image instead of a solid color, the reference's
OnRenderImage blend over the camera's raster frame (ImageComposer.shader:44-53).
"""
from __future__ import annotations

import argparse
import time


def use_chunked(n_tris: int) -> bool:
    """Route a scene through the chunked path (pipeline/chunked.py) only
    past the GPU engine's single-tree id bound: at 1M triangles one tree
    measured far faster than the chunked fold on the H100 (PERF.md)."""
    from unitysimpleraytracing.ops.trace_gpu import MAX_IDS

    return n_tris >= MAX_IDS


def orbit_eyes(eye, target, n: int):
    """Eye positions of an n-frame full-revolution orbit about the target's
    vertical (y) axis, starting at ``eye`` (frame 0 == the static camera)."""
    import numpy as np

    rel = np.asarray(eye, np.float64) - np.asarray(target, np.float64)
    out = []
    for i in range(n):
        ang = 2.0 * np.pi * i / n
        c, s = np.cos(ang), np.sin(ang)
        out.append(
            np.asarray(target)
            + np.array([rel[0] * c + rel[2] * s, rel[1], -rel[0] * s + rel[2] * c])
        )
    return out


def _resize_nearest(img, h: int, w: int):
    """Nearest-neighbor resample of an (H0, W0, C) image to (h, w, C) —
    background plates only (the raster image the traced layer blends over)."""
    import numpy as np

    h0, w0 = img.shape[:2]
    ys = (np.arange(h) * h0 // h).clip(0, h0 - 1)
    xs = (np.arange(w) * w0 // w).clip(0, w0 - 1)
    return img[ys[:, None], xs[None, :]]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="LBVH raytracer")
    ap.add_argument("obj")
    ap.add_argument("out")
    ap.add_argument("--texture", default=None)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--fov", type=float, default=60.0)
    ap.add_argument("--eye", type=float, nargs=3, default=None)
    ap.add_argument("--target", type=float, nargs=3, default=(0.0, 0.0, 0.0))
    ap.add_argument("--background", type=float, nargs=3, default=(0.12, 0.12, 0.15))
    ap.add_argument(
        "--background-image", default=None,
        help="PNG to composite the traced layer over (the reference's "
        "raster frame; resized to the render resolution)",
    )
    ap.add_argument(
        "--orbit-batch", action="store_true",
        help="render the orbit in batched groups (~4M rays per dispatch, "
        "pipeline/render.render_frames): per-frame dispatch overhead "
        "amortizes away; bit-identical frames (needs 32-divisible dims)",
    )
    ap.add_argument(
        "--orbit", type=int, default=0, metavar="N",
        help="render an N-frame camera orbit around the target; frame i is "
        "written to OUT with '_NNN' appended; reports steady-state ms/frame",
    )
    ap.add_argument("--flip-x", action="store_true", help="Unity-style OBJ import")
    ap.add_argument(
        "--subdivide", type=int, default=0,
        help="midpoint-subdivide the mesh N times (4x tris per level) — "
        "turns the reference's real meshes into multi-100K chunked-path "
        "scenes (core/mesh.subdivide_mesh)",
    )
    ap.add_argument(
        "--displace", type=float, default=0.0,
        help="with --subdivide: crack-free smooth displacement amplitude "
        "along normals (a pure function of position)",
    )
    ap.add_argument(
        "--builder", default=None, choices=["karras", "sah", "sah_free"],
        help="BVH topology: 'karras' (the reference's radix tree, "
        "BVH.compute:94-149), 'sah' (sweep SAH over the Morton order — "
        "better splits, same hits) or 'sah_free' (free-order sweep SAH); "
        "default: 'sah_free' for a single tree, 'sah' per chunk",
    )
    ap.add_argument("--shadows", action="store_true", help="shadow-ray pass")
    ap.add_argument(
        "--bvh-cache", default=None, metavar="PATH.npz",
        help="BVH checkpoint: load the prebuilt BVH from PATH if it exists, "
        "else build and save it there (io/checkpoint — the resume path the "
        "reference lacks; it rebuilds every Awake)",
    )
    ap.add_argument(
        "--gizmo", action="store_true",
        help="overlay BVH internal-node AABB wireframes in red "
        "(RaytracingMeshDrawer.OnDrawGizmos:108-115)",
    )
    ap.add_argument(
        "--gizmo-tris", action="store_true",
        help="overlay per-triangle AABB wireframes in white (:98-105)",
    )
    ap.add_argument(
        "--gizmo-index", type=int, default=-1,
        help="draw only this node/triangle index (the reference's "
        "_indexToCheck inspector slider, RaytracingMeshDrawer.cs:11)",
    )
    ap.add_argument(
        "--platform", default="auto", choices=["auto", "cpu", "gpu"],
        help="force the JAX platform",
    )
    args = ap.parse_args(argv)

    import jax

    if args.platform != "auto":
        jax.config.update("jax_platforms", {"gpu": "cuda"}.get(args.platform, args.platform))
    from unitysimpleraytracing.utils import compile_cache

    compile_cache.enable()  # repeat invocations skip the first compile

    import numpy as np

    import unitysimpleraytracing as rt
    from unitysimpleraytracing.io.png import read_png, write_png

    t0 = time.perf_counter()
    mesh = rt.load_obj(args.obj, flip_x=args.flip_x)
    if args.subdivide:
        mesh = rt.subdivide_mesh(
            mesh, levels=args.subdivide, displace=args.displace
        )
    print(f"loaded {mesh.num_triangles} triangles in {time.perf_counter()-t0:.2f}s")

    scene = rt.build_scene(mesh)
    chunked = use_chunked(mesh.num_triangles)
    t0 = time.perf_counter()
    import os

    from unitysimpleraytracing.io import checkpoint as ckpt

    if chunked:
        if args.bvh_cache and os.path.exists(args.bvh_cache):
            cbvh = ckpt.load_chunked_checkpoint(args.bvh_cache)
            print(f"chunked BVH restored ({cbvh.num_chunks} chunks) from "
                  f"{args.bvh_cache} in {time.perf_counter()-t0:.3f}s")
        else:
            cbvh = rt.build_bvh_chunked(scene, builder=args.builder)
            cbvh.bvhs.node_aabb_min.block_until_ready()
            print(f"chunked BVH built ({cbvh.num_chunks} chunks) "
                  f"in {time.perf_counter()-t0:.3f}s")
            if args.bvh_cache:
                ckpt.save_chunked_checkpoint(args.bvh_cache, cbvh)
                print(f"saved {args.bvh_cache}")
        bvh = None
    else:
        if args.bvh_cache and os.path.exists(args.bvh_cache):
            scene, bvh = ckpt.load_checkpoint(args.bvh_cache)
            print(f"BVH restored from {args.bvh_cache} "
                  f"in {time.perf_counter()-t0:.3f}s")
        else:
            bvh = rt.build_bvh(scene, builder=args.builder)
            bvh.node_aabb_min.block_until_ready()
            print(f"BVH built in {time.perf_counter()-t0:.3f}s")
            if args.bvh_cache:
                ckpt.save_checkpoint(args.bvh_cache, scene, bvh)
                print(f"saved {args.bvh_cache}")

    lo = mesh.positions.min(axis=(0, 1))
    hi = mesh.positions.max(axis=(0, 1))
    center = (lo + hi) / 2
    diag = float(np.linalg.norm(hi - lo))
    if args.eye is None:
        eye = center + np.array([0.8, 0.6, 1.2]) * diag
        target = center
    else:
        eye, target = np.asarray(args.eye, np.float64), np.asarray(args.target)

    tex = rt.load_texture(args.texture) if args.texture else rt.solid_texture((0.8, 0.8, 0.8, 1.0))
    if args.background_image:
        bg_img = read_png(args.background_image).astype(np.float32) / 255.0
        background = np.ascontiguousarray(
            _resize_nearest(bg_img[..., :3], args.height, args.width)[::-1]
        )  # file is top-down; frames are bottom-up (UAV orientation)
    else:
        background = np.asarray(args.background, np.float32)

    def cam_at(eye_pos):
        return rt.make_camera(
            eye=eye_pos, target=target,
            width=args.width, height=args.height, fov_deg=args.fov,
        )

    def do_frame(cam):
        if chunked:
            return rt.render_frame_chunked(
                scene, cbvh, cam, tex, background, shadows=args.shadows
            )
        return rt.render_frame(scene, bvh, cam, tex, background, shadows=args.shadows)

    def overlay(frame, cam):
        img = rt.frame_to_image(frame)
        if not (args.gizmo or args.gizmo_tris):
            return img
        from unitysimpleraytracing.utils.visualize import draw_aabbs

        over = np.asarray(frame)
        sel = (
            slice(None)
            if args.gizmo_index < 0
            else slice(args.gizmo_index, args.gizmo_index + 1)
        )
        if args.gizmo_tris:  # per-triangle boxes, default (white) color
            over = draw_aabbs(
                over, cam,
                np.asarray(scene.aabb_min)[: scene.count][sel],
                np.asarray(scene.aabb_max)[: scene.count][sel],
                color=(1.0, 1.0, 1.0),
            )
        if args.gizmo and bvh is not None:  # internal nodes, red
            over = draw_aabbs(
                over, cam,
                np.asarray(bvh.node_aabb_min)[: bvh.num_internal][sel],
                np.asarray(bvh.node_aabb_max)[: bvh.num_internal][sel],
                color=(1.0, 0.0, 0.0),
            )
        return over[::-1]

    if args.orbit <= 0:
        cam = cam_at(eye)
        t0 = time.perf_counter()
        frame = do_frame(cam)
        frame.block_until_ready()
        dt = time.perf_counter() - t0
        mrays = args.width * args.height / dt / 1e6
        print(f"rendered {args.width}x{args.height} in {dt:.3f}s ({mrays:.2f} Mrays/s, cold)")
        write_png(args.out, overlay(frame, cam))
        print(f"wrote {args.out}")
        return

    # Camera orbit: rotate the eye about the target's vertical axis, one
    # full revolution over N frames — the reference's per-frame Update loop.
    stem, dot, ext = args.out.rpartition(".")
    stem = stem or args.out
    times = []
    batchable = (
        args.orbit_batch
        and args.width % 32 == 0 and args.height % 32 == 0
    )
    if args.orbit_batch and not batchable:
        print("orbit-batch needs 32-divisible dims; "
              "falling back to the per-frame loop")
    if batchable:
        # Batched throughput mode: groups of frames flatten into ONE ray
        # dispatch each (pipeline/render.render_frames; past the single-
        # kernel capacity, render_frames_chunked — every frame's rays share
        # one chunk-streaming fold) — per-frame host and dispatch overhead
        # amortizes away.  Solid-color or image plate both work ((3,) or
        # (H,W,3) background).
        import jax
        import jax.numpy as jnp

        eyes = list(orbit_eyes(eye, target, args.orbit))
        group = max(1, (1 << 22) // (args.width * args.height))  # ~4M rays
        idx = 0
        for lo in range(0, args.orbit, group):
            cams = [cam_at(e) for e in eyes[lo:lo + group]]
            stack = jax.tree.map(lambda *xs: jnp.stack(xs), *cams)
            t0 = time.perf_counter()
            if chunked:
                batch = rt.render_frames_chunked(
                    scene, cbvh, stack, tex, background, shadows=args.shadows
                )
            else:
                batch = rt.render_frames(
                    scene, bvh, stack, tex, background, shadows=args.shadows
                )
            batch.block_until_ready()
            times.append((time.perf_counter() - t0) / len(cams))
            # PNGs written (and frames pulled to host) per group so device
            # memory holds at most one group of frames alongside the tables —
            # long 1080p orbits would otherwise accumulate ~32 MB/frame.
            for frame, cam in zip(np.asarray(batch), cams):
                write_png(f"{stem}_{idx:03d}.{ext or 'png'}", overlay(frame, cam))
                idx += 1
        if len(times) == 1:
            print("orbit-batch: single group — steady ms/frame below is "
                  "compile-inclusive (no warm group to exclude)")
    else:
        for i, eye_i in enumerate(orbit_eyes(eye, target, args.orbit)):
            cam = cam_at(eye_i)
            t0 = time.perf_counter()
            frame = do_frame(cam)
            frame.block_until_ready()
            times.append(time.perf_counter() - t0)
            path = f"{stem}_{i:03d}.{ext or 'png'}"
            write_png(path, overlay(frame, cam))
    steady = float(np.median(times[1:])) if len(times) > 1 else times[0]
    print(
        f"orbit {args.orbit} frames {args.width}x{args.height}: "
        f"cold {times[0]*1e3:.1f} ms, steady {steady*1e3:.1f} ms/frame "
        f"({args.width*args.height/steady/1e6:.2f} Mrays/s)"
    )
    print(f"wrote {stem}_000.{ext or 'png'} .. {stem}_{args.orbit-1:03d}.{ext or 'png'}")


if __name__ == "__main__":
    main()
