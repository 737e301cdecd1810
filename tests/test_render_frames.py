"""Batched animation rendering (pipeline/render.render_frames).

The batched path flattens F frames into one ray dispatch; it must be
bit-identical to F independent render_frame calls (same packets per frame —
tile-major order is applied per frame before concatenation).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import unitysimpleraytracing as rt


@pytest.fixture(scope="module")
def setup():
    mesh = rt.terrain_mesh(res=12, size=8.0, amplitude=1.5, seed=0)
    scene = rt.build_scene(mesh)
    bvh = rt.build_bvh(scene)
    tex = rt.solid_texture((0.8, 0.7, 0.6, 1.0))
    cams = [
        rt.make_camera(
            eye=(5 * np.cos(a), 4.0, 5 * np.sin(a)), target=(0.0, 0.0, 0.0),
            width=64, height=64,
        )
        for a in (0.1, 1.3, 2.9)
    ]
    stack = jax.tree.map(lambda *xs: jnp.stack(xs), *cams)
    return scene, bvh, tex, cams, stack


@pytest.mark.parametrize("shadows", [False, True])
def test_batched_frames_bit_identical(setup, shadows):
    scene, bvh, tex, cams, stack = setup
    bg = jnp.asarray([0.1, 0.1, 0.12], jnp.float32)
    batched = rt.render_frames(scene, bvh, stack, tex, bg, shadows=shadows)
    assert batched.shape == (len(cams), 64, 64, 4)
    for i, c in enumerate(cams):
        single = rt.render_frame(scene, bvh, c, tex, bg, shadows=shadows)
        np.testing.assert_array_equal(np.asarray(batched[i]), np.asarray(single))


def test_batched_frames_background_image(setup):
    scene, bvh, tex, cams, stack = setup
    rng = np.random.default_rng(3)
    bg = jnp.asarray(rng.uniform(size=(64, 64, 3)), jnp.float32)
    batched = rt.render_frames(scene, bvh, stack, tex, bg)
    single = rt.render_frame(scene, bvh, cams[1], tex, bg)
    np.testing.assert_array_equal(np.asarray(batched[1]), np.asarray(single))


def test_render_frames_chunked_matches_per_frame():
    """Batched chunked animation (render_frames_chunked) is bit-identical to
    per-frame render_frame_chunked calls at packet-aligned frame sizes — one
    chunk-streaming fold covers every frame's rays, paying each chunk's
    launch/table cost once per animation."""
    import jax

    mesh = rt.terrain_mesh(res=24, size=24.0, amplitude=5.0, seed=3)
    scene = rt.build_scene(mesh)
    cbvh = rt.build_bvh_chunked(scene, chunk_capacity=256)
    assert cbvh.num_chunks > 2
    tex = rt.solid_texture((0.8, 0.7, 0.6, 1.0))
    bg = np.asarray([0.1, 0.1, 0.12], np.float32)
    cam_list = [
        rt.make_camera(
            eye=(18 * np.cos(a), 14.0, 18 * np.sin(a)), target=(0, 0, 0),
            width=64, height=64,  # 64*64 = 4 packets: frame-aligned
        )
        for a in (0.3, 1.2, 2.4)
    ]
    cams = jax.tree.map(lambda *xs: jnp.stack(xs), *cam_list)
    got = rt.render_frames_chunked(scene, cbvh, cams, tex, bg, shadows=True)
    assert got.shape == (3, 64, 64, 4)
    for i, cam in enumerate(cam_list):
        want = rt.render_frame_chunked(scene, cbvh, cam, tex, bg, shadows=True)
        np.testing.assert_array_equal(np.asarray(got[i]), np.asarray(want))
