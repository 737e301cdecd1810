"""End-to-end: camera → build → render → shade → compose (+ IO roundtrips)."""
import os

import jax.numpy as jnp
import numpy as np

from unitysimpleraytracing import (
    build_bvh,
    build_scene,
    cube_mesh,
    frame_to_image,
    make_camera,
    render_frame,
    render_hits,
    render_rgba,
    solid_texture,
    texture_from_array,
)
from unitysimpleraytracing.core.camera import generate_rays
from unitysimpleraytracing.core.texture import sample_bilinear
from unitysimpleraytracing.io.png import read_png, write_png


def _cube_setup(w=64, h=48):
    mesh = cube_mesh(size=2.0)
    scene = build_scene(mesh)
    bvh = build_bvh(scene)
    cam = make_camera(eye=(3, 2.5, 4), target=(0, 0, 0), width=w, height=h, fov_deg=60)
    return scene, bvh, cam


def test_camera_rays_shape_and_norm():
    cam = make_camera(eye=(0, 0, 5), target=(0, 0, 0), width=32, height=16)
    origins, dirs = generate_rays(cam)
    assert origins.shape == (512, 3) and dirs.shape == (512, 3)
    np.testing.assert_allclose(np.linalg.norm(np.asarray(dirs), axis=1), 1.0, atol=1e-6)
    # Center ray of the frame points at the target.
    center = np.asarray(dirs).reshape(16, 32, 3)[8, 16]
    np.testing.assert_allclose(center, [0, 0, -1], atol=0.05)


def test_cube_renders_hits_in_center_and_misses_at_border():
    scene, bvh, cam = _cube_setup()
    hits = render_hits(scene, bvh, cam)
    mask = np.asarray(hits.hit).reshape(cam.height, cam.width)
    assert mask[cam.height // 2, cam.width // 2]  # cube in view center
    assert not mask[0, 0] and not mask[-1, -1]    # background at corners
    assert 0.05 < mask.mean() < 0.95


def test_render_frame_composites_background():
    scene, bvh, cam = _cube_setup()
    tex = solid_texture((1.0, 0.0, 0.0, 1.0))
    bg = jnp.asarray([0.0, 0.0, 1.0], jnp.float32)
    frame = np.asarray(render_frame(scene, bvh, cam, tex, bg))
    rgba = np.asarray(render_rgba(scene, bvh, cam, tex))
    hit = rgba[..., 3] > 0
    assert frame.shape == (cam.height, cam.width, 4)
    np.testing.assert_allclose(frame[..., 3], 1.0)
    # Misses show pure background, hits show shaded red.
    np.testing.assert_allclose(frame[~hit][:, 2], 1.0)
    np.testing.assert_allclose(frame[~hit][:, 0], 0.0)
    assert np.all(frame[hit][:, 0] >= 0.4 - 1e-6)  # max(0.4, ...) floor
    np.testing.assert_allclose(frame[hit][:, 2], 0.0)


def test_shading_lambert_floor_and_range():
    scene, bvh, cam = _cube_setup()
    tex = solid_texture((1.0, 1.0, 1.0, 1.0))
    rgba = np.asarray(render_rgba(scene, bvh, cam, tex))
    hit = rgba[..., 3] > 0
    vals = rgba[hit][:, 0]
    assert np.all(vals >= 0.4 - 1e-6)
    assert np.all(vals <= np.sqrt(3) + 1e-5)  # max possible: sum(n)=sqrt(3)


def test_png_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, size=(33, 47, 3), dtype=np.uint8)
    p = os.path.join(tmp_path, "x.png")
    write_png(p, img)
    back = read_png(p)
    np.testing.assert_array_equal(img, back)


def test_png_pure_decoder_matches_pil(tmp_path):
    from unitysimpleraytracing.io.png import _read_png_pure

    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, size=(16, 24, 4), dtype=np.uint8)
    p = os.path.join(tmp_path, "y.png")
    write_png(p, img)
    np.testing.assert_array_equal(_read_png_pure(p), read_png(p))


def test_bilinear_sampling_interpolates():
    img = np.zeros((2, 2, 4), np.float32)
    img[0, 0] = [0, 0, 0, 1]
    img[0, 1] = [1, 0, 0, 1]
    img[1, 0] = [0, 1, 0, 1]
    img[1, 1] = [1, 1, 0, 1]
    from unitysimpleraytracing.core.texture import Texture

    tex = Texture(data=jnp.asarray(img))
    # Sample dead center: average of all four texels.
    out = np.asarray(sample_bilinear(tex, jnp.asarray([0.5]), jnp.asarray([0.5])))
    np.testing.assert_allclose(out[0, :2], [0.5, 0.5], atol=1e-6)
    # Clamp addressing beyond the edge.
    out = np.asarray(sample_bilinear(tex, jnp.asarray([-3.0]), jnp.asarray([-3.0])))
    np.testing.assert_allclose(out[0, :3], img[0, 0, :3], atol=1e-6)


def test_frame_to_image_flips_rows():
    scene, bvh, cam = _cube_setup(w=16, h=16)
    tex = solid_texture()
    frame = render_frame(scene, bvh, cam, tex, jnp.asarray([0.0, 0.0, 0.0]))
    img = frame_to_image(frame)
    np.testing.assert_array_equal(img, np.asarray(frame)[::-1])


def test_capacity_contract_raises_typed_error(monkeypatch):
    """The library path must never silently fall back to a slower engine on
    a GPU: auto at the GPU engine's id bound raises CapacityError pointing
    at the chunked path (the reference's analog: a hard, explicit 524 288
    capacity, Constants.cs:3-6).  Explicit engines remain available."""
    import pytest

    from unitysimpleraytracing.ops import dispatch, trace_gpu

    monkeypatch.setattr(dispatch.jax, "default_backend", lambda: "gpu")
    cap = trace_gpu.MAX_IDS
    with pytest.raises(dispatch.CapacityError, match="chunked"):
        dispatch.resolve_impl("auto", cap)
    assert dispatch.resolve_impl("auto", 65_000) == "gpu"
    assert dispatch.resolve_impl("auto", cap - 1) == "gpu"
    assert dispatch.resolve_impl("packet", cap) == "packet"

    # render_frame surfaces the same typed error before any device work.
    import unitysimpleraytracing as rt

    z1 = jnp.zeros((cap,), jnp.int32)
    zb = jnp.zeros((cap,), bool)
    z3 = jnp.zeros((cap, 3), jnp.float32)
    bvh = rt.Bvh(
        left=z1, right=z1, left_is_leaf=zb, right_is_leaf=zb,
        internal_parent=z1, leaf_parent=z1, range_first=z1, range_last=z1,
        split_axis=z1, node_aabb_min=z3, node_aabb_max=z3, sorted_tri=z1,
        depth=z1, count=cap,
    )
    scene = rt.build_scene(rt.cube_mesh(size=1.0))
    cam = rt.make_camera(eye=(0, 0, 3), target=(0, 0, 0), width=32, height=32)
    tex = rt.solid_texture((1, 1, 1, 1))
    with pytest.raises(dispatch.CapacityError):
        rt.render_frame(scene, bvh, cam, tex, np.zeros(3, np.float32))


def test_subdivide_mesh_watertight_and_counts():
    """Midpoint subdivision: 4x triangles per level, linear uv/normal
    interpolation, and the displacement field is a pure function of position
    (shared corners displace identically — no cracks)."""
    import unitysimpleraytracing as rt

    base = rt.cube_mesh(size=2.0)
    s1 = rt.subdivide_mesh(base, levels=1)
    assert s1.num_triangles == base.num_triangles * 4
    # Surface area is preserved by pure midpoint splits.
    def area(m):
        e1 = m.positions[:, 1] - m.positions[:, 0]
        e2 = m.positions[:, 2] - m.positions[:, 0]
        return float(np.linalg.norm(np.cross(e1, e2), axis=1).sum() / 2)
    np.testing.assert_allclose(area(s1), area(base), rtol=1e-5)
    # Displaced: corners at the same PRE-displacement position must land at
    # the same place (grouping keys come from the undisplaced mesh, so a
    # crack — shared corners moving apart — fails this; the cube's hard
    # per-face normals make it the adversarial fixture).
    s2 = rt.subdivide_mesh(base, levels=2)
    sd = rt.subdivide_mesh(base, levels=2, displace=0.1)
    pre = s2.positions.reshape(-1, 3)
    post = sd.positions.reshape(-1, 3)
    _, inv_idx = np.unique(np.round(pre, 5), axis=0, return_inverse=True)
    inv_idx = inv_idx.ravel()
    for g in range(inv_idx.max() + 1):
        rows = post[inv_idx == g]
        assert np.allclose(rows, rows[0], atol=1e-6), "surface cracked"
    # And the displacement actually moved the surface.
    assert np.abs(post - pre).max() > 0.01
