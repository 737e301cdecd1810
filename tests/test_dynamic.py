"""Dynamic-scene path (refit-only updates) and shadow rays — capabilities
beyond the reference (BASELINE.json configs 3-4)."""
import jax.numpy as jnp
import numpy as np

import unitysimpleraytracing as rt
from unitysimpleraytracing.ops import trace


def _rays(n, seed, bound=8.0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-bound, bound, size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d)


def test_refit_after_deform_matches_brute_force():
    mesh = rt.random_triangle_soup(200, seed=4, bound=5.0, tri_size=1.0)
    scene = rt.build_scene(mesh)
    bvh = rt.build_bvh(scene)

    # Deform: nonuniform squash + drift (topology/sort order kept stale).
    pos = mesh.positions * np.array([1.3, 0.7, 1.0], np.float32) + 0.5
    scene2 = rt.deform_scene(scene, jnp.asarray(pos))
    bvh2 = rt.refit_bvh(scene2, bvh)

    o, d = _rays(512, seed=5)
    got = trace.traverse(scene2, bvh2, o, d)
    want = trace.brute_force_trace(scene2, o, d)
    np.testing.assert_array_equal(np.asarray(got.t), np.asarray(want.t))
    np.testing.assert_array_equal(np.asarray(got.tri), np.asarray(want.tri))


def test_refit_matches_fresh_refit_of_same_topology():
    mesh = rt.random_triangle_soup(100, seed=6, bound=4.0, tri_size=0.8)
    scene = rt.build_scene(mesh)
    bvh = rt.build_bvh(scene)
    # Identity deform → identical node boxes.
    bvh2 = rt.refit_bvh(scene, bvh)
    np.testing.assert_array_equal(
        np.asarray(bvh2.node_aabb_min), np.asarray(bvh.node_aabb_min)
    )
    np.testing.assert_array_equal(
        np.asarray(bvh2.node_aabb_max), np.asarray(bvh.node_aabb_max)
    )


def _two_plane_scene():
    """A small occluder plane above a large floor, light from (1,1,1)."""
    import unitysimpleraytracing.core.mesh as mesh_mod

    floor = np.array(
        [
            [[-10, 0, -10], [10, 0, -10], [10, 0, 10]],
            [[-10, 0, -10], [10, 0, 10], [-10, 0, 10]],
        ],
        np.float32,
    )
    # Occluder centered along the light direction from the origin region.
    occ = floor[:, :, :] * 0.08 + np.array([3.0, 3.0, 3.0], np.float32)
    pos = np.concatenate([floor, occ])
    uv = np.zeros((4, 3, 2), np.float32)
    # Upward normals so unshadowed lambert (N·L = 1/√3 ≈ 0.577) sits above
    # the 0.4 ambient floor — otherwise shadows would be invisible.
    nrm = np.broadcast_to(
        np.array([0.0, 1.0, 0.0], np.float32), (4, 3, 3)
    ).copy()
    m = mesh_mod.MeshData(positions=pos, uvs=uv, normals=nrm)
    return rt.build_scene(m)


def test_shadow_rays_darken_occluded_floor():
    scene = _two_plane_scene()
    bvh = rt.build_bvh(scene)
    cam = rt.make_camera(eye=(0, 8, 12), target=(0, 0, 0), width=96, height=96)
    tex = rt.solid_texture((1.0, 1.0, 1.0, 1.0))
    lit = np.asarray(rt.render_rgba(scene, bvh, cam, tex, shadows=False))
    sh = np.asarray(rt.render_rgba(scene, bvh, cam, tex, shadows=True))
    hit = lit[..., 3] > 0
    assert hit.any()
    # Shadows only darken, never brighten.
    assert np.all(sh[..., :3] <= lit[..., :3] + 1e-6)
    darkened = (lit[..., 0] - sh[..., 0] > 1e-3) & hit
    assert darkened.any(), "occluder casts no shadow"
    # Shadowed pixels sit at the 0.4 ambient floor (white texture).
    np.testing.assert_allclose(sh[..., 0][darkened], 0.4, atol=1e-5)
    # Un-shadowed pixels unchanged.
    same = hit & ~darkened
    np.testing.assert_allclose(sh[..., 0][same], lit[..., 0][same], atol=1e-6)


def test_chunked_bvh_matches_single_bvh():
    mesh = rt.random_triangle_soup(5000, seed=8, bound=10.0, tri_size=0.8)
    scene = rt.build_scene(mesh)
    bvh = rt.build_bvh(scene)
    cbvh = rt.build_bvh_chunked(scene, chunk_capacity=1024)
    assert cbvh.num_chunks == 5
    o, d = _rays(1024, seed=9, bound=12.0)
    ref = trace.traverse(scene, bvh, o, d)
    got = rt.trace_chunked(cbvh, o, d)
    # Different jit programs fuse multiply-adds differently → ULP-level t
    # drift (the BASELINE parity bar: ids exact, t ULP-bounded).
    gt, st = np.asarray(got.t), np.asarray(ref.t)
    np.testing.assert_array_equal(
        gt == rt.constants.MAX_FLOAT, st == rt.constants.MAX_FLOAT
    )
    hit = st < rt.constants.MAX_FLOAT
    np.testing.assert_allclose(gt[hit], st[hit], rtol=2e-6)
    np.testing.assert_array_equal(np.asarray(got.tri)[hit], np.asarray(ref.tri)[hit])
    np.testing.assert_allclose(np.asarray(got.u)[hit], np.asarray(ref.u)[hit], atol=1e-5)

    cam = rt.make_camera(eye=(15, 12, 18), target=(0, 0, 0), width=64, height=64)
    a = rt.render_hits(scene, bvh, cam)
    b = rt.render_hits_chunked(scene, cbvh, cam)
    ah, bh = np.asarray(a.t), np.asarray(b.t)
    np.testing.assert_array_equal(
        ah == rt.constants.MAX_FLOAT, bh == rt.constants.MAX_FLOAT
    )
    m = ah < rt.constants.MAX_FLOAT
    np.testing.assert_allclose(ah[m], bh[m], rtol=2e-6)


def test_chunked_routing_parity():
    """Per-ray chunk routing (stable nearest-chunk reorder) must be
    bit-identical to the unrouted fold — same candidates, same fold order,
    only the packet composition changes (VERDICT r2 item 3)."""
    mesh = rt.random_triangle_soup(4000, seed=13, bound=12.0, tri_size=0.7)
    scene = rt.build_scene(mesh)
    cbvh = rt.build_bvh_chunked(scene, chunk_capacity=1024)
    assert cbvh.num_chunks == 4
    o, d = _rays(2048, seed=14, bound=15.0)
    a = rt.trace_chunked(cbvh, o, d, route=True)
    b = rt.trace_chunked(cbvh, o, d, route=False)
    np.testing.assert_array_equal(np.asarray(a.t), np.asarray(b.t))
    np.testing.assert_array_equal(np.asarray(a.tri), np.asarray(b.tri))
    np.testing.assert_array_equal(np.asarray(a.u), np.asarray(b.u))
    np.testing.assert_array_equal(np.asarray(a.v), np.asarray(b.v))


def test_chunked_frame_and_shadows_match_single_kernel_path():
    """render_frame_chunked (the >580K-tri render path) must match the
    single-BVH render_frame pixel-for-pixel up to the chunked tie class —
    including the shadow pass (chunked any-hit occlusion)."""
    mesh = rt.random_triangle_soup(3000, seed=21, bound=8.0, tri_size=0.9)
    scene = rt.build_scene(mesh)
    bvh = rt.build_bvh(scene)
    cbvh = rt.build_bvh_chunked(scene, chunk_capacity=1024)
    cam = rt.make_camera(eye=(11, 9, 13), target=(0, 0, 0), width=64, height=64)
    tex = rt.solid_texture((0.8, 0.7, 0.6, 1.0))
    bg = np.asarray([0.1, 0.1, 0.12], np.float32)
    a = np.asarray(rt.render_frame(scene, bvh, cam, tex, bg, shadows=True))
    b = np.asarray(rt.render_frame_chunked(scene, cbvh, cam, tex, bg, shadows=True))
    # ULP-level t drift across jit programs can flip a shaded value only at
    # exact ties; bound the disagreeing pixels like the golden tests do.
    diff = np.abs(a - b)
    assert float((diff > 2 / 255).mean()) < 0.002, diff.max()


def test_chunked_builder_and_rows_variants_bit_identical():
    """builder="karras" (override), the traced-build fallback and the routed
    ray order must all produce the unrouted default's results: same fold
    over the same per-chunk candidates (routing only reorders the rays; the
    traced build differs only in table PADDING, which is inert)."""
    import jax

    mesh = rt.random_triangle_soup(3000, seed=31, bound=9.0, tri_size=0.8)
    scene = rt.build_scene(mesh)
    o, d = _rays(2048, seed=32, bound=11.0)

    ref_c = rt.build_bvh_chunked(scene, chunk_capacity=1024, builder="karras")
    ref = rt.trace_chunked(ref_c, o, d, route=False)

    # Routed rays over the same (karras) tables: bit-identical.
    routed = rt.trace_chunked(ref_c, o, d, route=True)
    np.testing.assert_array_equal(np.asarray(routed.t), np.asarray(ref.t))
    np.testing.assert_array_equal(np.asarray(routed.tri), np.asarray(ref.tri))

    # Traced build (inside a caller's jit → worst-case table bound, karras):
    # same hits as the host-built karras chunks.
    traced_c = jax.jit(
        lambda s: rt.build_bvh_chunked(s, chunk_capacity=1024)
    )(scene)
    assert traced_c.tables.shape[1] >= ref_c.tables.shape[1]  # padded bound
    got = rt.trace_chunked(traced_c, o, d, route=False)
    np.testing.assert_array_equal(np.asarray(got.t), np.asarray(ref.t))
    np.testing.assert_array_equal(np.asarray(got.tri), np.asarray(ref.tri))

    # SAH chunks (the concrete-build default): same hit set up to exact-t
    # ties (the BASELINE tie class; a different tree order can flip only
    # equal-t winners).
    sah_c = rt.build_bvh_chunked(scene, chunk_capacity=1024)
    got = rt.trace_chunked(sah_c, o, d, route=False)
    gt, st = np.asarray(got.t), np.asarray(ref.t)
    np.testing.assert_array_equal(
        gt == rt.constants.MAX_FLOAT, st == rt.constants.MAX_FLOAT
    )
    hit = st < rt.constants.MAX_FLOAT
    np.testing.assert_allclose(gt[hit], st[hit], rtol=2e-6)


def test_chunked_compaction_parity():
    """Mid-schedule live-ray compaction (VERDICT r3 item 1) must reproduce the
    uncompacted fold: the tail chunks trace a permuted ray order with a fresh
    best state seeded from the running t, merged by strict-< and unpermuted at
    the end — per-ray candidates and fold are unchanged."""
    mesh = rt.random_triangle_soup(6000, seed=21, bound=12.0, tri_size=0.7)
    scene = rt.build_scene(mesh)
    cbvh = rt.build_bvh_chunked(scene, chunk_capacity=1024)
    assert cbvh.num_chunks == 6
    o, d = _rays(2048, seed=22, bound=15.0)
    base = rt.trace_chunked(cbvh, o, d, route=False, compact=None)
    for comp in ("auto", 0, 2, 4):
        got = rt.trace_chunked(cbvh, o, d, route=False, compact=comp)
        np.testing.assert_array_equal(np.asarray(got.t), np.asarray(base.t))
        np.testing.assert_array_equal(np.asarray(got.tri), np.asarray(base.tri))
        np.testing.assert_array_equal(np.asarray(got.u), np.asarray(base.u))
    # Composes with routing, and with the any-hit occlusion threading.
    rc = rt.trace_chunked(cbvh, o, d, route=True, compact=1)
    np.testing.assert_array_equal(np.asarray(rc.t), np.asarray(base.t))
    np.testing.assert_array_equal(np.asarray(rc.tri), np.asarray(base.tri))
    import jax.numpy as jnp

    thr = jnp.full((o.shape[0],), 10.0, jnp.float32)
    a0 = rt.trace_chunked(cbvh, o, d, compact=None, anyhit_thresh=thr)
    a1 = rt.trace_chunked(cbvh, o, d, compact=1, anyhit_thresh=thr)
    np.testing.assert_array_equal(np.asarray(a0.t), np.asarray(a1.t))


def test_animated_renderer_fused_matches_unfused():
    """make_animated_renderer's single-dispatch frame (deform → refit →
    table slot-update → trace in ONE jit) matches the unfused
    deform/refit/render_hits sequence (VERDICT r3 item 2); the plan reuse
    keeps repacks bit-consistent across frames."""
    import jax.numpy as jnp

    from unitysimpleraytracing.pipeline.build import deform_scene, refit_bvh

    mesh = rt.terrain_mesh(res=16, size=16.0, amplitude=3.0, seed=1)
    scene = rt.build_scene(mesh)
    bvh = rt.build_bvh(scene, builder="karras")
    cam = rt.make_camera(eye=(12, 10, 14), target=(0, 0, 0), width=64, height=64)
    t = scene.triangles
    base = jnp.stack([t.a, t.b, t.c], axis=1)
    anim = rt.make_animated_renderer(scene, bvh, cam)
    for phase in (0.3, 1.1):
        pos = base.at[..., 1].add(0.4 * jnp.sin(base[..., 0] * 0.5 + phase))
        got = anim(pos)
        s2 = deform_scene(scene, pos)
        b2 = refit_bvh(s2, bvh)
        ref = rt.render_hits(s2, b2, cam)
        gt, st = np.asarray(got.t), np.asarray(ref.t)
        hit = st < rt.constants.MAX_FLOAT
        np.testing.assert_array_equal(gt < rt.constants.MAX_FLOAT, hit)
        np.testing.assert_allclose(gt[hit], st[hit], rtol=4e-6)
        np.testing.assert_array_equal(
            np.asarray(got.tri)[hit], np.asarray(ref.tri)[hit]
        )


def test_chunked_capacity_contract():
    """An oversized chunk must raise a typed error at BUILD time: the record
    metas hold 21-bit ids, so packing refuses before any device work."""
    import jax.numpy as jnp
    import pytest

    from unitysimpleraytracing.ops import dispatch, trace_gpu

    with pytest.raises(dispatch.CapacityError, match="21 bits"):
        trace_gpu.check_capacity(trace_gpu.MAX_IDS)
    from unitysimpleraytracing.pipeline import chunked

    # The default chunk, padded to the partition's lane multiple, passes.
    trace_gpu.check_capacity(rt.constants.pad_count(
        chunked.DEFAULT_CHUNK_CAPACITY, rt.constants.LANE))
    cap = trace_gpu.MAX_IDS
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
    with pytest.raises(dispatch.CapacityError):
        trace_gpu.pack_tables(scene, bvh)
