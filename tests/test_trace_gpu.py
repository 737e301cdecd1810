"""Parity of the GPU traversal kernel (ops/trace_gpu, Pallas interpreter on
the CPU) against the reference-ordered XLA traversal: identical hit masks,
ULP-bounded t, triangle ids equal except at exact-t ties."""
import gc

import jax.numpy as jnp
import numpy as np
import pytest

import unitysimpleraytracing as rt
from unitysimpleraytracing.ops import dispatch, lbvh, trace, trace_gpu

_TIE_RTOL = 4e-6


def _rays(n, seed, bound=8.0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-bound, bound, size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d)


def _assert_hit_parity(got, ref):
    t_r, t_g = np.asarray(ref.t), np.asarray(got.t)
    tri_r, tri_g = np.asarray(ref.tri), np.asarray(got.tri)
    hit_r, hit_g = t_r != rt.constants.MAX_FLOAT, t_g != rt.constants.MAX_FLOAT
    # Hit/miss flips would mean a wrongly culled (or added) subtree.
    np.testing.assert_array_equal(hit_g, hit_r)
    hit = hit_r
    np.testing.assert_allclose(t_g[hit], t_r[hit], rtol=_TIE_RTOL)
    mism = (tri_g != tri_r) & hit
    tied = np.abs(t_g - t_r) <= _TIE_RTOL * np.abs(t_r)
    assert not np.any(mism & ~tied), "hit-id mismatch that is not an exact-t tie"
    same = hit & ~mism
    np.testing.assert_allclose(np.asarray(got.u)[same], np.asarray(ref.u)[same], atol=1e-5)
    np.testing.assert_allclose(np.asarray(got.v)[same], np.asarray(ref.v)[same], atol=1e-5)
    # Misses keep the reference's tri = 0.
    assert np.all(tri_g[~hit] == 0)


def _run(scene, bvh, o, d, **kw):
    return trace_gpu.traverse(scene, bvh, o, d, interpret=True, **kw)


_MESHES = {
    "cube": lambda: rt.cube_mesh(size=2.0),
    "soup": lambda: rt.random_triangle_soup(300, seed=7, bound=5.0, tri_size=1.0),
    "terrain": lambda: rt.terrain_mesh(res=24, size=40.0, amplitude=6.0, seed=0),
}


@pytest.mark.parametrize("builder", ["karras", "sah", "sah_free"])
@pytest.mark.parametrize("mesh", sorted(_MESHES))
def test_parity_meshes_and_builders(mesh, builder):
    scene = rt.build_scene(_MESHES[mesh]())
    bvh = rt.build_bvh(scene, builder=builder)
    o, d = _rays(1024, seed=1)
    _assert_hit_parity(_run(scene, bvh, o, d), trace.traverse(scene, bvh, o, d))


@pytest.mark.parametrize("rays_per_call", [64, 256, 1024])
def test_split_calls_match_one_call(monkeypatch, rays_per_call):
    """Batches past MAX_RAYS_PER_CALL split into several kernel calls (the
    per-ray stacks are a scratch output sized per call); the split must not
    change a single bit."""
    scene = rt.build_scene(rt.terrain_mesh(res=20, size=20.0, amplitude=4.0, seed=0))
    bvh = rt.build_bvh(scene)
    o, d = _rays(2048, seed=9, bound=14.0)
    whole = _run(scene, bvh, o, d)
    monkeypatch.setattr(trace_gpu, "MAX_RAYS_PER_CALL", rays_per_call)
    split = _run(scene, bvh, o, d)
    for f in ("t", "tri", "u", "v"):
        np.testing.assert_array_equal(np.asarray(getattr(split, f)), np.asarray(getattr(whole, f)))
    _assert_hit_parity(whole, trace.traverse(scene, bvh, o, d))


def test_mask_counts_and_root():
    scene = rt.build_scene(rt.random_triangle_soup(97, seed=1, bound=5.0))
    bvh = rt.build_bvh(scene)
    mask, new_id, count = trace_gpu.node_mask(bvh)
    mask = np.asarray(mask)
    n = scene.count
    assert mask[0]  # root is a record
    m = int(mask.sum())
    assert m == count
    assert (n - 1) / 3 - 1 <= m <= (2 * n - 1) / 3 + 1
    assert int(np.asarray(new_id)[0]) == 0


def test_node_mask_matches_depth_parity():
    """The compacted record ids agree with an explicit depth walk."""
    scene = rt.build_scene(rt.random_triangle_soup(64, seed=12, bound=4.0))
    bvh = lbvh.attach_diagnostics(rt.build_bvh(scene))
    mask, _, _ = trace_gpu.node_mask(bvh)
    depth = np.asarray(bvh.depth)[: scene.count - 1]
    np.testing.assert_array_equal(np.asarray(mask)[: scene.count - 1], depth % 2 == 0)


def test_two_triangles():
    """n=2: the root's children are both leaves → two EMPTY entries."""
    scene = rt.build_scene(rt.cube_mesh(size=2.0))
    bvh = rt.build_bvh(scene)
    o, d = _rays(256, seed=2, bound=4.0)
    _assert_hit_parity(_run(scene, bvh, o, d), trace.traverse(scene, bvh, o, d))


def test_shared_edge_ties_bounded():
    """Rays aimed exactly at cube edges/corners — the tie-heavy worst case."""
    scene = rt.build_scene(rt.cube_mesh(size=2.0))
    bvh = rt.build_bvh(scene)
    targets = np.array(
        [[1, 1, 1], [1, 1, -1], [-1, -1, -1], [1, 1, 0], [0, 1, 1], [1, 0, 1],
         [1, 0, 0], [0, 0, 1], [0, 1, 0]],
        np.float32,
    )
    eye = np.array([4.0, 3.0, 5.0], np.float32)
    d = targets - eye
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = np.broadcast_to(eye, d.shape).astype(np.float32)
    ref = trace.traverse(scene, bvh, jnp.asarray(o), jnp.asarray(d))
    got = dispatch.trace_rays(scene, bvh, jnp.asarray(o), jnp.asarray(d), impl="gpu")
    t_r, t_g = np.asarray(ref.t), np.asarray(got.t)
    assert np.all(t_r != rt.constants.MAX_FLOAT)
    np.testing.assert_allclose(t_g, t_r, rtol=_TIE_RTOL)


@pytest.mark.parametrize("size,amp,bound", [(7800.0, 1100.0, 5500.0), (50000.0, 7000.0, 35000.0)])
def test_parity_at_large_scene_extent(size, amp, bound):
    """The exact ``tmin < t`` cull leans on the 1e-3 AABB inflation
    dominating slab rounding, which is tightest at extents ~8e3; beyond
    that the stored boxes widen (apply_plan).  Both sides keep parity."""
    scene = rt.build_scene(rt.terrain_mesh(res=16, size=size, amplitude=amp, seed=2))
    bvh = rt.build_bvh(scene)
    o, d = _rays(512, seed=5, bound=bound)
    _assert_hit_parity(_run(scene, bvh, o, d), trace.traverse(scene, bvh, o, d))


def test_widening_is_zero_within_tested_extent():
    """A small scene's leaf entries carry their triangle boxes bit for bit."""
    scene = rt.build_scene(rt.cube_mesh(size=2.0))
    bvh = rt.build_bvh(scene)
    tab = np.asarray(trace_gpu.prepare_tables(scene, bvh))
    amin, amax = np.asarray(scene.aabb_min), np.asarray(scene.aabb_max)
    checked = 0
    for e in range(4):
        meta = tab[:, 24 + e].astype(np.int64)
        box_min, box_max = tab[:, 6 * e:6 * e + 3], tab[:, 6 * e + 3:6 * e + 6]
        leaf = ((meta >> 21) & 1 == 1) & (box_min[:, 0] < 1e30)  # present leaves
        idx = meta[leaf] & (trace_gpu.MAX_IDS - 1)
        np.testing.assert_array_equal(box_min[leaf], amin[idx])
        np.testing.assert_array_equal(box_max[leaf], amax[idx])
        checked += int(leaf.sum())
    assert checked == scene.count  # every triangle sits in exactly one entry


def test_t_init_pruning_exact():
    scene = rt.build_scene(rt.random_triangle_soup(200, seed=5, bound=5.0, tri_size=1.0))
    bvh = rt.build_bvh(scene)
    o, d = _rays(512, seed=4)
    ref = trace.traverse(scene, bvh, o, d)
    t_ref = np.asarray(ref.t)
    # A bound just ABOVE the true hit still finds it; just BELOW must miss.
    # Additive margin: t can be NEGATIVE (the reference keeps behind-origin
    # hits — no t>0 test), so a multiplicative 1.01 would move the wrong way.
    MAXF = np.float32(rt.constants.MAX_FLOAT)
    eps = np.float32(0.01) * np.maximum(np.abs(t_ref), 1.0).astype(np.float32)
    above = jnp.asarray(np.where(t_ref < 1e30, t_ref + eps, MAXF), jnp.float32)
    _assert_hit_parity(_run(scene, bvh, o, d, t_init=above), ref)
    below = jnp.asarray(np.where(t_ref < 1e30, t_ref - eps, MAXF), jnp.float32)
    got2 = _run(scene, bvh, o, d, t_init=below)
    assert not np.any(np.asarray(got2.t) < np.asarray(below))


def test_t_init_own_best_adds_nothing():
    """Re-tracing with each ray's own best as t_init: every strict-<
    accept fails, so t comes back unchanged and no new hit appears."""
    scene = rt.build_scene(rt.random_triangle_soup(300, seed=7, bound=5.0, tri_size=1.0))
    bvh = rt.build_bvh(scene)
    o, d = _rays(512, seed=9)
    ref = _run(scene, bvh, o, d)
    again = _run(scene, bvh, o, d, t_init=ref.t)
    np.testing.assert_array_equal(np.asarray(again.t), np.asarray(ref.t))
    assert not np.any(np.asarray(again.hit) & ~np.asarray(ref.hit))


@pytest.mark.parametrize("thresh", [5.0, 20.0])
def test_anyhit_occlusion_matches_nearest(thresh):
    scene = rt.build_scene(rt.random_triangle_soup(200, seed=8, bound=5.0, tri_size=1.0))
    bvh = rt.build_bvh(scene)
    o, d = _rays(512, seed=6)
    ref = trace.traverse(scene, bvh, o, d)
    thr = jnp.full((512,), thresh, jnp.float32)
    got = _run(scene, bvh, o, d, anyhit_thresh=thr)
    want = np.asarray(ref.hit) & (np.asarray(ref.t) < thresh)
    have = np.asarray(got.hit) & (np.asarray(got.t) < thresh)
    np.testing.assert_array_equal(have, want)


def test_anyhit_zero_threshold_is_inert():
    scene = rt.build_scene(rt.terrain_mesh(res=16, size=20.0, amplitude=4.0, seed=0))
    bvh = rt.build_bvh(scene)
    o, d = _rays(512, seed=3, bound=12.0)
    base = _run(scene, bvh, o, d)
    inert = _run(scene, bvh, o, d, anyhit_thresh=jnp.zeros((512,), jnp.float32))
    np.testing.assert_array_equal(np.asarray(inert.t), np.asarray(base.t))
    np.testing.assert_array_equal(np.asarray(inert.tri), np.asarray(base.tri))


def test_dispatch_and_render_path():
    """impl="gpu" end to end through dispatch + render_hits + occluded."""
    scene = rt.build_scene(rt.terrain_mesh(res=16, size=16.0, amplitude=3.0, seed=1))
    bvh = rt.build_bvh(scene)
    cam = rt.make_camera(
        eye=(12.0, 10.0, 15.0), target=(0.0, 0.0, 0.0),
        width=64, height=64, fov_deg=60.0,
    )
    ref = rt.render_hits(scene, bvh, cam, impl="perray")
    got = rt.render_hits(scene, bvh, cam, impl="gpu")
    _assert_hit_parity(got, ref)
    o, d = _rays(512, seed=3, bound=10.0)
    occ = dispatch.occluded(scene, bvh, o, d, impl="gpu")
    occp = dispatch.occluded(scene, bvh, o, d, impl="packet")
    np.testing.assert_array_equal(np.asarray(occ), np.asarray(occp))


def test_refit_repack_uses_topology_cache_and_stays_exact():
    """refit_bvh keeps the child-link arrays (dataclass replace) → the
    even-depth membership cache hits, and the repacked tables equal a
    from-scratch pack of the refit BVH bit for bit."""
    scene = rt.build_scene(rt.random_triangle_soup(300, seed=9, bound=5.0, tri_size=1.0))
    bvh = rt.build_bvh(scene)
    m1, n1, _ = trace_gpu.node_mask(bvh)
    t = scene.triangles
    pos = jnp.stack([t.a, t.b, t.c], axis=1).at[..., 1].add(0.25)
    scene2 = rt.deform_scene(scene, pos)
    bvh2 = rt.refit_bvh(scene2, bvh)
    assert bvh2.left is bvh.left  # topology arrays shared
    m2, n2, _ = trace_gpu.node_mask(bvh2)
    assert m2 is m1 and n2 is n1  # cache hit
    got = trace_gpu.prepare_tables(scene2, bvh2)
    fresh = trace_gpu.pack_tables(scene2, bvh2, cap4=got.shape[0])
    np.testing.assert_array_equal(np.asarray(got), np.asarray(fresh))
    o, d = _rays(512, seed=10)
    _assert_hit_parity(_run(scene2, bvh2, o, d, tables=got), trace.traverse(scene2, bvh2, o, d))


def test_prepare_tables_cache_engages_and_evicts():
    scene = rt.build_scene(rt.cube_mesh(size=2.0))
    bvh = rt.build_bvh(scene)
    t1 = trace_gpu.prepare_tables(scene, bvh)
    assert trace_gpu.prepare_tables(scene, bvh) is t1, "cache miss on identical (scene, bvh)"
    key = id(bvh)
    assert key in trace_gpu._TABLE_CACHE
    # A different scene with the same bvh must not serve the stale entry.
    scene2 = rt.build_scene(rt.cube_mesh(size=2.0))
    assert trace_gpu.prepare_tables(scene2, bvh) is not t1
    del bvh
    gc.collect()
    assert key not in trace_gpu._TABLE_CACHE, "dead Bvh entry not evicted"


def test_table_shape_is_actual_record_count():
    scene = rt.build_scene(rt.terrain_mesh(res=12, size=12.0, amplitude=3.0, seed=0))
    bvh = rt.build_bvh(scene)
    _, _, count = trace_gpu.node_mask(bvh)
    tab = trace_gpu.prepare_tables(scene, bvh)
    assert tab.shape == (count, trace_gpu.SLOTS)
    assert trace_gpu.pack_tables(scene, bvh).shape == (
        trace_gpu.worst_case_records(bvh.capacity), trace_gpu.SLOTS
    )


def test_kernel_lowers_for_cuda():
    """The kernel lowers to a Triton call for the CUDA platform (no card
    needed to lower; compiling it needs one)."""
    from jax import export

    scene = rt.build_scene(rt.cube_mesh(size=2.0))
    bvh = rt.build_bvh(scene)
    tables = trace_gpu.prepare_tables(scene, bvh)
    run = trace_gpu._traversal_fn(64, tables.shape[0], False)
    exp = export.export(
        run, platforms=["cuda"],
        disabled_checks=[export.DisabledSafetyCheck.custom_call("__gpu$xla.gpu.triton")],
    )(tables, jnp.zeros((8, 64), jnp.float32))
    assert "__gpu$xla.gpu.triton" in exp.mlir_module()
