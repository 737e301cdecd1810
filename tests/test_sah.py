"""Sweep-SAH builder (ops/sah.py): structural invariants, hit parity with the
brute-force oracle and the Karras tree, tree quality, BVH4 packing, traced
counts."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from unitysimpleraytracing import (
    build_bvh,
    build_scene,
    random_triangle_soup,
    terrain_mesh,
)
from unitysimpleraytracing.ops import sah, trace, trace_gpu
from unitysimpleraytracing.utils import validate


def _random_rays(n, seed, bound=60.0):
    rng = np.random.default_rng(seed)
    origins = rng.uniform(-bound, bound, (n, 3)).astype(np.float32)
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    return jnp.asarray(origins), jnp.asarray(dirs)


@pytest.mark.parametrize("builder", ["sah", "sah_free"])
@pytest.mark.parametrize("n_tris", [2, 3, 7, 100, 500])
def test_sah_structural_invariants(n_tris, builder):
    mesh = random_triangle_soup(n_tris, seed=n_tris)
    scene = build_scene(mesh)
    bvh = build_bvh(scene, diagnostics=True, builder=builder)
    validate.check_topology(bvh)
    validate.check_depths(bvh)
    validate.check_refit(bvh, scene.aabb_min, scene.aabb_max)


def test_sah_contiguous_ranges_and_karras_numbering():
    # Left child named by its range's last index, right child by its first;
    # children at (split, split+1); ranges partition the parent's range.
    mesh = random_triangle_soup(257, seed=9)
    scene = build_scene(mesh)
    bvh = build_bvh(scene, builder="sah")
    n = scene.count
    left = np.asarray(bvh.left)[: n - 1]
    right = np.asarray(bvh.right)[: n - 1]
    lleaf = np.asarray(bvh.left_is_leaf)[: n - 1]
    rleaf = np.asarray(bvh.right_is_leaf)[: n - 1]
    first = np.asarray(bvh.range_first)[: n - 1]
    last = np.asarray(bvh.range_last)[: n - 1]
    assert first[0] == 0 and last[0] == n - 1
    np.testing.assert_array_equal(right, left + 1)
    for i in range(n - 1):
        s = left[i]
        assert first[i] <= s < last[i]
        if not lleaf[i]:  # internal left child covers [first, s], named s
            assert first[s] == first[i] and last[s] == s
        if not rleaf[i]:  # internal right child covers [s+1, last], named s+1
            assert first[s + 1] == s + 1 and last[s + 1] == last[i]


@pytest.mark.parametrize("builder", ["sah", "sah_free"])
@pytest.mark.parametrize("n_tris,n_rays", [(37, 256), (400, 512)])
def test_sah_hits_match_brute_force(n_tris, n_rays, builder):
    mesh = random_triangle_soup(n_tris, seed=n_tris, bound=5.0, tri_size=1.0)
    scene = build_scene(mesh)
    bvh = build_bvh(scene, builder=builder)
    origins, dirs = _random_rays(n_rays, seed=1, bound=8.0)
    want = trace.brute_force_trace(scene, origins, dirs)
    got = trace.traverse(scene, bvh, origins, dirs)
    np.testing.assert_array_equal(np.asarray(got.tri), np.asarray(want.tri))
    np.testing.assert_allclose(
        np.asarray(got.t), np.asarray(want.t), rtol=4e-6, atol=0
    )


def test_sah_cost_beats_karras_on_terrain():
    mesh = terrain_mesh(res=48, size=80.0, amplitude=9.0, seed=0)
    scene = build_scene(mesh)
    n = scene.count

    def cost(bvh):
        mn = np.asarray(bvh.node_aabb_min)[: n - 1]
        mx = np.asarray(bvh.node_aabb_max)[: n - 1]
        e = mx - mn
        sa = e[:, 0] * e[:, 1] + e[:, 1] * e[:, 2] + e[:, 2] * e[:, 0]
        return float(np.sum(sa) / sa[0])

    karras = cost(build_bvh(scene, builder="karras"))
    swept = cost(build_bvh(scene, builder="sah"))
    assert swept < karras, (swept, karras)


def test_sah_bvh4_kernel_parity_interpret():
    mesh = random_triangle_soup(300, seed=5, bound=5.0, tri_size=1.0)
    scene = build_scene(mesh)
    bvh = build_bvh(scene, builder="sah")
    origins, dirs = _random_rays(1024, seed=2, bound=8.0)
    want = trace.traverse(scene, bvh, origins, dirs)
    got = trace_gpu.traverse(scene, bvh, origins, dirs, interpret=True)
    np.testing.assert_array_equal(np.asarray(got.tri), np.asarray(want.tri))
    np.testing.assert_allclose(
        np.asarray(got.t), np.asarray(want.t), rtol=4e-6, atol=0
    )


def test_sah_free_beats_restricted_sweep_and_reorders():
    # The free-order builder's whole point: lower SAH cost than the
    # Morton-restricted sweep, via a genuinely different leaf permutation.
    mesh = terrain_mesh(res=48, size=80.0, amplitude=9.0, seed=0)
    scene = build_scene(mesh)
    n = scene.count

    def cost(bvh):
        mn = np.asarray(bvh.node_aabb_min)[: n - 1]
        mx = np.asarray(bvh.node_aabb_max)[: n - 1]
        e = mx - mn
        sa = e[:, 0] * e[:, 1] + e[:, 1] * e[:, 2] + e[:, 2] * e[:, 0]
        return float(np.sum(sa) / sa[0])

    restricted = build_bvh(scene, builder="sah")
    free = build_bvh(scene, builder="sah_free")
    assert cost(free) < cost(restricted), (cost(free), cost(restricted))
    # sorted_tri is a permutation of the in-scene triangle ids (reordered).
    st = np.asarray(free.sorted_tri)[:n]
    assert sorted(st.tolist()) == sorted(
        np.asarray(restricted.sorted_tri)[:n].tolist()
    )
    assert not np.array_equal(st, np.asarray(restricted.sorted_tri)[:n])


def test_sah_free_bvh4_kernel_parity_interpret():
    mesh = random_triangle_soup(300, seed=5, bound=5.0, tri_size=1.0)
    scene = build_scene(mesh)
    bvh = build_bvh(scene, builder="sah_free")
    origins, dirs = _random_rays(1024, seed=2, bound=8.0)
    want = trace.traverse(scene, bvh, origins, dirs)
    got = trace_gpu.traverse(scene, bvh, origins, dirs, interpret=True)
    np.testing.assert_array_equal(np.asarray(got.tri), np.asarray(want.tri))
    np.testing.assert_allclose(
        np.asarray(got.t), np.asarray(want.t), rtol=4e-6, atol=0
    )


def test_sah_free_chunked_parity():
    # builder="sah_free" through the chunked path: same hits as the
    # restricted-sweep chunk trees (topology changes, the hit contract not).
    from unitysimpleraytracing.pipeline import chunked

    scene = build_scene(
        random_triangle_soup(3000, seed=3, bound=20.0, tri_size=1.0)
    )
    cb_sah = chunked.build_bvh_chunked(
        scene, chunk_capacity=1024, builder="sah"
    )
    cb_free = chunked.build_bvh_chunked(
        scene, chunk_capacity=1024, builder="sah_free"
    )
    rng = np.random.default_rng(0)
    o = jnp.asarray(rng.uniform(-25, 25, (512, 3)).astype(np.float32))
    d = rng.normal(size=(512, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    h1 = chunked.trace_chunked(cb_sah, o, jnp.asarray(d), impl="packet")
    h2 = chunked.trace_chunked(cb_free, o, jnp.asarray(d), impl="packet")
    np.testing.assert_array_equal(np.asarray(h1.t), np.asarray(h2.t))
    np.testing.assert_array_equal(np.asarray(h1.tri), np.asarray(h2.tri))


def test_sah_traced_count():
    # Ragged-shard usage: capacity-padded arrays, count a traced scalar.
    mesh = random_triangle_soup(90, seed=7)
    scene = build_scene(mesh)
    from unitysimpleraytracing.ops.sort import sort_key_val

    _, sorted_tri = sort_key_val(scene.morton, scene.tri_index)

    @jax.jit
    def build(st, mn, mx, cnt):
        return sah.build_bvh_sah_from_sorted(
            st, mn, mx, cnt, static_count=st.shape[0]
        )

    traced = build(
        sorted_tri, scene.aabb_min, scene.aabb_max, jnp.int32(scene.count)
    )
    concrete = sah.build_bvh_sah_from_sorted(
        sorted_tri, scene.aabb_min, scene.aabb_max, scene.count,
        static_count=sorted_tri.shape[0],
    )
    n = scene.count
    np.testing.assert_array_equal(
        np.asarray(traced.left)[: n - 1], np.asarray(concrete.left)[: n - 1]
    )
    np.testing.assert_array_equal(
        np.asarray(traced.node_aabb_min)[: n - 1],
        np.asarray(concrete.node_aabb_min)[: n - 1],
    )


def test_sah_median_fallback_terminates_and_stays_valid():
    mesh = random_triangle_soup(200, seed=11)
    scene = build_scene(mesh)
    from unitysimpleraytracing.ops.sort import sort_key_val

    _, sorted_tri = sort_key_val(scene.morton, scene.tri_index)
    bvh = sah.build_bvh_sah_from_sorted(
        sorted_tri, scene.aabb_min, scene.aabb_max, scene.count,
        diagnostics=True, max_sah_depth=2,  # force the median path early
    )
    validate.check_topology(bvh)
    validate.check_refit(bvh, scene.aabb_min, scene.aabb_max)
