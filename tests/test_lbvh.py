"""LBVH topology vs the scalar Karras replica + structural invariants."""
import jax.numpy as jnp
import numpy as np
import pytest

from unitysimpleraytracing import build_bvh, build_scene, random_triangle_soup
from unitysimpleraytracing.ops import lbvh
from unitysimpleraytracing.ops.sort import sort_key_val
from unitysimpleraytracing.ops.unique import distribute_keys
from unitysimpleraytracing.utils import reference_impl, validate


def _unique_sorted_keys(n, seed):
    rng = np.random.default_rng(seed)
    keys = rng.choice(np.arange(1 << 22, dtype=np.uint32), size=n, replace=False)
    return np.sort(keys)


@pytest.mark.parametrize("n", [2, 3, 5, 64, 500])
def test_topology_matches_reference_scalar(n):
    keys = _unique_sorted_keys(n, seed=n)
    cap = 1024
    padded = np.full(cap, 0xFFFFFFFF, np.uint32)
    padded[:n] = keys
    left, right, lleaf, rleaf, iparent, lparent, first, last, _ = lbvh.build_topology(
        jnp.asarray(padded), n
    )
    rl, rr, rll, rrl, rip, rlp, rf, rla = reference_impl.karras_topology(keys, n)
    np.testing.assert_array_equal(np.asarray(left)[: n - 1], rl)
    np.testing.assert_array_equal(np.asarray(right)[: n - 1], rr)
    np.testing.assert_array_equal(np.asarray(lleaf)[: n - 1], rll)
    np.testing.assert_array_equal(np.asarray(rleaf)[: n - 1], rrl)
    np.testing.assert_array_equal(np.asarray(iparent)[: n - 1], rip)
    np.testing.assert_array_equal(np.asarray(lparent)[:n], rlp)
    np.testing.assert_array_equal(np.asarray(first)[: n - 1], rf)
    np.testing.assert_array_equal(np.asarray(last)[: n - 1], rla)


def test_sequential_keys_topology():
    # distribute_keys on all-identical Morton codes yields 0,1,2,... —
    # the degenerate-cluster case the dedup exists for.
    n = 100
    keys = np.arange(n, dtype=np.uint32)
    padded = np.full(256, 0xFFFFFFFF, np.uint32)
    padded[:n] = keys
    left, right, lleaf, rleaf, iparent, lparent, _, _, _ = lbvh.build_topology(
        jnp.asarray(padded), n
    )
    rl, rr, *_ = reference_impl.karras_topology(keys, n)
    np.testing.assert_array_equal(np.asarray(left)[: n - 1], rl)
    np.testing.assert_array_equal(np.asarray(right)[: n - 1], rr)


@pytest.mark.parametrize("n_tris", [2, 12, 333])
def test_full_build_invariants(n_tris):
    mesh = random_triangle_soup(n_tris, seed=n_tris)
    scene = build_scene(mesh)
    bvh = build_bvh(scene, diagnostics=True)
    validate.check_topology(bvh)
    validate.check_depths(bvh)
    validate.check_refit(bvh, scene.aabb_min, scene.aabb_max)


def test_attach_diagnostics_matches_built_in():
    mesh = random_triangle_soup(77, seed=3)
    scene = build_scene(mesh)
    lazy = lbvh.attach_diagnostics(build_bvh(scene))
    eager = build_bvh(scene, diagnostics=True)
    np.testing.assert_array_equal(np.asarray(lazy.depth), np.asarray(eager.depth))
    np.testing.assert_array_equal(
        np.asarray(lazy.internal_parent), np.asarray(eager.internal_parent)
    )
    np.testing.assert_array_equal(
        np.asarray(lazy.leaf_parent), np.asarray(eager.leaf_parent)
    )


def test_clustered_scene_build():
    # Many triangles in a tiny cluster → heavy Morton duplicates → exercises
    # distribute_keys + topology on near-sequential keys.
    mesh = random_triangle_soup(200, seed=4, bound=0.01, tri_size=0.005)
    scene = build_scene(mesh)
    keys, _ = sort_key_val(scene.morton, scene.tri_index)
    keys = distribute_keys(keys, scene.count)
    validate.check_unique_strictly_increasing(np.asarray(keys), scene.count)
    bvh = build_bvh(scene, diagnostics=True)
    validate.check_topology(bvh)
    validate.check_refit(bvh, scene.aabb_min, scene.aabb_max)


def test_root_aabb_covers_scene():
    mesh = random_triangle_soup(128, seed=8)
    scene = build_scene(mesh)
    bvh = build_bvh(scene)
    root_min = np.asarray(bvh.node_aabb_min[0])
    root_max = np.asarray(bvh.node_aabb_max[0])
    tmin = np.asarray(scene.aabb_min)[: scene.count]
    tmax = np.asarray(scene.aabb_max)[: scene.count]
    np.testing.assert_array_equal(root_min, tmin.min(axis=0))
    np.testing.assert_array_equal(root_max, tmax.max(axis=0))


def test_build_bvh_validate_flag_runs_in_situ():
    """``build_bvh(validate=True)`` runs the promoted validators on the
    user's actual scene (the reference validates every sort pass inside the
    real pipeline, ComputeBufferSorter.cs:107-125) and returns a usable BVH."""
    scene = build_scene(random_triangle_soup(220, seed=3, bound=6.0, tri_size=1.0))
    bvh = build_bvh(scene, validate=True)
    assert int(np.asarray(bvh.internal_parent)[1]) >= 0  # diagnostics attached
    # Same tree as the unvalidated build.
    plain = build_bvh(scene)
    np.testing.assert_array_equal(np.asarray(bvh.left), np.asarray(plain.left))
    np.testing.assert_array_equal(
        np.asarray(bvh.node_aabb_min), np.asarray(plain.node_aabb_min)
    )
