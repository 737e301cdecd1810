"""L0 substrate + aux subsystems: mirrored buffer, engine registry,
checkpoint/resume, debug and profiling helpers."""
import numpy as np
import jax.numpy as jnp
import pytest

from unitysimpleraytracing import build_bvh, build_scene, cube_mesh
from unitysimpleraytracing.core.buffer import DataBuffer
from unitysimpleraytracing.io.checkpoint import load_checkpoint, save_checkpoint
from unitysimpleraytracing.ops import registry
from unitysimpleraytracing.utils import debug, profiling


def test_databuffer_fill_and_roundtrip():
    # Sentinel pre-fill (MeshBufferContainer.cs:108: keys = uint.MaxValue).
    buf = DataBuffer(16, np.uint32, initial_value=0xFFFFFFFF)
    assert buf[3] == 0xFFFFFFFF
    buf[0:4] = [1, 2, 3, 4]
    dev = buf.device_array  # sync() upload
    np.testing.assert_array_equal(np.asarray(dev[:4]), [1, 2, 3, 4])


def test_databuffer_lazy_download_after_device_assign():
    buf = DataBuffer(8, np.float32)
    buf.assign_device(jnp.arange(8, dtype=jnp.float32) * 2)
    # Indexer triggers the lazy download (DataBuffer.cs:32-48 semantics).
    assert buf[3] == 6.0
    buf[3] = -1.0
    np.testing.assert_allclose(np.asarray(buf.device_array)[3], -1.0)


def test_databuffer_shape_guard():
    buf = DataBuffer(8, np.float32)
    with pytest.raises(ValueError):
        buf.assign_device(jnp.zeros((4,), jnp.float32))


def test_registry_lists_builtin_engines():
    assert registry.engines("sort") == ["radix", "xla"]
    assert registry.engines("traverse") == ["gpu", "packet", "perray"]
    assert registry.engines("scan") == ["xla"]
    assert registry.engines("topology") == ["karras", "sah"]
    with pytest.raises(KeyError):
        registry.get("sort", "nope")


def test_registry_sort_engines_agree():
    rng = np.random.default_rng(0)
    k = jnp.asarray(rng.integers(0, 1 << 30, size=2048).astype(np.uint32))
    v = jnp.arange(2048, dtype=jnp.int32)
    want = registry.get("sort", "xla")(k, v)
    for name in ("radix",):
        got = registry.get("sort", name)(k, v)
        np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(want[0]))
        np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(want[1]))


def test_checkpoint_roundtrip(tmp_path):
    scene = build_scene(cube_mesh(size=2.0))
    bvh = build_bvh(scene)
    path = str(tmp_path / "scene.npz")
    save_checkpoint(path, scene, bvh)
    scene2, bvh2 = load_checkpoint(path)
    assert scene2.count == scene.count and bvh2.count == bvh.count
    np.testing.assert_array_equal(np.asarray(bvh2.left), np.asarray(bvh.left))
    np.testing.assert_array_equal(
        np.asarray(bvh2.node_aabb_min), np.asarray(bvh.node_aabb_min)
    )
    # Restored BVH renders identically.
    from unitysimpleraytracing import make_camera, render_hits

    cam = make_camera(eye=(3, 2.5, 4), target=(0, 0, 0), width=32, height=32)
    a = render_hits(scene, bvh, cam)
    b = render_hits(scene2, bvh2, cam)
    np.testing.assert_array_equal(np.asarray(a.t), np.asarray(b.t))


def test_debug_helpers():
    s = debug.array_to_string(np.arange(10), limit=4)
    assert s.startswith("0 1 2 3") and s.endswith("…")
    out = debug.probe_kernel(lambda x: x * 2, jnp.arange(4))
    np.testing.assert_array_equal(out, [0, 2, 4, 6])


def test_profiler_report_and_roofline():
    prof = profiling.Profiler()
    with prof.op("noop", bytes_accessed=1 << 20, flops=1 << 20):
        pass
    rep = prof.report()
    assert "noop" in rep and "GB/s" in rep
    s = profiling.OpStats("x", seconds=1.0, bytes_accessed=3_350_000_000_000)
    peaks = profiling.device_peaks("NVIDIA H100 80GB HBM3")
    frac = s.roofline_fraction(peaks["hbm_gbytes_s"], peaks["f32_gflops"])
    assert abs(frac - 1.0) < 1e-6
    assert profiling.sort_bytes(1 << 20) == 4 * 16 * (1 << 20)


def test_chunked_checkpoint_roundtrip(tmp_path):
    """ChunkedBvh persistence: restore must trace bit-identically to the
    in-memory build (tables, per-chunk trees and the shard map all carried)."""
    import unitysimpleraytracing as rt
    from unitysimpleraytracing.io.checkpoint import (
        load_chunked_checkpoint, save_chunked_checkpoint,
    )

    scene = build_scene(rt.random_triangle_soup(3000, seed=5, bound=9.0,
                                                tri_size=0.8))
    cbvh = rt.build_bvh_chunked(scene, chunk_capacity=1024)
    path = str(tmp_path / "chunked.npz")
    save_chunked_checkpoint(path, cbvh)
    cbvh2 = load_chunked_checkpoint(path)
    assert cbvh2.num_chunks == cbvh.num_chunks
    np.testing.assert_array_equal(np.asarray(cbvh2.tables), np.asarray(cbvh.tables))

    rng = np.random.default_rng(6)
    o = jnp.asarray(rng.uniform(-11, 11, size=(1024, 3)), jnp.float32)
    d = rng.normal(size=(1024, 3))
    d = jnp.asarray(d / np.linalg.norm(d, axis=1, keepdims=True), jnp.float32)
    a = rt.trace_chunked(cbvh, o, d)
    b = rt.trace_chunked(cbvh2, o, d)
    np.testing.assert_array_equal(np.asarray(a.t), np.asarray(b.t))
    np.testing.assert_array_equal(np.asarray(a.tri), np.asarray(b.tri))
