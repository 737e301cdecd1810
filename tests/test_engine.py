"""The traversal engine's surroundings on the CPU: the wrapper's padding and
choice of engine, the chunked/batched/animated paths through the GPU kernel
(Pallas interpreter), pytree containers, the compile-cache location, the
device peak table and the chip smoke script's refusal to run without a GPU."""
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import unitysimpleraytracing as rt
from unitysimpleraytracing.core.pytree import pytree_dataclass, static_field
from unitysimpleraytracing.ops import dispatch, trace, trace_gpu
from unitysimpleraytracing.utils import compile_cache, profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rays(n, seed, bound=8.0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-bound, bound, size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d)


def _close(got, ref, rtol=4e-6):
    t_r, t_g = np.asarray(ref.t), np.asarray(got.t)
    hit = t_r != rt.constants.MAX_FLOAT
    np.testing.assert_array_equal(t_g != rt.constants.MAX_FLOAT, hit)
    np.testing.assert_allclose(t_g[hit], t_r[hit], rtol=rtol)
    mism = (np.asarray(got.tri) != np.asarray(ref.tri)) & hit
    tied = np.abs(t_g - t_r) <= rtol * np.abs(t_r)
    assert not np.any(mism & ~tied)


@pytest.fixture(scope="module")
def soup():
    scene = rt.build_scene(rt.random_triangle_soup(200, seed=3, bound=5.0, tri_size=1.0))
    return scene, rt.build_bvh(scene)


@pytest.mark.parametrize("n_rays", [1, 31, 33, 100, 1000])
def test_trace_rays_pads_ray_count(soup, n_rays):
    """Any R works: the wrapper pads to the kernel's block and slices back."""
    scene, bvh = soup
    o, d = _rays(n_rays, seed=n_rays)
    got = dispatch.trace_rays(scene, bvh, o, d, impl="gpu")
    assert got.t.shape == (n_rays,) and got.tri.shape == (n_rays,)
    _close(got, trace.traverse(scene, bvh, o, d))


@pytest.mark.parametrize(
    "backend,impl,want",
    [("cpu", "auto", "packet"), ("gpu", "auto", "gpu"), ("gpu", "perray", "perray")],
)
def test_resolve_impl_per_backend(monkeypatch, backend, impl, want):
    monkeypatch.setattr(dispatch.jax, "default_backend", lambda: backend)
    assert dispatch.resolve_impl(impl, 65_000) == want


@pytest.mark.parametrize("backend", ["cpu", "gpu"])
def test_interpreter_only_on_cpu(monkeypatch, soup, backend):
    """The kernel runs in the Pallas interpreter only on the CPU backend."""
    seen = {}

    def fake(scene, bvh, o, d, **kw):
        seen.update(kw)
        z = jnp.zeros((o.shape[0],), jnp.float32)
        return rt.HitRecord(t=z, tri=z.astype(jnp.int32), u=z, v=z)

    monkeypatch.setattr(dispatch.jax, "default_backend", lambda: backend)
    monkeypatch.setattr(dispatch.trace_gpu, "traverse", fake)
    scene, bvh = soup
    o, d = _rays(64, seed=0)
    dispatch.trace_rays(scene, bvh, o, d, impl="gpu")
    assert seen["interpret"] is (backend == "cpu")


def test_chunked_fold_through_gpu_engine():
    scene = rt.build_scene(rt.random_triangle_soup(3000, seed=5, bound=9.0, tri_size=0.8))
    cbvh = rt.build_bvh_chunked(scene, chunk_capacity=1024)
    o, d = _rays(512, seed=6, bound=11.0)
    _close(rt.trace_chunked(cbvh, o, d, impl="gpu"), rt.trace_chunked(cbvh, o, d, impl="packet"))
    occ_g = rt.occluded_chunked(cbvh, o, d, impl="gpu")
    occ_p = rt.occluded_chunked(cbvh, o, d, impl="packet")
    np.testing.assert_array_equal(np.asarray(occ_g), np.asarray(occ_p))


def test_render_frames_through_gpu_engine():
    scene = rt.build_scene(rt.terrain_mesh(res=12, size=12.0, amplitude=2.0, seed=0))
    bvh = rt.build_bvh(scene)
    cams = [
        rt.make_camera(eye=e, target=(0, 0, 0), width=32, height=32)
        for e in ((9.0, 7.0, 11.0), (-9.0, 6.0, 10.0))
    ]
    stack = jax.tree.map(lambda *xs: jnp.stack(xs), *cams)
    tex = rt.solid_texture((0.8, 0.7, 0.6, 1.0))
    bg = np.zeros(3, np.float32)
    got = np.asarray(rt.render_frames(scene, bvh, stack, tex, bg, impl="gpu", shadows=True))
    for i, cam in enumerate(cams):
        want = np.asarray(rt.render_frame(scene, bvh, cam, tex, bg, impl="packet", shadows=True))
        assert float((np.abs(got[i] - want) > 2 / 255).mean()) < 0.002


def test_animated_renderer_through_gpu_engine():
    scene = rt.build_scene(rt.terrain_mesh(res=12, size=12.0, amplitude=2.0, seed=0))
    bvh = rt.build_bvh(scene)
    cam = rt.make_camera(eye=(9.0, 7.0, 11.0), target=(0, 0, 0), width=32, height=32)
    t = scene.triangles
    pos = jnp.stack([t.a, t.b, t.c], axis=1).at[..., 1].add(0.3)
    got = rt.make_animated_renderer(scene, bvh, cam, impl="gpu")(pos)
    s2 = rt.deform_scene(scene, pos)
    want = rt.render_hits(s2, rt.refit_bvh(s2, bvh), cam, impl="perray")
    _close(got, want)


@pytree_dataclass
class _Box:
    data: jnp.ndarray
    count: int = static_field()


def test_pytree_replace_keeps_other_fields():
    b = _Box(data=jnp.arange(3), count=3)
    c = b.replace(data=jnp.zeros(3))
    assert c.count == 3 and b.data is not c.data
    with pytest.raises(Exception):
        b.count = 4  # frozen


def test_pytree_static_fields_are_metadata():
    b = _Box(data=jnp.arange(3), count=3)
    leaves, treedef = jax.tree_util.tree_flatten(b)
    assert len(leaves) == 1
    assert jax.tree_util.tree_unflatten(treedef, leaves).count == 3


def test_pytree_flows_through_jit():
    @jax.jit
    def f(b):
        return b.replace(data=b.data * b.count)

    out = f(_Box(data=jnp.arange(3), count=2))
    np.testing.assert_array_equal(np.asarray(out.data), [0, 2, 4])
    assert out.count == 2


def test_compile_cache_follows_env(monkeypatch, tmp_path):
    monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path))
    assert compile_cache.cache_dir() == str(tmp_path)


def test_compile_cache_default_inside_checkout(monkeypatch):
    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    path = compile_cache.cache_dir()
    assert path == os.path.join(REPO, ".jax_cache")


def test_device_peaks_known_kind():
    peaks = profiling.device_peaks("NVIDIA H100 80GB HBM3")
    assert peaks["hbm_gbytes_s"] == 3350.0 and peaks["f32_gflops"] == 67_000.0


def test_device_peaks_unknown_kind_raises():
    with pytest.raises(KeyError):
        profiling.device_peaks("cpu")


def _run_smoke(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


def test_chip_smoke_refuses_without_gpu():
    proc = _run_smoke(REPO)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_chip_smoke_refuses_outside_the_repo(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path / "chip_smoke.py")
    proc = _run_smoke(str(tmp_path))
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
