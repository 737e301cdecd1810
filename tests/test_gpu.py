"""On-card checks of the GPU traversal kernel (compiled through Triton, not
interpreted).  They skip on the CPU; run them on a card with
``RT_TEST_GPU=1 python -m pytest -m gpu tests/test_gpu.py``."""
import jax.numpy as jnp
import numpy as np
import pytest

import unitysimpleraytracing as rt
from unitysimpleraytracing.ops import dispatch, trace, trace_gpu

pytestmark = pytest.mark.gpu


def _rays(n, seed, bound=8.0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-bound, bound, size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d)


def test_auto_picks_the_compiled_kernel(gpu):
    assert dispatch.resolve_impl("auto", 65_000) == "gpu"


@pytest.mark.parametrize("builder", ["karras", "sah_free"])
def test_compiled_kernel_matches_perray(gpu, builder):
    scene = rt.build_scene(rt.terrain_mesh(res=64, size=40.0, amplitude=6.0, seed=0))
    bvh = rt.build_bvh(scene, builder=builder)
    o, d = _rays(8192, seed=1, bound=25.0)
    got = trace_gpu.traverse(scene, bvh, o, d)
    ref = trace.traverse(scene, bvh, o, d)
    hit = np.asarray(ref.hit)
    np.testing.assert_array_equal(np.asarray(got.hit), hit)
    np.testing.assert_allclose(np.asarray(got.t)[hit], np.asarray(ref.t)[hit], rtol=4e-6)
    mism = (np.asarray(got.tri) != np.asarray(ref.tri)) & hit
    tied = np.abs(np.asarray(got.t) - np.asarray(ref.t)) <= 4e-6 * np.abs(np.asarray(ref.t))
    assert not np.any(mism & ~tied)
