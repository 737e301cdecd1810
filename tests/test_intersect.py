"""Slab + Möller–Trumbore vs the scalar CPU replicas (the reference's
_debugRayBoxIntersectionTester pattern, applied exhaustively)."""
import jax.numpy as jnp
import numpy as np

from unitysimpleraytracing.ops import intersect
from unitysimpleraytracing.utils import reference_impl


def test_ray_box_random():
    rng = np.random.default_rng(0)
    n = 512
    bmin = rng.uniform(-2, 0, size=(n, 3)).astype(np.float32)
    bmax = bmin + rng.uniform(0.1, 2, size=(n, 3)).astype(np.float32)
    origins = rng.uniform(-4, 4, size=(n, 3)).astype(np.float32)
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    inv = (1.0 / dirs).astype(np.float32)

    got = np.asarray(
        intersect.ray_box(jnp.asarray(bmin), jnp.asarray(bmax), jnp.asarray(origins), jnp.asarray(inv))
    )
    want = np.array(
        [reference_impl.ray_box(bmin[i], bmax[i], origins[i], inv[i]) for i in range(n)]
    )
    np.testing.assert_array_equal(got, want)


def test_ray_box_axis_aligned_rays():
    # Zero direction components → inv_dir = ±inf; NaNs when a slab coincides
    # with the origin. Must match D3D min/max semantics, not IEEE-propagate.
    bmin = np.array([[0, 0, 0]], np.float32)
    bmax = np.array([[1, 1, 1]], np.float32)
    cases = [
        ([0.5, 0.5, -1], [0, 0, 1], True),    # enters through z
        ([0.5, 0.5, -1], [0, 0, -1], False),  # points away
        ([0.5, 0.5, 0.5], [0, 0, 1], True),   # origin inside
        ([2.0, 0.5, -1], [0, 0, 1], False),   # parallel, outside x slab
        ([0.0, 0.5, -1], [0, 0, 1], None),    # origin ON x slab → 0*inf NaN
        ([1.0, 0.5, 0.5], [0, 1, 0], None),   # origin on max x slab
    ]
    for origin, d, expect in cases:
        o = np.array([origin], np.float32)
        dd = np.array([d], np.float32)
        with np.errstate(divide="ignore"):
            inv = (1.0 / dd).astype(np.float32)
        got = bool(
            np.asarray(
                intersect.ray_box(jnp.asarray(bmin), jnp.asarray(bmax), jnp.asarray(o), jnp.asarray(inv))
            )[0]
        )
        want = reference_impl.ray_box(bmin[0], bmax[0], o[0], inv[0])
        assert got == want, f"mismatch for origin={origin} dir={d}"
        if expect is not None:
            assert got == expect


def test_ray_triangle_random():
    rng = np.random.default_rng(1)
    n = 512
    v0 = rng.uniform(-1, 1, size=(n, 3)).astype(np.float32)
    v1 = v0 + rng.uniform(-1, 1, size=(n, 3)).astype(np.float32)
    v2 = v0 + rng.uniform(-1, 1, size=(n, 3)).astype(np.float32)
    origins = rng.uniform(-3, 3, size=(n, 3)).astype(np.float32)
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)

    t, u, v = intersect.ray_triangle(
        jnp.asarray(origins), jnp.asarray(dirs), jnp.asarray(v0), jnp.asarray(v1), jnp.asarray(v2)
    )
    t, u, v = np.asarray(t), np.asarray(u), np.asarray(v)
    for i in range(n):
        rt, ru, rv = reference_impl.ray_triangle(origins[i], dirs[i], v0[i], v1[i], v2[i])
        assert t[i] == rt or (abs(t[i] - rt) < 1e-5), f"t mismatch at {i}: {t[i]} vs {rt}"
        if rt != reference_impl.MAX_FLOAT:
            np.testing.assert_allclose(u[i], ru, atol=1e-5)
            np.testing.assert_allclose(v[i], rv, atol=1e-5)


def test_ray_triangle_degenerate_and_behind():
    o = np.array([[0, 0, 2]], np.float32)
    d = np.array([[0, 0, -1]], np.float32)
    # Degenerate (zero-area) triangle → det≈0 → reject.
    z = np.array([[0, 0, 0]], np.float32)
    t, _, _ = intersect.ray_triangle(jnp.asarray(o), jnp.asarray(d), jnp.asarray(z), jnp.asarray(z), jnp.asarray(z))
    assert np.asarray(t)[0] == reference_impl.MAX_FLOAT
    # Triangle BEHIND the origin: reference has no t>0 test → negative t.
    v0 = np.array([[-1, -1, 3]], np.float32)
    v1 = np.array([[1, -1, 3]], np.float32)
    v2 = np.array([[0, 1, 3]], np.float32)
    t, _, _ = intersect.ray_triangle(jnp.asarray(o), jnp.asarray(d), jnp.asarray(v0), jnp.asarray(v1), jnp.asarray(v2))
    assert np.asarray(t)[0] == -1.0
