"""Pipeline-parallel build/trace staging (SURVEY §2 PP row): the pipelined
dynamic-frame stream must equal serial per-frame renders, bit for bit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import unitysimpleraytracing as rt
from unitysimpleraytracing.ops import dispatch, trace
from unitysimpleraytracing.parallel import pipeline_pp
from unitysimpleraytracing.pipeline.build import deform_scene

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 2, reason="needs 2 devices"
)


def test_pipelined_frames_match_serial():
    mesh_obj = rt.random_triangle_soup(160, seed=11, bound=4.0, tri_size=1.0)
    scene = rt.build_scene(mesh_obj)
    t = scene.triangles
    base = jnp.stack([t.a, t.b, t.c], axis=1)  # (cap, 3, 3)
    F = 4
    phases = jnp.linspace(0.0, 2.0, F)
    positions = jax.vmap(
        lambda p: base.at[..., 1].add(0.3 * jnp.sin(base[..., 0] + p))
    )(phases)

    rng = np.random.default_rng(11)
    origins = jnp.asarray(rng.uniform(-6, 6, (256, 3)), jnp.float32)
    d = rng.normal(size=(256, 3))
    origins_d = jnp.asarray(d / np.linalg.norm(d, axis=1, keepdims=True), jnp.float32)

    mesh = pipeline_pp.make_pp_mesh()
    # Production engine (auto -> packet on CPU) vs a serial render with the
    # SAME engine: bit-exact.  A second stream through the reference/debug
    # perray engine pins the impl plumbing (VERDICT r2: the trace stage used
    # to hardcode perray).
    got = pipeline_pp.render_frames_pipelined(
        scene, positions, origins, origins_d, mesh
    )
    got_perray = pipeline_pp.render_frames_pipelined(
        scene, positions, origins, origins_d, mesh, impl="perray"
    )
    assert got.t.shape == (F, 256)

    for i in range(F):
        s2 = deform_scene(scene, positions[i])
        bvh = rt.build_bvh(s2)
        ref = dispatch.trace_rays(s2, bvh, origins, origins_d, impl="auto")
        np.testing.assert_array_equal(np.asarray(got.t[i]), np.asarray(ref.t))
        hit = np.asarray(ref.t) < rt.constants.MAX_FLOAT
        np.testing.assert_array_equal(
            np.asarray(got.tri[i])[hit], np.asarray(ref.tri)[hit]
        )
        ref_pr = trace.traverse(s2, bvh, origins, origins_d)
        np.testing.assert_array_equal(
            np.asarray(got_perray.t[i]), np.asarray(ref_pr.t)
        )
