"""Worker for the two-process jax.distributed smoke test (run by
tests/test_multiprocess.py):

    python tests/_mp_worker.py <coordinator> <num_procs> <pid>

Exit codes: 0 = success, 42 = environment cannot run multi-process CPU
(skippable), anything else = real failure.
"""
from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

coordinator, nprocs, pid = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=4"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from unitysimpleraytracing.parallel import multihost  # noqa: E402

try:
    ok = multihost.initialize(
        coordinator_address=coordinator, num_processes=nprocs, process_id=pid
    )
except Exception as e:  # backend/transport unavailable -> skippable
    print(f"init unavailable: {e}", file=sys.stderr)
    sys.exit(42)
if not ok:
    print("initialize() returned False", file=sys.stderr)
    sys.exit(42)

assert jax.process_count() == nprocs, jax.process_count()
assert jax.local_device_count() == 4

# Host-aware mesh: tp packed within each process, dp spanning processes.
mesh = multihost.make_host_mesh(tp_per_host=4)
assert mesh.shape == {"dp": nprocs, "tp": 4}, mesh.shape
for row in range(nprocs):
    owners = {d.process_index for d in mesh.devices[row]}
    assert owners == {row}, f"tp row {row} spans processes {owners}"

# One ring render step across both processes.
import jax.numpy as jnp  # noqa: E402
from jax.experimental import multihost_utils  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

import unitysimpleraytracing as rt  # noqa: E402
from unitysimpleraytracing.ops import trace  # noqa: E402
from unitysimpleraytracing.parallel import dist  # noqa: E402

mesh_obj = rt.random_triangle_soup(96, seed=5, bound=4.0, tri_size=1.0)
scene = rt.build_scene(mesh_obj)
bvh = rt.build_bvh(scene)
ss = dist.partition_scene(scene, 4)
rng = np.random.default_rng(5)
origins = jnp.asarray(rng.uniform(-6, 6, size=(64, 3)), jnp.float32)
dirs = rng.normal(size=(64, 3))
dirs = jnp.asarray(dirs / np.linalg.norm(dirs, axis=1, keepdims=True), jnp.float32)

# Same host values on every process -> replicate globally, let jit reshard.
rep = NamedSharding(mesh, P())
ss, origins, dirs = jax.device_put((ss, origins, dirs), rep)


@jax.jit
def step(ss, o, d):
    return dist.render_hits_ring(ss, o, d, mesh)


out = step(ss, origins, dirs)
t = np.asarray(multihost_utils.process_allgather(out[0], tiled=True)).reshape(-1)
ref = np.asarray(trace.traverse(scene, bvh, jnp.asarray(origins), jnp.asarray(dirs)).t)
np.testing.assert_array_equal(t, ref)
print(f"proc {pid}: ring step exact over {nprocs} processes")

# --- per-host scene ingest (multihost.host_shard_bounds consumer) ---------
# Each host loads ONLY its contiguous triangle range and derives its own
# AABB/Morton arrays against the reference's fixed parity box (the Morton
# normalization must not depend on which triangles a host sees,
# MeshBufferContainer.cs:9-15); the gathered per-host pieces must equal the
# single-host ingest of the full mesh, bit for bit.
from unitysimpleraytracing.core.mesh import MeshData  # noqa: E402

n = mesh_obj.num_triangles
lo, hi = multihost.host_shard_bounds(n, nprocs, pid)
local_mesh = MeshData(
    positions=mesh_obj.positions[lo:hi],
    uvs=mesh_obj.uvs[lo:hi],
    normals=mesh_obj.normals[lo:hi],
)
local = rt.build_scene(local_mesh, scene_bound=rt.constants.PARITY_SCENE_BOUND)
full = rt.build_scene(mesh_obj, scene_bound=rt.constants.PARITY_SCENE_BOUND)
m = hi - lo
pieces = {
    "morton": np.asarray(local.morton)[:m],
    "aabb_min": np.asarray(local.aabb_min)[:m],
    "aabb_max": np.asarray(local.aabb_max)[:m],
    "tri_global": np.asarray(local.tri_index)[:m] + lo,
}
gathered = {
    k: np.asarray(multihost_utils.process_allgather(jnp.asarray(v), tiled=True))
    for k, v in pieces.items()
}
np.testing.assert_array_equal(gathered["morton"], np.asarray(full.morton)[:n])
np.testing.assert_array_equal(gathered["aabb_min"], np.asarray(full.aabb_min)[:n])
np.testing.assert_array_equal(gathered["aabb_max"], np.asarray(full.aabb_max)[:n])
np.testing.assert_array_equal(gathered["tri_global"], np.arange(n))
print(f"proc {pid}: per-host ingest [{lo},{hi}) matches full ingest")
sys.exit(0)
