"""Struct-of-arrays scene and BVH containers (registered JAX pytrees).

The reference mirrors packed C# structs against an HLSL ABI with explicit
16-byte padding (``Assets/_Scripts/SceneDataTypes.cs:4-90``,
``Assets/_Shaders/Constants.cginc:9-54``). Here there is no interop ABI to
match — the natural layout is struct-of-arrays so that every field is a
vectorizable (N, k) array. All containers are pytree dataclasses
(core/pytree.py), so they flow through ``jit``/``shard_map``; logical element
counts are static (non-pytree) fields, which keeps every shape static under
tracing.
"""
from __future__ import annotations

import jax.numpy as jnp

from unitysimpleraytracing.core.pytree import pytree_dataclass, static_field


@pytree_dataclass
class Triangles:
    """SoA triangle data (reference ``Triangle`` struct, Constants.cginc:36-54).

    Arrays are padded to ``capacity`` rows; only the first ``count`` are real.
    """

    a: jnp.ndarray          # (cap, 3) f32 vertex positions
    b: jnp.ndarray          # (cap, 3) f32
    c: jnp.ndarray          # (cap, 3) f32
    a_uv: jnp.ndarray       # (cap, 2) f32
    b_uv: jnp.ndarray       # (cap, 2) f32
    c_uv: jnp.ndarray       # (cap, 2) f32
    a_normal: jnp.ndarray   # (cap, 3) f32
    b_normal: jnp.ndarray   # (cap, 3) f32
    c_normal: jnp.ndarray   # (cap, 3) f32
    count: int = static_field()

    @property
    def capacity(self) -> int:
        return self.a.shape[0]


@pytree_dataclass
class Scene:
    """Everything the build pipeline consumes: triangles + derived per-triangle
    data (reference ``MeshBufferContainer`` buffer set, MeshBufferContainer.cs:108-115).
    """

    triangles: Triangles
    aabb_min: jnp.ndarray   # (cap, 3) f32 — per-triangle AABB, inflated 1e-3
    aabb_max: jnp.ndarray   # (cap, 3) f32
    morton: jnp.ndarray     # (cap,) uint32 — 30-bit codes; padding = 0xFFFFFFFF
    tri_index: jnp.ndarray  # (cap,) int32 — 0..n-1; padding = capacity-1 clamp-safe
    count: int = static_field()

    @property
    def capacity(self) -> int:
        return self.morton.shape[0]


@pytree_dataclass
class Bvh:
    """Karras LBVH in SoA form.

    The reference's ``InternalNode``/``LeafNode`` structs (Constants.cginc:22-34)
    carry per-node child ids + type tags + parent links; here each field is its
    own array.  ``left[i] == split(i)`` and ``right[i] == split(i)+1`` by
    construction (BVH.compute:111-148), and a leaf's payload index equals its
    position (``leafNodes[s] = {parent, s}``), so no leaf index array is stored.

    Node id space: internal node i ∈ [0, n-1), leaf j ∈ [0, n); node 0 is root.
    """

    left: jnp.ndarray         # (cap,) i32 — left child id (leaf or internal)
    right: jnp.ndarray        # (cap,) i32
    left_is_leaf: jnp.ndarray   # (cap,) bool
    right_is_leaf: jnp.ndarray  # (cap,) bool
    internal_parent: jnp.ndarray  # (cap,) i32 — parent of internal node; -1 at root
    leaf_parent: jnp.ndarray      # (cap,) i32 — parent of each leaf
    range_first: jnp.ndarray      # (cap,) i32 — first sorted-leaf index covered
    range_last: jnp.ndarray       # (cap,) i32 — last sorted-leaf index covered
    split_axis: jnp.ndarray       # (cap,) i32 — Morton axis of the split bit
                                  # (0=x,1=y,2=z); traversal ordering hint
    node_aabb_min: jnp.ndarray    # (cap, 3) f32 — internal-node AABBs (refit output)
    node_aabb_max: jnp.ndarray    # (cap, 3) f32
    sorted_tri: jnp.ndarray       # (cap,) i32 — Morton-sorted triangle indices
    depth: jnp.ndarray            # (cap,) i32 — internal-node depth from root
    count: int = static_field()  # number of leaves (= triangles)

    @property
    def capacity(self) -> int:
        return self.left.shape[0]

    @property
    def num_internal(self) -> int:
        return self.count - 1


@pytree_dataclass
class HitRecord:
    """Per-ray nearest-hit result (reference ``RaycastResult``,
    Raytracing.compute:31-36). ``t == MAX_FLOAT`` means miss; ``tri`` defaults
    to 0 on miss exactly like the reference (Raytracing.compute:129-131)."""

    t: jnp.ndarray    # (R,) f32 hit distance
    tri: jnp.ndarray  # (R,) i32 triangle index (unsorted id)
    u: jnp.ndarray    # (R,) f32 barycentric u
    v: jnp.ndarray    # (R,) f32 barycentric v

    @property
    def hit(self) -> jnp.ndarray:
        import unitysimpleraytracing.constants as C
        return self.t != C.MAX_FLOAT
