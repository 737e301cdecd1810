"""Scene/BVH checkpointing.

The reference rebuilds the BVH from scratch every ``Awake`` and serializes
nothing (SURVEY §5: "Checkpoint / resume: none").  For static scenes the sort
+ topology + refit is pure preprocessing, so this module adds what the
reference lacks: persist a built ``Bvh`` (and the ``Scene`` it indexes) to a
single ``.npz`` and restore it without recomputation — the render path then
starts at traversal.

Format: one compressed npz; scene/bvh arrays under ``scene/<field>`` and
``bvh/<field>`` keys, logical counts under ``meta/*``.  Everything is plain
numpy — no pickle, no framework objects — so checkpoints are portable across
JAX versions and hosts.
"""
from __future__ import annotations

import numpy as np

from unitysimpleraytracing.core.types import Bvh, Scene, Triangles

_TRI_FIELDS = (
    "a", "b", "c", "a_uv", "b_uv", "c_uv", "a_normal", "b_normal", "c_normal"
)
_SCENE_FIELDS = ("aabb_min", "aabb_max", "morton", "tri_index")
_BVH_FIELDS = (
    "left", "right", "left_is_leaf", "right_is_leaf",
    "internal_parent", "leaf_parent", "range_first", "range_last",
    "split_axis", "node_aabb_min", "node_aabb_max", "sorted_tri", "depth",
)
_FORMAT_VERSION = 2  # v2: + range_first/range_last/split_axis


def save_checkpoint(path: str, scene: Scene, bvh: Bvh) -> None:
    """Write scene + built BVH to ``path`` (.npz, compressed)."""
    data = {"meta/version": np.int64(_FORMAT_VERSION),
            "meta/scene_count": np.int64(scene.count),
            "meta/bvh_count": np.int64(bvh.count)}
    for f in _TRI_FIELDS:
        data[f"tri/{f}"] = np.asarray(getattr(scene.triangles, f))
    for f in _SCENE_FIELDS:
        data[f"scene/{f}"] = np.asarray(getattr(scene, f))
    for f in _BVH_FIELDS:
        data[f"bvh/{f}"] = np.asarray(getattr(bvh, f))
    np.savez_compressed(path, **data)


_SSCENE_FIELDS = (
    "tri_a", "tri_b", "tri_c", "a_uv", "b_uv", "c_uv",
    "a_normal", "b_normal", "c_normal", "aabb_min", "aabb_max",
    "morton", "global_tri", "counts", "range_min", "range_max",
)


def save_chunked_checkpoint(path: str, cbvh) -> None:
    """Persist a ``ChunkedBvh`` (pipeline/chunked.py) to one ``.npz``.

    The chunked build is the expensive one (partition + S per-chunk
    sweep-SAH trees + table packing — tens of seconds cold at 1M tris), and
    it exists only for static scenes, so persisting it is the high-value
    resume path: restore + trace with zero rebuild."""
    data = {"meta/version": np.int64(_FORMAT_VERSION),
            "meta/kind": np.bytes_(b"chunked"),
            "meta/bvh_count": np.int64(cbvh.bvhs.count)}
    for f in _SSCENE_FIELDS:
        data[f"sscene/{f}"] = np.asarray(getattr(cbvh.sscene, f))
    for f in _BVH_FIELDS:
        data[f"cbvh/{f}"] = np.asarray(getattr(cbvh.bvhs, f))
    data["cbvh/tables"] = np.asarray(cbvh.tables)
    np.savez_compressed(path, **data)


def load_chunked_checkpoint(path: str):
    """Restore a ``ChunkedBvh`` saved by :func:`save_chunked_checkpoint`."""
    import jax.numpy as jnp

    from unitysimpleraytracing.parallel.dist import ShardedScene
    from unitysimpleraytracing.pipeline.chunked import ChunkedBvh

    z = np.load(path)
    version = int(z["meta/version"])
    if version != _FORMAT_VERSION:
        raise ValueError(f"checkpoint version {version} != {_FORMAT_VERSION}")
    if bytes(z["meta/kind"]) != b"chunked":
        raise ValueError("not a chunked checkpoint (use load_checkpoint)")
    sscene = ShardedScene(
        **{f: jnp.asarray(z[f"sscene/{f}"]) for f in _SSCENE_FIELDS}
    )
    bvhs = Bvh(
        **{f: jnp.asarray(z[f"cbvh/{f}"]) for f in _BVH_FIELDS},
        count=int(z["meta/bvh_count"]),
    )
    return ChunkedBvh(
        sscene=sscene, bvhs=bvhs, tables=jnp.asarray(z["cbvh/tables"])
    )


def load_checkpoint(path: str) -> tuple[Scene, Bvh]:
    """Restore (scene, bvh) saved by :func:`save_checkpoint`."""
    import jax.numpy as jnp

    z = np.load(path)
    version = int(z["meta/version"])
    if version != _FORMAT_VERSION:
        raise ValueError(f"checkpoint version {version} != {_FORMAT_VERSION}")
    scene_count = int(z["meta/scene_count"])
    bvh_count = int(z["meta/bvh_count"])

    tris = Triangles(
        **{f: jnp.asarray(z[f"tri/{f}"]) for f in _TRI_FIELDS}, count=scene_count
    )
    scene = Scene(
        triangles=tris,
        **{f: jnp.asarray(z[f"scene/{f}"]) for f in _SCENE_FIELDS},
        count=scene_count,
    )
    bvh = Bvh(
        **{f: jnp.asarray(z[f"bvh/{f}"]) for f in _BVH_FIELDS}, count=bvh_count
    )
    return scene, bvh
