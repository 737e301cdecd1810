"""Frozen dataclasses registered as JAX pytrees.

Array fields are pytree children, so the containers flow through ``jit``,
``vmap`` and ``shard_map``; fields declared with `static_field` (element
counts, image sizes) are static metadata, which keeps every shape static
under tracing.
"""
from __future__ import annotations

import dataclasses

import jax


def static_field(**kwargs):
    """A dataclass field carried as static pytree metadata."""
    return dataclasses.field(metadata={"static": True}, **kwargs)


def pytree_dataclass(cls):
    """Make ``cls`` a frozen dataclass, register it as a pytree, and give it
    ``replace(**changes)``."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = dataclasses.fields(cls)
    jax.tree_util.register_dataclass(
        cls,
        data_fields=[f.name for f in fields if not f.metadata.get("static")],
        meta_fields=[f.name for f in fields if f.metadata.get("static")],
    )
    cls.replace = dataclasses.replace
    return cls
