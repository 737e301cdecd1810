"""Operator/engine registry — the L0 kernel-binding substrate.

Analog of the reference's ``ShaderContainer``
(``Assets/_Scripts/ShaderContainer.cs:6-41``): where Unity serializes five
compute-shader asset references behind ``IShaderContainer`` and hands kernel
handles to each pipeline stage, this registry maps (stage, impl-name) to the
callable engine, so orchestration code selects implementations by name and
new engines (a faster kernel, a debug reference) register without touching
call sites.

Stages and their engines:

- ``sort``:     "xla" (lax.sort_key_val), "radix" (vectorized XLA radix)
- ``scan``:     "xla" (cumsum)
- ``traverse``: "perray" (per-ray stacks), "packet" (XLA shared-stack),
                "gpu" (one-ray-per-lane BVH4 kernel, ops/trace_gpu — the
                production engine on a GPU)
- ``exchange``: the multi-device ray-exchange strategies (parallel/dist):
                "gather" (all_gather combine), "ring" (ppermute
                circulation), "shuffle" (rays routed by root-box overlap)
- ``topology``: BVH builders over the sorted leaf order: "karras" (the
                reference's radix tree, ops/lbvh — parity surface),
                "sah" (sweep SAH, ops/sah — static-scene quality)
"""
from __future__ import annotations

from typing import Callable

_REGISTRY: dict[str, dict[str, Callable]] = {}


def register(stage: str, name: str, fn: Callable | None = None):
    """Register an engine; usable directly or as a decorator."""

    def _do(f):
        _REGISTRY.setdefault(stage, {})[name] = f
        return f

    return _do(fn) if fn is not None else _do


def get(stage: str, name: str) -> Callable:
    try:
        return _REGISTRY[stage][name]
    except KeyError:
        raise KeyError(
            f"no engine {name!r} for stage {stage!r}; "
            f"available: {sorted(_REGISTRY.get(stage, {}))}"
        ) from None


def engines(stage: str) -> list[str]:
    return sorted(_REGISTRY.get(stage, {}))


def stages() -> list[str]:
    return sorted(_REGISTRY)


def _register_builtins() -> None:
    """Bind the built-in engines (deferred imports keep this module light)."""
    import jax
    import jax.numpy as jnp

    from unitysimpleraytracing.ops import sort as sort_ops
    from unitysimpleraytracing.ops import trace, trace_gpu, trace_packet

    register("sort", "xla", lambda k, v: jax.lax.sort_key_val(k, v, is_stable=True))
    register("sort", "radix", sort_ops.radix_sort_key_val)

    register(
        "scan", "xla",
        lambda x: jnp.concatenate([jnp.zeros((1,), x.dtype), jnp.cumsum(x)[:-1]]),
    )

    register("traverse", "perray", trace.traverse)
    register("traverse", "packet", trace_packet.traverse_packets)
    register("traverse", "gpu", trace_gpu.traverse)

    from unitysimpleraytracing.parallel import dist

    register("exchange", "gather", dist.render_hits_sharded)
    register("exchange", "ring", dist.render_hits_ring)
    register("exchange", "shuffle", dist.render_hits_shuffle)

    from unitysimpleraytracing.ops import lbvh, sah

    register("topology", "karras", lbvh.build_bvh_from_sorted)
    register("topology", "sah", sah.build_bvh_sah_from_sorted)


_register_builtins()
