"""Persistent XLA compilation cache location.

``JAX_COMPILATION_CACHE_DIR``, when set, is where JAX keeps its cache, and
nothing here overrides it.  Otherwise the cache goes to one fixed directory
inside the checkout (``.jax_cache``, listed in ``.gitignore``): the path is
part of the cache key, so a directory that moves never hits.
"""
from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def cache_dir() -> str:
    """The directory the persistent cache uses."""
    return os.environ.get(ENV_VAR) or DEFAULT_DIR


def enable() -> str:
    """Turn the persistent cache on (CLI, benchmarks, chip smoke run) for
    every compile over 0.3 s, and return its directory."""
    import jax

    path = cache_dir()
    if not os.environ.get(ENV_VAR):
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.3)
    return path
