"""Vectorized 30-bit Morton encoding.

Bit-identical to the reference's scalar host loop
(``Assets/_Scripts/MeshBufferContainer.cs:32-50``: ``ExpandBits``/``Morton3D``),
but expressed as whole-array uint32 ops so XLA maps it onto the VPU — the
reference computes one code per triangle per CPU-loop iteration; here all N
codes are one fused elementwise graph.
"""
from __future__ import annotations

import jax.numpy as jnp

from unitysimpleraytracing import constants as C


def expand_bits(v: jnp.ndarray) -> jnp.ndarray:
    """Spread the low 10 bits of each lane out to every 3rd bit.

    Magic-constant sequence identical to MeshBufferContainer.cs:32-39.
    """
    v = v.astype(jnp.uint32)
    v = (v * jnp.uint32(0x00010001)) & jnp.uint32(0xFF0000FF)
    v = (v * jnp.uint32(0x00000101)) & jnp.uint32(0x0F00F00F)
    v = (v * jnp.uint32(0x00000011)) & jnp.uint32(0xC30C30C3)
    v = (v * jnp.uint32(0x00000005)) & jnp.uint32(0x49249249)
    return v


def morton3d(x: jnp.ndarray, y: jnp.ndarray, z: jnp.ndarray) -> jnp.ndarray:
    """Encode unit-cube coordinates to 30-bit Morton codes (x-major interleave).

    Mirrors MeshBufferContainer.cs:41-50: scale by 1024, clamp to [0, 1023],
    truncate to uint, interleave as ``xx*4 + yy*2 + zz``.
    """
    def quantize(f):
        f = jnp.clip(f * C.MORTON_GRID, 0.0, C.MORTON_GRID - 1.0)
        return f.astype(jnp.uint32)

    xx = expand_bits(quantize(x))
    yy = expand_bits(quantize(y))
    zz = expand_bits(quantize(z))
    return xx * jnp.uint32(4) + yy * jnp.uint32(2) + zz


def morton_from_points(p: jnp.ndarray) -> jnp.ndarray:
    """Encode an (N, 3) array of unit-cube points."""
    return morton3d(p[:, 0], p[:, 1], p[:, 2])
