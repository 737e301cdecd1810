"""Single-sourced framework configuration.

The reference duplicates its compile-time config between C# and HLSL
(``Assets/_Scripts/Constants.cs:1-10`` and ``Assets/_Shaders/Constants.cginc:1-7``),
and silently breaks if they diverge.  Here there is exactly one source of truth.

Unlike the reference's fixed 524 288-element capacity
(``Constants.cs:6``: DATA_ARRAY_COUNT = 1024*512), buffers in this framework are
shape-polymorphic: each scene is padded to the next multiple of ``VREG``
(1024 rows), and jitted programs specialize per padded size.  The granule is
a (8, 128) tile inherited from the first target; whether it pays on the GPU
is not measured yet.
"""

# Padding tile: (8, 128) f32 elements.
SUBLANE = 8
LANE = 128
VREG = SUBLANE * LANE  # 1024 elements: the scene padding granule

# Radix sort configuration (reference: Constants.cs:8-9 — RADIX=8, BUCKET_SIZE=256).
RADIX_BITS = 8
NUM_BUCKETS = 1 << RADIX_BITS
KEY_BITS = 32
NUM_PASSES = KEY_BITS // RADIX_BITS  # 4 digit passes (ComputeBufferSorter.cs:102)

# Sort/scan tiling: elements handled per sort block. The reference uses
# 1024-element thread blocks (Constants.cginc:4); here a block is the key
# chunk one histogram row of the XLA radix engine covers.
SORT_BLOCK = 4096

# Traversal (reference: Raytracing.compute:133 — uint stack[64]).
TRAVERSAL_STACK_DEPTH = 64

# Sentinels (reference: SceneDataTypes.cs:63-71 null nodes = 0xFFFFFFFF;
# MeshBufferContainer.cs:108-109 padding keys = uint.MaxValue).
NULL_INDEX = -1  # int32 sentinel replacing the reference's 0xFFFFFFFF
KEY_PADDING = 0xFFFFFFFF  # padding Morton keys sort to the tail

# HLSL MAX_FLOAT = 0x7F7FFFFF (Constants.cginc:7) == float32 max.
MAX_FLOAT = 3.4028234663852886e38

# Fixed scene bound used by the reference to normalize centroids before Morton
# encoding (MeshBufferContainer.cs:9-15: ±125 world units). We compute the true
# scene bound by default; parity runs can pin this value.
PARITY_SCENE_BOUND = 125.0

# AABB inflation applied per-triangle (MeshBufferContainer.cs:55-63).
AABB_INFLATION = 1e-3

# Morton grid resolution: 10 bits per axis, 30-bit codes
# (MeshBufferContainer.cs:41-50).
MORTON_BITS_PER_AXIS = 10
MORTON_GRID = 1 << MORTON_BITS_PER_AXIS  # 1024


def pad_count(n: int, multiple: int = VREG) -> int:
    """Round ``n`` up to a multiple of ``multiple`` (at least one tile)."""
    if n <= 0:
        raise ValueError(f"need at least one element, got {n}")
    return max(((n + multiple - 1) // multiple) * multiple, multiple)
