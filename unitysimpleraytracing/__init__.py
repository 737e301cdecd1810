"""LBVH raytracing framework in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capability set of
drzhn/UnitySimpleRaytracing (GPU radix sort → Karras LBVH → per-pixel BVH
traversal → shaded, composited image): vectorized batched operators under
``jit``, one traversal kernel for the GPU (ops/trace_gpu), deterministic
atomics-free construction, and SPMD scaling over device meshes.  See SURVEY.md for the reference analysis this is
built against.
"""

from unitysimpleraytracing import constants
from unitysimpleraytracing.core.camera import Camera, make_camera
from unitysimpleraytracing.core.mesh import (
    MeshData,
    build_scene,
    cube_mesh,
    load_obj,
    subdivide_mesh,
    random_triangle_soup,
    terrain_mesh,
)
from unitysimpleraytracing.core.texture import (
    Texture,
    load_texture,
    solid_texture,
    texture_from_array,
)
from unitysimpleraytracing.core.types import Bvh, HitRecord, Scene, Triangles
from unitysimpleraytracing.pipeline.build import build_bvh, deform_scene, refit_bvh
from unitysimpleraytracing.pipeline.chunked import (
    ChunkedBvh,
    build_bvh_chunked,
    occluded_chunked,
    render_frame_chunked,
    render_frames_chunked,
    render_hits_chunked,
    render_rgba_chunked,
    trace_chunked,
)
from unitysimpleraytracing.pipeline.render import (
    frame_to_image,
    make_animated_renderer,
    render_frame,
    render_frames,
    render_hits,
    render_rgba,
)

__version__ = "0.1.0"

__all__ = [
    "Bvh",
    "Camera",
    "HitRecord",
    "MeshData",
    "Scene",
    "Texture",
    "Triangles",
    "ChunkedBvh",
    "build_bvh",
    "build_bvh_chunked",
    "deform_scene",
    "refit_bvh",
    "trace_chunked",
    "build_scene",
    "constants",
    "cube_mesh",
    "frame_to_image",
    "load_obj",
    "subdivide_mesh",
    "load_texture",
    "make_camera",
    "random_triangle_soup",
    "terrain_mesh",
    "make_animated_renderer",
    "render_frame",
    "render_frames",
    "render_hits",
    "render_hits_chunked",
    "render_frame_chunked",
    "render_frames_chunked",
    "render_rgba_chunked",
    "occluded_chunked",
    "render_rgba",
    "solid_texture",
    "texture_from_array",
]
