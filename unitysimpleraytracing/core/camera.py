"""Pinhole camera and batched primary-ray generation.

Replicates the reference's ray-generation math exactly
(``Assets/_Shaders/Raytracing/Raytracing.compute:108-126``): a near-plane point
per pixel in camera space (OpenGL convention, camera looks down −Z), rotated
into world space by the camera-to-world matrix, then normalized.  The reference
gets ``cameraFov`` as ``tan(fov_deg/2)`` (RaytracingMeshDrawer.cs:80) and the
near distance from Unity's projection params; both are explicit fields here.

Instead of one ray per GPU thread, rays are produced as (H*W, 3) arrays in a
single fused elementwise program — the traversal consumes them in 32×32
image-tile order.
"""
from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np

from unitysimpleraytracing.core.pytree import pytree_dataclass, static_field


@pytree_dataclass
class Camera:
    cam_to_world: jnp.ndarray  # (4, 4) f32, OpenGL convention (looks down -Z)
    tan_half_fov: jnp.ndarray  # scalar f32 = tan(vertical_fov/2)
    near: jnp.ndarray          # scalar f32 near-plane distance
    width: int = static_field()
    height: int = static_field()


def look_at(eye, target, up=(0.0, 1.0, 0.0)) -> np.ndarray:
    """Camera-to-world matrix with the camera at ``eye`` looking at ``target``.

    OpenGL convention: camera-space −Z axis points at the target.
    """
    eye = np.asarray(eye, np.float64)
    fwd = np.asarray(target, np.float64) - eye
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, np.asarray(up, np.float64))
    right /= np.linalg.norm(right)
    true_up = np.cross(right, fwd)
    m = np.eye(4)
    m[:3, 0] = right
    m[:3, 1] = true_up
    m[:3, 2] = -fwd
    m[:3, 3] = eye
    return m.astype(np.float32)


def make_camera(
    eye,
    target,
    width: int,
    height: int,
    fov_deg: float = 60.0,
    near: float = 0.3,
    up=(0.0, 1.0, 0.0),
) -> Camera:
    return Camera(
        cam_to_world=jnp.asarray(look_at(eye, target, up)),
        tan_half_fov=jnp.float32(math.tan(math.radians(fov_deg) / 2)),
        near=jnp.float32(near),
        width=width,
        height=height,
    )


def generate_rays(cam: Camera) -> tuple[jnp.ndarray, jnp.ndarray]:
    """All primary rays for the frame: origins (R,3) and unit directions (R,3).

    Pixel (px, py) maps exactly like Raytracing.compute:108-126:
    ``py`` is the bottom-up row index (Unity UAV convention), ray passes
    through the pixel center on the near plane.  R = width*height, row-major
    with py outer so that ``rays[py*W + px]`` is pixel (px, py).
    """
    w, h = cam.width, cam.height
    near = cam.near
    vh = 2.0 * near * cam.tan_half_fov               # near-plane height
    vw = w * vh / h                                  # near-plane width
    px = jnp.arange(w, dtype=jnp.float32)
    py = jnp.arange(h, dtype=jnp.float32)
    x = -vw / 2 + vw / w * (px + 0.5)                # (W,)
    y = -vh / 2 + vh / h * (py + 0.5)                # (H,)
    xg = jnp.broadcast_to(x[None, :], (h, w))
    yg = jnp.broadcast_to(y[:, None], (h, w))
    zg = jnp.full((h, w), -near, jnp.float32)
    dirs_cam = jnp.stack([xg, yg, zg], axis=-1).reshape(h * w, 3)
    rot = cam.cam_to_world[:3, :3]
    # w=0 transform.  HIGHEST precision: a GPU would otherwise run this f32
    # product in TF32 and the rays would no longer match the CPU goldens.
    dirs = jnp.matmul(dirs_cam, rot.T, precision=jax.lax.Precision.HIGHEST)
    dirs = dirs / jnp.linalg.norm(dirs, axis=-1, keepdims=True)
    origin = cam.cam_to_world[:3, 3]
    origins = jnp.broadcast_to(origin[None, :], (h * w, 3))
    return origins, dirs
