"""Device texture container + bilinear sampling.

Replicates ``_meshTexture.SampleLevel(linearClampSampler, uv, 0)``
(``Assets/_Shaders/Raytracing/Raytracing.compute:182``): mip level 0, bilinear
filtering, clamp-to-edge addressing, texel centers at (i+0.5)/size, and
Unity's bottom-left UV origin (PNG rows are top-down, so the loader flips).
Sampling is a batched gather + lerp over (R,) UV arrays.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from unitysimpleraytracing.core.pytree import pytree_dataclass
from unitysimpleraytracing.io.png import read_png


@pytree_dataclass
class Texture:
    data: jnp.ndarray  # (H, W, 4) f32 in [0,1], row 0 = v=0 (bottom)

    @property
    def height(self) -> int:
        return self.data.shape[0]

    @property
    def width(self) -> int:
        return self.data.shape[1]


def _srgb_to_linear(x: np.ndarray) -> np.ndarray:
    return np.where(x <= 0.04045, x / 12.92, ((x + 0.055) / 1.055) ** 2.4)


def texture_from_array(img: np.ndarray, srgb: bool = False) -> Texture:
    """(H, W, C) uint8/float, PNG row order (top-down) → device Texture."""
    if img.dtype == np.uint8:
        img = img.astype(np.float32) / 255.0
    img = img[::-1]  # PNG top-down → v-up
    if img.ndim == 2:
        img = img[:, :, None]
    c = img.shape[2]
    if c == 1:
        img = np.repeat(img, 3, axis=2)
        c = 3
    if c == 3:
        img = np.concatenate([img, np.ones_like(img[:, :, :1])], axis=2)
    if srgb:
        img = img.copy()
        img[:, :, :3] = _srgb_to_linear(img[:, :, :3])
    return Texture(data=jnp.asarray(img, jnp.float32))


def load_texture(path: str, srgb: bool = False) -> Texture:
    return texture_from_array(read_png(path), srgb=srgb)


def solid_texture(rgba=(1.0, 1.0, 1.0, 1.0), size: int = 8) -> Texture:
    img = np.broadcast_to(np.asarray(rgba, np.float32), (size, size, 4)).copy()
    return Texture(data=jnp.asarray(img))


def sample_bilinear(tex: Texture, u: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """Batched bilinear clamp-to-edge sample: (R,) u,v → (R, 4) RGBA."""
    h, w = tex.height, tex.width
    x = u * w - 0.5
    y = v * h - 0.5
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = x - x0
    fy = y - y0
    x0i = jnp.clip(x0.astype(jnp.int32), 0, w - 1)
    y0i = jnp.clip(y0.astype(jnp.int32), 0, h - 1)
    # Below-edge clamp: the per-fetch form had BOTH texels clamp to index 0
    # when x0 < 0 (lerp of equal texels == edge texel); the quad row at 0
    # holds (tex0, tex1), so zero the fraction instead — identical result.
    fx = jnp.where(x0 < 0, 0.0, fx)
    fy = jnp.where(y0 < 0, 0.0, fy)
    # ONE 16-column row-gather instead of four 4-column gathers: a
    # (H*W, 16) quad table — each row holding the 2×2 clamped texel
    # neighborhood — fetches 4x fewer rows.  The above-edge clamp shifts
    # reproduce min(i+1, size-1) exactly (identical texels → identical lerp).
    d = tex.data
    dx = jnp.concatenate([d[:, 1:], d[:, -1:]], axis=1)
    dy = jnp.concatenate([d[1:], d[-1:]], axis=0)
    dxy = jnp.concatenate([dx[1:], dx[-1:]], axis=0)
    quad = jnp.concatenate([d, dx, dy, dxy], axis=2).reshape(h * w, 16)
    q = jnp.take(quad, y0i * w + x0i, axis=0)
    t00, t10, t01, t11 = q[:, 0:4], q[:, 4:8], q[:, 8:12], q[:, 12:16]
    fx = fx[:, None]
    fy = fy[:, None]
    top = t00 * (1 - fx) + t10 * fx
    bot = t01 * (1 - fx) + t11 * fx
    return top * (1 - fy) + bot * fy
