"""Zero-dependency PNG codec (read 8-bit gray/RGB/RGBA, write RGB/RGBA).

The reference leans on Unity's asset importer for ``viking_room.png``
(Scene.unity:366) and never writes images; this framework needs both ends for
the headless CLI and golden-image tests.  Pure stdlib (zlib/struct) so the
framework has no image-library dependency.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"


def read_png(path: str) -> np.ndarray:
    """Decode a PNG to (H, W, C) uint8.

    Uses Pillow when present (fast C unfiltering); otherwise falls back to the
    pure-stdlib decoder below (bit depth 8, color types 0/2/3/4/6, no
    interlace)."""
    try:
        from PIL import Image

        img = np.asarray(Image.open(path))
        if img.ndim == 2:
            img = img[:, :, None]
        return img
    except ImportError:
        pass
    return _read_png_pure(path)


def _read_png_pure(path: str) -> np.ndarray:
    data = open(path, "rb").read()
    if data[:8] != _SIG:
        raise ValueError(f"{path}: not a PNG")
    pos = 8
    idat = b""
    w = h = None
    bit_depth = color_type = None
    palette = None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        ctype = data[pos + 4 : pos + 8]
        chunk = data[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if ctype == b"IHDR":
            w, h, bit_depth, color_type, _comp, _filt, interlace = struct.unpack(
                ">IIBBBBB", chunk
            )
            if bit_depth != 8:
                raise ValueError(f"unsupported bit depth {bit_depth}")
            if interlace:
                raise ValueError("interlaced PNG unsupported")
        elif ctype == b"PLTE":
            palette = np.frombuffer(chunk, np.uint8).reshape(-1, 3)
        elif ctype == b"IDAT":
            idat += chunk
        elif ctype == b"IEND":
            break
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color_type]
    raw = zlib.decompress(idat)
    stride = w * channels

    # Native fast path: the per-byte Sub/Average/Paeth loops in C++
    # (native/image.cpp); pure-Python below as fallback.
    try:
        from unitysimpleraytracing import native

        out = native.png_unfilter_native(raw, h, stride, channels)
        img = out.reshape(h, w, channels)
        if color_type == 3:
            if palette is None:
                raise ValueError("palette PNG missing PLTE")
            img = palette[img[:, :, 0]]
        return img
    except (RuntimeError, ImportError):
        pass

    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    off = 0
    for row in range(h):
        ftype = raw[off]
        line = np.frombuffer(raw, np.uint8, stride, off + 1).astype(np.int32)
        off += 1 + stride
        if ftype == 0:
            cur = line
        elif ftype == 1:  # Sub
            cur = line.copy()
            for i in range(channels, stride):
                cur[i] = (cur[i] + cur[i - channels]) & 0xFF
        elif ftype == 2:  # Up
            cur = (line + prev) & 0xFF
        elif ftype == 3:  # Average
            cur = line.copy()
            for i in range(stride):
                left = cur[i - channels] if i >= channels else 0
                cur[i] = (cur[i] + ((left + prev[i]) >> 1)) & 0xFF
        elif ftype == 4:  # Paeth
            cur = line.copy()
            for i in range(stride):
                a = cur[i - channels] if i >= channels else 0
                b = prev[i]
                c = prev[i - channels] if i >= channels else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                cur[i] = (cur[i] + pred) & 0xFF
        else:
            raise ValueError(f"bad filter {ftype}")
        out[row] = cur.astype(np.uint8)
        prev = cur
    img = out.reshape(h, w, channels)
    if color_type == 3:
        if palette is None:
            raise ValueError("palette PNG missing PLTE")
        img = palette[img[:, :, 0]]
    return img


def write_png(path: str, img: np.ndarray) -> None:
    """Encode (H, W, 3|4) uint8 (or float in [0,1]) to a PNG file."""
    if img.dtype != np.uint8:
        img = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    h, w, c = img.shape
    color_type = {3: 2, 4: 6}[c]
    raw = b"".join(b"\x00" + img[row].tobytes() for row in range(h))

    def chunk(ctype: bytes, payload: bytes) -> bytes:
        out = struct.pack(">I", len(payload)) + ctype + payload
        return out + struct.pack(">I", zlib.crc32(ctype + payload) & 0xFFFFFFFF)

    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIG)
        f.write(chunk(b"IHDR", ihdr))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))
