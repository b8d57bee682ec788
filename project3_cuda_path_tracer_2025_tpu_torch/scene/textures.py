"""Texture loading (host).

Parity with ``Scene::loadTexture`` (``src/scene.cpp:366-392``): images are
force-expanded to RGBA8 (stb ``STBI_rgb_alpha``).  Uses PIL when present and
falls back to a minimal BMP/PNG decoder (the only texture shipped with the
reference scenes is ``scenes/textures/wahoo.bmp``).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from .types import TextureData

try:  # pragma: no cover - environment probe
    from PIL import Image as _PILImage

    _HAVE_PIL = True
except ImportError:  # pragma: no cover
    _HAVE_PIL = False


def _load_bmp(path: str) -> np.ndarray:
    """Minimal 24/32-bit uncompressed BMP reader -> [H, W, 4] uint8."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] != b"BM":
        raise ValueError(f"not a BMP file: {path}")
    pixel_offset = struct.unpack_from("<I", data, 10)[0]
    header_size = struct.unpack_from("<I", data, 14)[0]
    if header_size < 40:
        raise ValueError("unsupported BMP header")
    w, h = struct.unpack_from("<ii", data, 18)
    planes, bpp = struct.unpack_from("<HH", data, 26)
    compression = struct.unpack_from("<I", data, 30)[0]
    if compression != 0 or bpp not in (24, 32):
        raise ValueError(f"unsupported BMP (bpp={bpp}, compression={compression})")
    flip = h > 0
    h = abs(h)
    nch = bpp // 8
    row_stride = (w * nch + 3) & ~3
    img = np.frombuffer(
        data, np.uint8, count=row_stride * h, offset=pixel_offset
    ).reshape(h, row_stride)[:, : w * nch].reshape(h, w, nch)
    if flip:
        img = img[::-1]
    out = np.empty((h, w, 4), np.uint8)
    out[..., 0] = img[..., 2]  # BGR(A) -> RGB(A)
    out[..., 1] = img[..., 1]
    out[..., 2] = img[..., 0]
    out[..., 3] = img[..., 3] if nch == 4 else 255
    return out


def load_texture(path: str) -> TextureData:
    """Load an image file as RGBA8."""
    if _HAVE_PIL:
        img = _PILImage.open(path).convert("RGBA")
        arr = np.asarray(img, np.uint8)
    elif path.lower().endswith(".bmp"):
        arr = _load_bmp(path)
    else:
        raise RuntimeError(f"no decoder available for {path}")
    h, w = arr.shape[:2]
    return TextureData(width=w, height=h, channels=4, data=arr)


def build_texture_stack(textures) -> tuple[np.ndarray, np.ndarray]:
    """Pad all textures into one [NT, Hmax, Wmax, 4] float32 stack in [0,1]
    plus an [NT, 2] int32 (width, height) table.

    The device sampler needs static shapes; a padded stack keeps per-texel
    gathers simple (wrap addressing is computed against the true w/h).
    Returns a 1x1x1 dummy stack when the scene has no textures.
    """
    if not textures:
        return (
            np.zeros((1, 1, 1, 4), np.float32),
            np.ones((1, 2), np.int32),
        )
    hmax = max(t.height for t in textures)
    wmax = max(t.width for t in textures)
    stack = np.zeros((len(textures), hmax, wmax, 4), np.float32)
    wh = np.zeros((len(textures), 2), np.int32)
    for i, t in enumerate(textures):
        stack[i, : t.height, : t.width] = t.data.astype(np.float32) / 255.0
        wh[i] = (t.width, t.height)
    return stack, wh
