"""Film output / input.

Parity targets:

* ``saveImage`` (``src/main.cpp:395-419``): pixel = accumulator / iterations,
  written horizontally mirrored (``width-1-x``), filename
  ``{FILE}.{timestamp}.{iter}samp.png``.
* ``Image::savePNG`` (``src/image.cpp:23-43``): clamp to [0,1] * 255,
  truncating cast, RGB8 PNG (no gamma / tonemap).
* ``Image::saveHDR`` (``src/image.cpp:45-50``): Radiance HDR.

Uses PIL when available; falls back to a minimal pure-Python PNG codec so the
package has zero hard imaging dependencies.
"""

from __future__ import annotations

import os
import struct
import time
import zlib

import numpy as np

try:  # pragma: no cover - environment probe
    from PIL import Image as _PILImage

    _HAVE_PIL = True
except ImportError:  # pragma: no cover
    _HAVE_PIL = False


def film_to_u8(film: np.ndarray, iterations: int, mirror: bool = True) -> np.ndarray:
    """Convert an [H, W, 3] float accumulator into the reference's RGB8.

    clamp(accum/iters, 0, 1) * 255 with a truncating (C-style) cast
    (``src/image.cpp:31-35``), mirrored about the vertical axis when
    ``mirror`` (``src/main.cpp:407``).
    """
    img = np.clip(film.astype(np.float64) / float(iterations), 0.0, 1.0) * 255.0
    u8 = img.astype(np.uint8)  # truncation, matching (unsigned char)pix
    if mirror:
        u8 = u8[:, ::-1, :]
    return u8


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    return (
        struct.pack(">I", len(data))
        + tag
        + data
        + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
    )


def write_png(path: str, rgb_u8: np.ndarray) -> None:
    """Write an RGB8 PNG (pure Python fallback path)."""
    h, w, _ = rgb_u8.shape
    if _HAVE_PIL:
        _PILImage.fromarray(rgb_u8, "RGB").save(path)
        return
    raw = b"".join(b"\x00" + rgb_u8[y].tobytes() for y in range(h))
    out = b"\x89PNG\r\n\x1a\n"
    out += _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
    out += _png_chunk(b"IDAT", zlib.compress(raw, 6))
    out += _png_chunk(b"IEND", b"")
    with open(path, "wb") as f:
        f.write(out)


def read_png(path: str) -> np.ndarray:
    """Read a PNG into an RGB8 [H, W, 3] array (golden-image comparisons)."""
    if _HAVE_PIL:
        return np.asarray(_PILImage.open(path).convert("RGB"))
    raise RuntimeError("PNG reading requires PIL in this environment")


def write_hdr(path: str, rgb_f32: np.ndarray) -> None:
    """Radiance HDR writer (uncompressed RLE-free scanlines), parity with
    ``stbi_write_hdr`` output semantics (``src/image.cpp:45-50``)."""
    h, w, _ = rgb_f32.shape
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\n")
        f.write(b"FORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        rgb = np.maximum(rgb_f32.astype(np.float32), 0.0)
        maxc = rgb.max(axis=-1)
        e = np.zeros_like(maxc, dtype=np.int32)
        nz = maxc > 1e-32
        m, ex = np.frexp(maxc, where=nz, out=(np.zeros_like(maxc), e))
        scale = np.where(nz, m * 256.0 / np.maximum(maxc, 1e-32), 0.0)
        rgbe = np.zeros((h, w, 4), dtype=np.uint8)
        rgbe[..., :3] = np.clip(rgb * scale[..., None], 0, 255).astype(np.uint8)
        rgbe[..., 3] = np.where(nz, ex + 128, 0).astype(np.uint8)
        f.write(rgbe.tobytes())


def reference_timestamp() -> str:
    """Timestamp format used in saved filenames (``src/main.cpp`` uses
    ``%Y-%m-%d_%H-%M-%Sz`` UTC, cf. currentTimeString)."""
    return time.strftime("%Y-%m-%d_%H-%M-%Sz", time.gmtime())


def save_film(
    film: np.ndarray,
    iterations: int,
    image_name: str,
    out_dir: str = "img",
    mirror: bool = True,
    hdr: bool = False,
    timestamp: str | None = None,
) -> str:
    """Full ``saveImage`` parity: returns the written path."""
    os.makedirs(out_dir, exist_ok=True)
    ts = timestamp if timestamp is not None else reference_timestamp()
    base = os.path.join(out_dir, f"{image_name}.{ts}.{iterations}samp")
    if hdr:
        path = base + ".hdr"
        img = film.astype(np.float32) / float(iterations)
        if mirror:
            img = img[:, ::-1, :]
        write_hdr(path, img)
    else:
        path = base + ".png"
        write_png(path, film_to_u8(film, iterations, mirror=mirror))
    return path
