"""Minimal dependency-free PNG writer/reader (stdlib zlib only).

The reference persists render artifacts as TGA (VectorData.cs:570-619); PNG
is the modern equivalent for our harnesses and docs. 8-bit RGB / grayscale,
no interlace, zlib-compressed scanlines with filter type 0.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _chunk(tag: bytes, payload: bytes) -> bytes:
    return (
        struct.pack(">I", len(payload))
        + tag
        + payload
        + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)
    )


def write_png(path, image: np.ndarray) -> None:
    """Write an (H, W, 3) float image in [0,1] (clipped) or an (H, W)
    grayscale float image as an 8-bit PNG."""
    img = np.asarray(image, np.float32)
    if img.ndim not in (2, 3) or (img.ndim == 3 and img.shape[-1] != 3):
        raise ValueError(
            f"write_png expects (H, W) grayscale or (H, W, 3) RGB, got {img.shape}"
        )
    gray = img.ndim == 2
    u8 = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    if gray:
        h, w = u8.shape
        color_type = 0
        raw = u8[..., None]
    else:
        h, w = u8.shape[:2]
        color_type = 2
        raw = u8
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    # Filter byte 0 per scanline.
    scanlines = np.concatenate(
        [np.zeros((h, 1), np.uint8), raw.reshape(h, -1)], axis=1
    )
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_chunk(b"IHDR", ihdr))
        f.write(_chunk(b"IDAT", zlib.compress(scanlines.tobytes(), 6)))
        f.write(_chunk(b"IEND", b""))


def write_depth_png(path, depth: np.ndarray, near: float, far: float) -> None:
    """Grayscale depth PNG mapped near=white, far=black (same mapping as
    io.tga.write_depth_tga / FloatData.SaveDepthTga, VectorData.cs:244-276)."""
    d = np.asarray(depth, np.float32)
    t = np.clip((d - near) / max(far - near, 1e-9), 0.0, 1.0)
    write_png(path, 1.0 - t)


def read_png(path) -> np.ndarray:
    """Read back an 8-bit PNG written by write_png (for tests). Returns
    (H, W, 3) or (H, W) float32 in [0, 1]."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG")
    pos = 8
    w = h = color_type = None
    idat = b""
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        tag = data[pos + 4 : pos + 8]
        payload = data[pos + 8 : pos + 8 + length]
        if tag == b"IHDR":
            w, h, bit_depth, color_type, _, _, interlace = struct.unpack(
                ">IIBBBBB", payload
            )
            if bit_depth != 8 or interlace != 0:
                raise ValueError("only 8-bit non-interlaced PNGs supported")
            if color_type not in (0, 2):
                raise ValueError("only gray/RGB supported")
        elif tag == b"IDAT":
            idat += payload
        pos += 12 + length
    channels = 1 if color_type == 0 else 3
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(
        h, 1 + w * channels
    )
    if not (raw[:, 0] == 0).all():
        raise ValueError("only filter 0 supported")
    out = raw[:, 1:].reshape(h, w, channels).astype(np.float32) / 255.0
    return out[..., 0] if channels == 1 else out
