"""TGA image writers (reference parity: VectorData.SaveTga RGB writer,
VectorData.cs:570-619, and FloatData.SaveDepthTga, VectorData.cs:244-276).

Uncompressed 24-bit BGR, bottom-left origin flag clear (top-down row order
via descriptor bit 5), matching common TGA viewers.

The port's own copy of ``sdfkit_tpu/io/tga.py``: numpy only.
"""

from __future__ import annotations

import struct

import numpy as np


def _tga_header(width: int, height: int) -> bytes:
    # Uncompressed true-color, 24bpp, origin top-left (descriptor 0x20).
    return struct.pack(
        "<BBBHHBHHHHBB", 0, 0, 2, 0, 0, 0, 0, 0, width, height, 24, 0x20
    )


def write_tga(path, image: np.ndarray) -> None:
    """Write an (H, W, 3) float image in [0,1] (clipped) as 24-bit TGA."""
    img = np.asarray(image, np.float32)
    h, w = img.shape[:2]
    rgb = np.clip(img, 0.0, 1.0)
    bgr = (rgb[..., ::-1] * 255.0 + 0.5).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(_tga_header(w, h))
        f.write(bgr.tobytes())


def write_depth_tga(path, depth: np.ndarray, near: float, far: float) -> None:
    """Write an (H, W) depth image mapped so near=white, far=black
    (reference: FloatData.SaveDepthTga, VectorData.cs:244-276)."""
    d = np.asarray(depth, np.float32)
    t = np.clip((d - near) / max(far - near, 1e-9), 0.0, 1.0)
    gray = ((1.0 - t) * 255.0 + 0.5).astype(np.uint8)
    h, w = gray.shape
    bgr = np.repeat(gray[..., None], 3, axis=-1)
    with open(path, "wb") as f:
        f.write(_tga_header(w, h))
        f.write(bgr.tobytes())


def read_tga(path) -> np.ndarray:
    """Read back a 24-bit uncompressed TGA written by write_tga (for tests)."""
    with open(path, "rb") as f:
        header = f.read(18)
        (idlen, _cmap, imtype, _, _, _, _, _, w, h, bpp, desc) = struct.unpack(
            "<BBBHHBHHHHBB", header
        )
        if imtype != 2 or bpp != 24:
            raise ValueError(
                f"only uncompressed 24-bit TGA supported "
                f"(got image type {imtype}, {bpp} bpp)"
            )
        f.read(idlen)
        data = np.frombuffer(f.read(w * h * 3), np.uint8).reshape(h, w, 3)
    rgb = data[..., ::-1].astype(np.float32) / 255.0
    if not (desc & 0x20):  # bottom-up storage
        rgb = rgb[::-1]
    return rgb
