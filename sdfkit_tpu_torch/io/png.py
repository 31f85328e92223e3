"""Minimal dependency-free PNG writer/reader (stdlib zlib only).

The reference persists render artifacts as TGA (VectorData.cs:570-619); PNG
is the modern equivalent for our harnesses and docs. 8-bit RGB / grayscale,
no interlace, zlib-compressed scanlines with filter type 0.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np
import torch

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(tag: bytes, payload: bytes) -> bytes:
    return (
        struct.pack(">I", len(payload))
        + tag
        + payload
        + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)
    )


def quantize(image) -> np.ndarray:
    """A float image in [0, 1] (clipped) as uint8: the formula of every 8-bit
    image the package writes."""
    return (np.clip(np.asarray(image, np.float32), 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def quantize_tensor(image: torch.Tensor) -> torch.Tensor:
    """:func:`quantize` on the image's own device, so that a frame on the card
    is a quarter of its bytes when it is copied to the host. Equal to
    :func:`quantize` bit for bit: one float32 multiply and one add, each
    rounded, then truncation."""
    return (image.clamp(0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)


def encode_png(image, level: int = 6) -> bytes:
    """The PNG file of an (H, W, 3) RGB or (H, W) grayscale image: a uint8
    image as it is, any other a float image through :func:`quantize`.
    ``level`` is zlib's compression level, 0 to 9."""
    img = np.asarray(image)
    if img.ndim not in (2, 3) or (img.ndim == 3 and img.shape[-1] != 3):
        raise ValueError(
            f"a PNG image is (H, W) grayscale or (H, W, 3) RGB, got {img.shape}"
        )
    u8 = img if img.dtype == np.uint8 else quantize(img)
    if u8.ndim == 2:
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
    return b"".join((
        PNG_SIGNATURE,
        _chunk(b"IHDR", ihdr),
        _chunk(b"IDAT", zlib.compress(scanlines.tobytes(), level)),
        _chunk(b"IEND", b""),
    ))


def write_png(path, image) -> None:
    """Write an (H, W, 3) float image in [0,1] (clipped) or an (H, W)
    grayscale float image as an 8-bit PNG (a uint8 image as it is)."""
    data = encode_png(image)
    with open(path, "wb") as f:
        f.write(data)


def write_depth_png(path, depth: np.ndarray, near: float, far: float) -> None:
    """Grayscale depth PNG mapped near=white, far=black (same mapping as
    io.tga.write_depth_tga / FloatData.SaveDepthTga, VectorData.cs:244-276)."""
    d = np.asarray(depth, np.float32)
    t = np.clip((d - near) / max(far - near, 1e-9), 0.0, 1.0)
    write_png(path, 1.0 - t)


def decode_png(data: bytes) -> np.ndarray:
    """The uint8 (H, W, 3) or (H, W) image of a PNG as :func:`encode_png`
    makes them: 8-bit gray or RGB, not interlaced, filter 0."""
    if data[:8] != PNG_SIGNATURE:
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
    out = raw[:, 1:].reshape(h, w, channels)
    return out[..., 0] if channels == 1 else out


def read_png(path) -> np.ndarray:
    """Read back an 8-bit PNG written by write_png (for tests). Returns
    (H, W, 3) or (H, W) float32 in [0, 1]."""
    with open(path, "rb") as f:
        return decode_png(f.read()).astype(np.float32) / 255.0
