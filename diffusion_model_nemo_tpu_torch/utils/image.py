"""Image quantization and a PNG codec on the standard library.

``to_uint8`` is the serving quantization of the JAX package
(``serving/server.py``: clip to [0, 1], ×255, +0.5, truncate). The PNG
encoder needs only ``zlib`` and ``struct`` (8-bit grey or RGB, filter 0), in
place of the JAX package's Pillow dependency; ``decode_png`` reads back what
it writes. ``make_grid`` and ``save_image_grid`` are the JAX package's
``utils/image.py`` sample-grid helpers, written through this PNG codec.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path
from typing import Union

import numpy as np
import torch

__all__ = ["to_uint8", "to_uint8_tensor", "encode_png", "decode_png", "make_grid", "save_image_grid"]

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_COLOR_TYPES = {1: 0, 3: 2}  # channels -> PNG colour type (grey, RGB)


def to_uint8(images: np.ndarray) -> np.ndarray:
    """Floats in [0, 1] → uint8."""
    images = np.clip(np.asarray(images), 0.0, 1.0)
    return (images * 255.0 + 0.5).astype(np.uint8)


def to_uint8_tensor(images: torch.Tensor) -> torch.Tensor:
    """``to_uint8`` on the tensor's own device (bit-identical)."""
    return (images.clamp(0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))


def encode_png(image: np.ndarray) -> bytes:
    """[H, W], [H, W, 1] or [H, W, 3] uint8 → PNG bytes."""
    image = np.asarray(image)
    if image.dtype != np.uint8:
        raise TypeError(f"encode_png takes uint8, got {image.dtype}")
    if image.ndim == 2:
        image = image[..., None]
    h, w, c = image.shape
    if c not in _COLOR_TYPES:
        raise ValueError(f"encode_png takes 1 or 3 channels, got {c}")
    rows = np.concatenate(
        [np.zeros((h, 1), np.uint8), np.ascontiguousarray(image).reshape(h, w * c)], axis=1
    )
    ihdr = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPES[c], 0, 0, 0)
    return (
        _PNG_SIGNATURE
        + _chunk(b"IHDR", ihdr)
        + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
        + _chunk(b"IEND", b"")
    )


def decode_png(data: Union[bytes, bytearray]) -> np.ndarray:
    """PNG bytes written by :func:`encode_png` → [H, W, C] uint8. Checks the
    signature and every chunk's CRC; takes only filter type 0."""
    data = bytes(data)
    if not data.startswith(_PNG_SIGNATURE):
        raise ValueError("not a PNG: bad signature")
    pos, idat, header = len(_PNG_SIGNATURE), b"", None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        kind = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length : pos + 12 + length])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"PNG chunk {kind!r} fails its CRC")
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat += body
        pos += 12 + length
    if header is None:
        raise ValueError("PNG has no IHDR chunk")
    w, h, depth, color, _, _, interlace = header
    channels = {v: k for k, v in _COLOR_TYPES.items()}.get(color)
    if depth != 8 or channels is None or interlace:
        raise ValueError(f"unsupported PNG: depth {depth}, colour type {color}, interlace {interlace}")
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + w * channels)
    if rows[:, 0].any():
        raise ValueError("decode_png takes filter type 0 only")
    return rows[:, 1:].reshape(h, w, channels).copy()


def make_grid(images, nrow: int = 6, padding: int = 2) -> np.ndarray:
    """Tile [B, H, W, C] floats in [0, 1] (or a tensor) into one [H', W', C]
    uint8 grid of ``min(nrow, B)`` columns, ``padding`` black pixels apart."""
    if torch.is_tensor(images):
        images = images.detach().float().cpu().numpy()
    images = to_uint8(images)
    b, h, w, c = images.shape
    ncol = min(nrow, b)
    nrows = (b + ncol - 1) // ncol
    grid = np.zeros((nrows * (h + padding) + padding, ncol * (w + padding) + padding, c), np.uint8)
    for idx in range(b):
        r, col = divmod(idx, ncol)
        y, x = r * (h + padding) + padding, col * (w + padding) + padding
        grid[y : y + h, x : x + w] = images[idx]
    return grid


def save_image_grid(images, path: str, nrow: int = 6) -> str:
    """``make_grid`` written as a PNG at ``path`` (parents created)."""
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_bytes(encode_png(make_grid(images, nrow=nrow)))
    return path
