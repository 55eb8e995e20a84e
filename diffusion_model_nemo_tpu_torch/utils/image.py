"""Image quantization and a PNG codec on the standard library.

``to_uint8`` is the serving quantization of the JAX package
(``serving/server.py``: clip to [0, 1], ×255, +0.5, truncate). The PNG
encoder needs only ``zlib`` and ``struct`` (8-bit grey or RGB, filter 0), in
place of the JAX package's Pillow dependency; ``decode_png`` reads back what
it writes. ``make_grid`` and ``save_image_grid`` are the JAX package's
``utils/image.py`` sample-grid helpers, written through this PNG codec.
``encode_gif`` (LZW, GIF89a, a fixed palette: 256 greys, or a 6×7×6 colour
cube) writes ``save_animation``, the JAX package's trajectory GIF, in
place of its Pillow writer.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path
from typing import Union

import numpy as np
import torch

__all__ = ["to_uint8", "to_uint8_tensor", "encode_png", "decode_png", "make_grid", "save_image_grid", "encode_gif",
           "save_animation"]

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


# GIF: a fixed 256-entry palette. Grey images index it by value; colour
# images by a 6 x 7 x 6 cube (252 colours, the rest black).
_CUBE = (6, 7, 6)


def _gif_palette(channels: int) -> bytes:
    if channels == 1:
        return bytes(np.repeat(np.arange(256, dtype=np.uint8), 3))
    levels = [np.round(np.arange(n) * 255.0 / (n - 1)).astype(np.uint8) for n in _CUBE]
    r, g, b = np.meshgrid(*levels, indexing="ij")
    cube = np.stack([r.ravel(), g.ravel(), b.ravel()], axis=1)
    return bytes(np.concatenate([cube, np.zeros((256 - len(cube), 3), np.uint8)]).ravel())


def _gif_indices(frame: np.ndarray) -> np.ndarray:
    """[H, W, C] uint8 → palette indices [H·W]."""
    if frame.shape[-1] == 1:
        return frame.reshape(-1)
    q = [np.round(frame[..., k].astype(np.float32) * (n - 1) / 255.0).astype(np.int32) for k, n in enumerate(_CUBE)]
    return ((q[0] * _CUBE[1] + q[1]) * _CUBE[2] + q[2]).astype(np.uint8).reshape(-1)


def _lzw(indices: np.ndarray, min_code_size: int = 8) -> bytes:
    """GIF's variable-width LZW of ``indices`` (codes packed LSB first)."""
    clear, eoi = 1 << min_code_size, (1 << min_code_size) + 1
    out = bytearray()
    acc = nbits = 0

    def emit(code: int, size: int) -> None:
        nonlocal acc, nbits
        acc |= code << nbits
        nbits += size
        while nbits >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nbits -= 8

    size, table, nxt = min_code_size + 1, {}, eoi + 1
    emit(clear, size)
    data = indices.tobytes()
    prefix = data[0]
    for c in data[1:]:
        code = table.get((prefix, c))
        if code is not None:
            prefix = code
            continue
        emit(prefix, size)
        if nxt == 4096:  # the table is full: start again
            emit(clear, size)
            size, table, nxt = min_code_size + 1, {}, eoi + 1
        else:
            table[(prefix, c)] = nxt
            nxt += 1
            if nxt > (1 << size) and size < 12:
                size += 1
        prefix = c
    emit(prefix, size)
    emit(eoi, size)
    if nbits:
        out.append(acc & 0xFF)
    return bytes(out)


def encode_gif(frames: np.ndarray, duration_ms: int = 33, loop: int = 0) -> bytes:
    """[N, H, W, C] uint8 (C = 1 or 3) → an animated GIF89a, each frame
    shown ``duration_ms`` (rounded to 10 ms), looping ``loop`` times (0 =
    forever)."""
    frames = np.asarray(frames)
    if frames.dtype != np.uint8 or frames.ndim != 4 or frames.shape[-1] not in (1, 3) or not len(frames):
        raise ValueError(f"encode_gif takes uint8 [N, H, W, 1|3] with N >= 1, got {frames.dtype} {frames.shape}")
    n, h, w, c = frames.shape
    delay = max(int(round(duration_ms / 10.0)), 1)
    body = [b"GIF89a", struct.pack("<HHBBB", w, h, 0xF7, 0, 0), _gif_palette(c),
            b"\x21\xff\x0bNETSCAPE2.0\x03\x01" + struct.pack("<H", loop) + b"\x00"]
    for frame in frames:
        data = _lzw(_gif_indices(frame))
        body += [b"\x21\xf9\x04\x00" + struct.pack("<H", delay) + b"\x00\x00",
                 b"\x2c" + struct.pack("<HHHHB", 0, 0, w, h, 0), b"\x08"]
        body += [bytes([len(data[i: i + 255])]) + data[i: i + 255] for i in range(0, len(data), 255)]
        body.append(b"\x00")
    body.append(b"\x3b")
    return b"".join(body)


def save_animation(frames, path: str, fps: int = 30, frame_step: int = 1) -> str:
    """The first sample's trajectory of ``frames`` ([T, B, H, W, C] floats
    in [0, 1]), every ``frame_step``-th frame, as ``<path>.gif`` at
    ``fps`` (each frame at least 20 ms, as the JAX package writes it);
    returns the path."""
    if torch.is_tensor(frames):
        frames = frames[::frame_step, 0].detach().float().cpu().numpy()
    else:
        frames = np.asarray(frames)[::frame_step, 0]
    out = Path(path).with_suffix(".gif")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_bytes(encode_gif(to_uint8(frames), duration_ms=max(1000 // fps, 20)))
    return str(out)
