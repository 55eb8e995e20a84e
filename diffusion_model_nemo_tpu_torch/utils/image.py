"""Image quantization and a PNG codec on the standard library.

``to_uint8`` is the serving quantization of the JAX package
(``serving/server.py``: clip to [0, 1], ×255, +0.5, truncate). The PNG
encoder needs only ``zlib`` and ``struct`` (8-bit grey or RGB, filter 0), in
place of the JAX package's Pillow dependency; ``decode_png`` reads what it
writes and what Pillow writes (every filter type; grey, grey + alpha, RGB,
RGBA and palette images at 8 bits, grey and palette also at 1, 2 and 4) and
refuses 16-bit and interlaced images. ``resize_bilinear_uint8`` is
Pillow's ``BILINEAR`` resize of a uint8 image, byte for byte (the JAX data
loader's ``resize_to``). ``make_grid`` and ``save_image_grid`` are the JAX package's
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

__all__ = ["to_uint8", "to_uint8_tensor", "encode_png", "decode_png", "resize_bilinear_uint8", "make_grid",
           "save_image_grid", "encode_gif", "save_animation"]

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


# PNG colour type -> channels of the decoded samples (palette: one index).
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_PNG_DEPTHS = {0: (1, 2, 4, 8), 2: (8,), 3: (1, 2, 4, 8), 4: (8,), 6: (8,)}


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """The scanlines [h, stride] with each row's filter (0 None, 1 Sub, 2 Up,
    3 Average, 4 Paeth) undone against the row above, ``bpp`` bytes a pixel
    (at least 1)."""
    if len(raw) != h * (stride + 1):
        raise ValueError(f"PNG image data has {len(raw)} bytes, expected {h * (stride + 1)}")
    rows = np.frombuffer(raw, np.uint8).reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, line = int(rows[y, 0]), rows[y, 1:]
        if kind == 0:
            cur = line
        elif kind == 1:  # Sub: a running sum, per byte of the pixel
            padded = np.zeros(-(-stride // bpp) * bpp, np.uint64)
            padded[:stride] = line
            cur = (np.cumsum(padded.reshape(-1, bpp), axis=0) & 0xFF).astype(np.uint8).reshape(-1)[:stride]
        elif kind == 2:  # Up
            cur = line + prev  # uint8 wraps mod 256
        elif kind in (3, 4):  # Average, Paeth: each byte needs the one before it
            buf, up = bytearray(line.tobytes()), prev.tobytes()
            for i in range(stride):
                a = buf[i - bpp] if i >= bpp else 0
                if kind == 3:
                    pred = (a + up[i]) >> 1
                else:
                    pred = _paeth(a, up[i], up[i - bpp] if i >= bpp else 0)
                buf[i] = (buf[i] + pred) & 0xFF
            cur = np.frombuffer(bytes(buf), np.uint8)
        else:
            raise ValueError(f"PNG row {y} has an unknown filter type {kind}")
        out[y] = cur
        prev = out[y]
    return out


def _unpack_bits(rows: np.ndarray, w: int, depth: int) -> np.ndarray:
    """[h, stride] packed samples of ``depth`` < 8 bits → [h, w] values."""
    bits = np.unpackbits(rows, axis=1)
    per = bits.reshape(rows.shape[0], -1, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (per * weights).sum(axis=2).astype(np.uint8)[:, :w]


def decode_png(data: Union[bytes, bytearray]) -> np.ndarray:
    """PNG bytes → [H, W, C] uint8 samples: grey (C = 1, 1/2/4-bit depths
    scaled to 0-255, as the PNG standard and Pillow's "L" do), grey + alpha
    (2), RGB (3), RGBA (4), and palette images through their ``PLTE`` as RGB
    (3; a ``tRNS`` is ignored, as ``Image.convert("RGB")`` ignores it).
    Every filter type (None, Sub, Up, Average, Paeth) is undone. Checks the
    signature and every chunk's CRC. 16-bit samples and interlaced images
    are refused with a ``ValueError``. Writes nothing, needs no Pillow."""
    data = bytes(data)
    if not data.startswith(_PNG_SIGNATURE):
        raise ValueError("not a PNG: bad signature")
    pos, idat, header, palette = len(_PNG_SIGNATURE), [], None, None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        kind = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length : pos + 12 + length])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"PNG chunk {kind!r} fails its CRC")
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + length
    if header is None:
        raise ValueError("PNG has no IHDR chunk")
    w, h, depth, color, _compression, _filter_method, interlace = header
    if color not in _PNG_CHANNELS:
        raise ValueError(f"unsupported PNG colour type {color}")
    if depth == 16:
        raise ValueError("16-bit PNGs are not supported: save 8-bit images")
    if depth not in _PNG_DEPTHS[color]:
        raise ValueError(f"invalid PNG: bit depth {depth} for colour type {color}")
    if interlace:
        raise ValueError("interlaced (Adam7) PNGs are not supported: save them without interlacing")
    channels = _PNG_CHANNELS[color]
    stride = -(-w * channels * depth // 8)
    rows = _unfilter(zlib.decompress(b"".join(idat)), h, stride, max(channels * depth // 8, 1))
    samples = _unpack_bits(rows, w, depth) if depth < 8 else rows
    if color == 3:
        if palette is None:
            raise ValueError("PNG palette image has no PLTE chunk")
        table = np.zeros((256, 3), np.uint8)
        table[: len(palette)] = palette[:256]
        return table[samples.reshape(h, w)]
    if depth < 8:  # grey at 1, 2 or 4 bits
        samples = samples * np.uint8(255 // ((1 << depth) - 1))
    return samples.reshape(h, w, channels).copy()


_PRECISION_BITS = 32 - 8 - 2  # Pillow's fixed-point coefficients (Resample.c)


def _bilinear_coefficients(in_size: int, out_size: int) -> np.ndarray:
    """Pillow's BILINEAR resample of one axis as an int64 [out, in] matrix
    of 22-bit fixed-point coefficients (``precompute_coeffs`` then
    ``normalize_coeffs_8bpc``): the triangle filter widened by the shrink
    factor, each output's taps inside [xmin, xmax) normalised in float64,
    then rounded half away from zero."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    kk = np.zeros((out_size, in_size), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        w = np.array([max(0.0, 1.0 - abs((x + xmin - center + 0.5) / filterscale)) for x in range(xmax)])
        total = w.sum()
        if total != 0.0:
            w = w / total
        fixed = np.where(w < 0, -0.5 + w * (1 << _PRECISION_BITS), 0.5 + w * (1 << _PRECISION_BITS))
        kk[xx, xmin: xmin + xmax] = np.trunc(fixed).astype(np.int64)
    return kk


def _resample_axis(img: np.ndarray, axis: int, out_size: int) -> np.ndarray:
    """One fixed-point pass along ``axis`` of a uint8 image, rounded back
    to uint8 as Pillow's ``clip8`` rounds (half up, clamped)."""
    kk = _bilinear_coefficients(img.shape[axis], out_size)
    moved = np.moveaxis(img, axis, -1).astype(np.int64)
    acc = (1 << (_PRECISION_BITS - 1)) + moved @ kk.T
    out = np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, -1, axis)


def _premultiply(img: np.ndarray) -> np.ndarray:
    """RGBA / LA → Pillow's RGBa / La: colour times alpha / 255, rounded as
    its ``MULDIV255``."""
    a = img[..., -1:].astype(np.uint32)
    tmp = img[..., :-1].astype(np.uint32) * a + 128
    return np.concatenate([(((tmp >> 8) + tmp) >> 8).astype(np.uint8), img[..., -1:]], axis=-1)


def _unpremultiply(img: np.ndarray) -> np.ndarray:
    """Pillow's RGBa / La → RGBA / LA: colour · 255 / alpha (integer
    division, clamped), unchanged where alpha is 0 or 255."""
    a = img[..., -1:].astype(np.uint32)
    c = img[..., :-1].astype(np.uint32)
    div = np.where((a == 0) | (a == 255), c, np.minimum(c * 255 // np.maximum(a, 1), 255))
    return np.concatenate([div.astype(np.uint8), img[..., -1:]], axis=-1)


def resize_bilinear_uint8(image: np.ndarray, size: int) -> np.ndarray:
    """``Image.fromarray(image).resize((size, size), Image.BILINEAR)`` byte
    for byte, without Pillow: [H, W, C] uint8 (C = 1 grey, 2 grey + alpha,
    3 RGB, 4 RGBA) → [size, size, C]. Pillow's separable fixed-point
    resample: the horizontal pass (if the width changes), rounded to uint8,
    then the vertical one; images with alpha are resampled premultiplied,
    as Pillow resamples RGBA and LA."""
    image = np.asarray(image)
    if image.dtype != np.uint8 or image.ndim != 3 or image.shape[-1] not in (1, 2, 3, 4):
        raise ValueError(f"resize_bilinear_uint8 takes uint8 [H, W, 1|2|3|4], got {image.dtype} {image.shape}")
    if image.shape[:2] == (size, size):  # Pillow returns a copy
        return image.copy()
    alpha = image.shape[-1] in (2, 4)
    out = _premultiply(image) if alpha else image
    if out.shape[1] != size:
        out = _resample_axis(out, 1, size)
    if out.shape[0] != size:
        out = _resample_axis(out, 0, size)
    return _unpremultiply(out) if alpha else out


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
