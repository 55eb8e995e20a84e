"""A msgpack codec on the standard library for flax's parameter trees.

The ``.dmn`` archives of the JAX package hold their weights as
``flax.serialization.msgpack_serialize`` bytes. The card's machine has
neither ``msgpack`` nor ``flax``, so this module reads and writes the subset
that those two functions use:

- maps (str keys), str, bin, int, float (32- and 64-bit), bool, nil, arrays;
- ext type 1 (an ndarray): msgpack of ``(shape, dtype name, C-order bytes)``;
- ext type 3 (a numpy scalar): the same encoding of a 0-d array;
- flax's chunked-array dict (``__msgpack_chunked_array__``), which it writes
  for arrays over ``MAX_CHUNK_SIZE`` bytes.

Arrays decode to numpy arrays, except ``bfloat16``, which numpy lacks: it
decodes to a ``torch.bfloat16`` tensor (its bits, never widened). A
``torch.Tensor`` encodes as the ndarray of its values (bf16 as its bits
under the dtype name ``bfloat16``), so the bytes are those flax writes for
the same array.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

__all__ = ["packb", "unpackb", "MAX_CHUNK_SIZE"]

MAX_CHUNK_SIZE = 2**30  # flax.serialization.MAX_CHUNK_SIZE
_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3
_CHUNKED = "__msgpack_chunked_array__"


# ------------------------------------------------------------------ encoder --
def _pack_int(v: int, out: List[bytes]) -> None:
    if 0 <= v < 0x80:
        out.append(struct.pack("B", v))
    elif -32 <= v < 0:
        out.append(struct.pack("b", v))
    elif 0 <= v <= 0xFF:
        out.append(b"\xcc" + struct.pack("B", v))
    elif 0 <= v <= 0xFFFF:
        out.append(b"\xcd" + struct.pack(">H", v))
    elif 0 <= v <= 0xFFFFFFFF:
        out.append(b"\xce" + struct.pack(">I", v))
    elif 0 <= v <= 0xFFFFFFFFFFFFFFFF:
        out.append(b"\xcf" + struct.pack(">Q", v))
    elif -0x80 <= v:
        out.append(b"\xd0" + struct.pack(">b", v))
    elif -0x8000 <= v:
        out.append(b"\xd1" + struct.pack(">h", v))
    elif -0x80000000 <= v:
        out.append(b"\xd2" + struct.pack(">i", v))
    elif -0x8000000000000000 <= v:
        out.append(b"\xd3" + struct.pack(">q", v))
    else:
        raise OverflowError(f"int {v} does not fit msgpack's 64 bits")


def _pack_len(n: int, fix: Tuple[int, int], codes: Tuple[bytes, ...], out: List[bytes]) -> None:
    """Header of a str / bin / array / map of length ``n``: the fix form if
    ``fix`` = (base, limit) allows it, then 8-, 16- or 32-bit lengths."""
    if fix and n < fix[1]:
        out.append(struct.pack("B", fix[0] | n))
        return
    for code, fmt, limit in zip(codes, (">B", ">H", ">I"), (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= limit:
            out.append(code + struct.pack(fmt, n))
            return
    raise OverflowError(f"msgpack object of length {n} is too long")


def _array_bytes(arr: Any) -> bytes:
    """flax's ``_ndarray_to_bytes``: msgpack of (shape, dtype name, bytes)."""
    if torch.is_tensor(arr):
        t = arr.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            shape, name, data = tuple(t.shape), "bfloat16", t.view(torch.int16).numpy().tobytes()
        else:
            a = t.numpy()
            shape, name, data = a.shape, a.dtype.name, a.tobytes()
    else:
        a = np.asarray(arr)
        if a.dtype.hasobject or a.dtype.fields is not None:
            raise ValueError("object and structured dtypes cannot be serialized")
        shape, name, data = a.shape, a.dtype.name, a.tobytes("C")
    return packb([list(shape), name, data])


def _pack_ext(code: int, data: bytes, out: List[bytes]) -> None:
    fixed = {1: b"\xd4", 2: b"\xd5", 4: b"\xd6", 8: b"\xd7", 16: b"\xd8"}
    if len(data) in fixed:
        out.append(fixed[len(data)] + struct.pack("b", code))
    else:
        _pack_len(len(data), (), (b"\xc7", b"\xc8", b"\xc9"), out)
        out.append(struct.pack("b", code))
    out.append(data)


def _pack(obj: Any, out: List[bytes]) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True or obj is False:
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, np.generic):
        _pack_ext(_EXT_NPSCALAR, _array_bytes(np.asarray(obj)), out)
    elif isinstance(obj, int):
        _pack_int(int(obj), out)
    elif isinstance(obj, float):
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _pack_len(len(data), (0xA0, 32), (b"\xd9", b"\xda", b"\xdb"), out)
        out.append(data)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        _pack_len(len(data), (), (b"\xc4", b"\xc5", b"\xc6"), out)
        out.append(data)
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), (0x90, 16), (None, b"\xdc", b"\xdd"), out)
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        _pack_len(len(obj), (0x80, 16), (None, b"\xde", b"\xdf"), out)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(obj, np.ndarray) or torch.is_tensor(obj):
        _pack_ext(_EXT_NDARRAY, _array_bytes(obj), out)
    else:
        raise TypeError(f"cannot msgpack a {type(obj).__name__}")


def _nbytes(a: Any) -> int:
    return a.numel() * a.element_size() if torch.is_tensor(a) else a.size * a.dtype.itemsize


def _chunk(arr: Any) -> Dict[str, Any]:
    """flax's ``_chunk``: a flat array split into ``MAX_CHUNK_SIZE`` pieces."""
    itemsize = arr.element_size() if torch.is_tensor(arr) else arr.dtype.itemsize
    size = max(1, MAX_CHUNK_SIZE // itemsize)
    flat = arr.reshape(-1)
    chunks = [flat[i : i + size] for i in range(0, flat.shape[0], size)]
    return {_CHUNKED: True, "shape": {str(i): int(s) for i, s in enumerate(arr.shape)},
            "chunks": {str(i): c for i, c in enumerate(chunks)}}


def _chunk_leaves(tree: Any) -> Any:
    if isinstance(tree, dict):  # keys sorted, as flax's tree_map leaves them
        return {k: _chunk_leaves(tree[k]) for k in sorted(tree)}
    if (isinstance(tree, np.ndarray) or torch.is_tensor(tree)) and _nbytes(tree) > MAX_CHUNK_SIZE:
        return _chunk(tree)
    return tree


def packb(tree: Any) -> bytes:
    """``flax.serialization.msgpack_serialize``, byte for byte: map keys
    sorted, arrays over ``MAX_CHUNK_SIZE`` bytes chunked, then msgpack with
    the array ext types."""
    out: List[bytes] = []
    _pack(_chunk_leaves(tree), out)
    return b"".join(out)


# ------------------------------------------------------------------ decoder --
class _Decoder:
    def __init__(self, data: bytes, raw: bool = False):
        self.data, self.pos, self.raw = memoryview(data), 0, raw

    def _take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack data ends early")
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out

    def _unpack(self, fmt: str) -> Any:
        return struct.unpack(fmt, self._take(struct.calcsize(fmt)))[0]

    def _str(self, n: int) -> Any:
        b = bytes(self._take(n))
        return b if self.raw else b.decode("utf-8")

    def _ext(self, n: int) -> Any:
        code = self._unpack("b")
        data = bytes(self._take(n))
        if code == _EXT_NDARRAY:
            return _array_from_bytes(data)
        if code == _EXT_NPSCALAR:
            a = _array_from_bytes(data)
            return a.reshape(()) if torch.is_tensor(a) else a[()]
        raise ValueError(f"msgpack ext type {code} is not one flax writes for arrays")

    def obj(self) -> Any:
        b = self._unpack("B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.obj() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self._str(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        lengths = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
        if b in lengths:
            return bytes(self._take(self._unpack(lengths[b])))
        exts = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
        if b in exts:
            return self._ext(self._unpack(exts[b]))
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                   0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in numbers:
            return self._unpack(numbers[b])
        fixexts = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixexts:
            return self._ext(fixexts[b])
        strs = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
        if b in strs:
            return self._str(self._unpack(strs[b]))
        if b in (0xDC, 0xDD):
            return [self.obj() for _ in range(self._unpack(">H" if b == 0xDC else ">I"))]
        if b in (0xDE, 0xDF):
            return self._map(self._unpack(">H" if b == 0xDE else ">I"))
        raise ValueError(f"msgpack type byte 0x{b:02x} is not supported")

    def _map(self, n: int) -> Dict[Any, Any]:
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out


def _array_from_bytes(data: bytes) -> Any:
    """flax's ``_ndarray_from_bytes``: numpy, or torch for bfloat16."""
    dec = _Decoder(data, raw=True)
    shape, name, buf = dec.obj()
    shape = tuple(int(s) for s in shape)
    name = name.decode("ascii")
    if name == "bfloat16":
        bits = np.frombuffer(buf, dtype=np.int16).reshape(shape)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape, order="C")


def _unchunk_leaves(tree: Any) -> Any:
    if isinstance(tree, dict):
        if tree.get(_CHUNKED):
            shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            if torch.is_tensor(chunks[0]):
                return torch.cat(chunks).reshape(shape)
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk_leaves(v) for k, v in tree.items()}
    return tree


def unpackb(data: bytes) -> Any:
    """``flax.serialization.msgpack_restore``: the tree with array leaves."""
    dec = _Decoder(data)
    out = dec.obj()
    if dec.pos != len(dec.data):
        raise ValueError(f"{len(dec.data) - dec.pos} bytes of trailing data after the msgpack object")
    return _unchunk_leaves(out)
