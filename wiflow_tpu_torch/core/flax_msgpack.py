"""Read and write the msgpack subset that ``flax.serialization`` emits.

``best_pose_model.msgpack`` is ``flax.serialization.msgpack_serialize`` of
the ``{'params', 'batch_stats'}`` tree: nested maps with str keys whose
leaves are numpy arrays, each an ext value of type 1 holding the msgpack
array ``(shape, dtype name, C-order bytes)``.  This module encodes and
decodes exactly that (maps, arrays, str, bin, ints, ext) without the
``msgpack`` package, with the smallest encoding of each value as
``msgpack.packb`` chooses it, so that its output is byte-equal to flax's
for the same tree.  Arrays larger than flax's chunk limit (1 GiB) are
refused rather than chunked: no model here comes near it.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, Tuple

import numpy as np

EXT_NDARRAY = 1          # flax's _MsgpackExtType.ndarray
MAX_ARRAY_BYTES = 2 ** 30


def _int(v: int) -> bytes:
    if 0 <= v < 0x80:
        return bytes([v])
    if -32 <= v < 0:
        return struct.pack(">b", v)
    for lo, hi, code, fmt in ((0, 0xFF, 0xCC, ">B"), (0, 0xFFFF, 0xCD, ">H"),
                              (0, 0xFFFFFFFF, 0xCE, ">I"),
                              (0, 2 ** 64 - 1, 0xCF, ">Q"),
                              (-0x80, 0x7F, 0xD0, ">b"),
                              (-0x8000, 0x7FFF, 0xD1, ">h"),
                              (-0x80000000, 0x7FFFFFFF, 0xD2, ">i"),
                              (-2 ** 63, 2 ** 63 - 1, 0xD3, ">q")):
        if lo <= v <= hi:
            return bytes([code]) + struct.pack(fmt, v)
    raise ValueError(f"integer {v} does not fit msgpack's 64 bits")


def _sized(n: int, fix: Tuple[int, int], codes: Tuple[int, int, int]
           ) -> bytes:
    """The header of a str/bin/array/map of ``n`` items: the fix form when
    ``fix = (base, limit)`` allows, else 8/16/32-bit lengths (``codes``,
    None where the type has no such form)."""
    base, limit = fix
    if n < limit:
        return bytes([base | n])
    for code, fmt, top in zip(codes, (">B", ">H", ">I"),
                              (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= top:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"{n} items exceed msgpack's 32-bit lengths")


def _str(s: str) -> bytes:
    b = s.encode("utf-8")
    return _sized(len(b), (0xA0, 32), (0xD9, 0xDA, 0xDB)) + b


def _bin(b: bytes) -> bytes:
    return _sized(len(b), (0, 0), (0xC4, 0xC5, 0xC6)) + b


def _ext(code: int, data: bytes) -> bytes:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if len(data) in fixed:
        return bytes([fixed[len(data)], code]) + data
    return _sized(len(data), (0, 0), (0xC7, 0xC8, 0xC9)) + \
        bytes([code]) + data


def _ndarray(a: np.ndarray) -> bytes:
    if a.dtype.hasobject or a.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes have no msgpack form")
    if a.nbytes > MAX_ARRAY_BYTES:
        raise ValueError(f"array of {a.nbytes} bytes exceeds flax's chunk "
                         f"limit; chunked arrays are not written here")
    shape = _sized(len(a.shape), (0x90, 16), (None, 0xDC, 0xDD)) + \
        b"".join(_int(d) for d in a.shape)
    return (b"\x93" + shape + _str(a.dtype.name)
            + _bin(np.ascontiguousarray(a).tobytes("C")))


def _pack(obj: Any) -> bytes:
    if isinstance(obj, np.ndarray):
        return _ext(EXT_NDARRAY, _ndarray(obj))
    if isinstance(obj, int) and not isinstance(obj, bool):
        return _int(obj)
    if isinstance(obj, str):
        return _str(obj)
    if isinstance(obj, bytes):
        return _bin(obj)
    if isinstance(obj, dict):
        return _sized(len(obj), (0x80, 16), (None, 0xDE, 0xDF)) + b"".join(
            _pack(k) + _pack(v) for k, v in obj.items())
    if isinstance(obj, (list, tuple)):
        return _sized(len(obj), (0x90, 16), (None, 0xDC, 0xDD)) + \
            b"".join(_pack(v) for v in obj)
    raise TypeError(f"{type(obj).__name__} is outside the msgpack subset "
                    f"flax writes")


def dumps(tree: Dict[str, Any]) -> bytes:
    """Encode a tree of dicts (str keys) with numpy-array leaves, in the
    dicts' iteration order, as ``flax.serialization.msgpack_serialize``
    does."""
    return _pack(tree)


class _Reader:
    def __init__(self, data: bytes):
        self.data, self.pos = memoryview(data), 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n].tobytes()
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self) -> Any:
        b = self.take(1)[0]
        if b < 0x80:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.value() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.take(b & 0x1F).decode("utf-8")
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in ints:
            return self.unpack(ints[b])
        lengths = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I",     # bin
                   0xD9: ">B", 0xDA: ">H", 0xDB: ">I",     # str
                   0xDC: ">H", 0xDD: ">I",                 # array
                   0xDE: ">H", 0xDF: ">I",                 # map
                   0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}     # ext
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self.ext(fixext[b])
        if b not in lengths:
            raise ValueError(f"msgpack type byte 0x{b:02x} is outside the "
                             f"subset flax writes")
        n = self.unpack(lengths[b])
        if b <= 0xC6:
            return self.take(n)
        if b <= 0xC9:
            return self.ext(n)
        if b <= 0xDB:
            return self.take(n).decode("utf-8")
        if b <= 0xDD:
            return [self.value() for _ in range(n)]
        return self.map(n)

    def map(self, n: int) -> Dict[Any, Any]:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    def ext(self, n: int) -> Any:
        code = struct.unpack(">b", self.take(1))[0]
        inner = _Reader(self.take(n))
        if code != EXT_NDARRAY:
            raise ValueError(f"msgpack ext type {code} is outside the subset "
                             f"flax writes")
        shape, dtype, buf = inner.value()
        return np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape)


def loads(data: bytes) -> Any:
    """Decode what :func:`dumps` or ``flax.serialization`` wrote; arrays
    come back read-only, as ``np.frombuffer`` gives them."""
    r = _Reader(data)
    out = r.value()
    if r.pos != len(r.data):
        raise ValueError("trailing bytes after the msgpack value")
    if isinstance(out, dict) and "__msgpack_chunked_array__" in out:
        raise ValueError("chunked arrays are not read here")
    return out
