"""Pure-Python reader for flax's msgpack checkpoint format (the
benchmark's own frozen copy, so that the reference reads the weights
without the program).

``flax.serialization.to_bytes`` writes a msgpack map tree whose array
leaves are msgpack extension objects:

- ext type 1 (ndarray): payload is a msgpack array
  ``(shape, dtype_name, C-order bytes)``;
- ext type 3 (numpy scalar): the same payload, for a 0-d array.

This module decodes that format with numpy alone, so a machine without
flax or msgpack can load the weights. ``bfloat16`` leaves are widened to
float32 exactly (the bf16 bits are the high half of the f32 bits).
"""
from __future__ import annotations

import struct

import numpy as np

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


class _Reader:
    def __init__(self, buf: bytes):
        self.buf = memoryview(buf)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


def _array(payload: bytes) -> np.ndarray:
    shape, dtype_name, data = _decode(_Reader(payload))
    if isinstance(dtype_name, bytes):
        dtype_name = dtype_name.decode()
    if dtype_name == "bfloat16":
        bits = np.frombuffer(data, dtype="<u2").astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(data, dtype=np.dtype(dtype_name)).reshape(
        shape).copy()


def _ext(code: int, payload: bytes):
    if code == _EXT_NDARRAY:
        return _array(payload)
    if code == _EXT_NPSCALAR:
        return _array(payload)[()]
    raise ValueError(f"unsupported msgpack ext type {code}")


def _decode(r: _Reader):
    b = r.unpack(">B")
    if b <= 0x7f:
        return b
    if b >= 0xe0:
        return b - 0x100
    if 0x80 <= b <= 0x8f:
        return _map(r, b & 0x0f)
    if 0x90 <= b <= 0x9f:
        return [_decode(r) for _ in range(b & 0x0f)]
    if 0xa0 <= b <= 0xbf:
        return bytes(r.take(b & 0x1f)).decode()
    if b == 0xc0:
        return None
    if b == 0xc2:
        return False
    if b == 0xc3:
        return True
    if b in (0xc4, 0xc5, 0xc6):                             # bin 8/16/32
        n = r.unpack((">B", ">H", ">I")[b - 0xc4])
        return bytes(r.take(n))
    if b in (0xc7, 0xc8, 0xc9):                             # ext 8/16/32
        n = r.unpack((">B", ">H", ">I")[b - 0xc7])
        code = r.unpack(">b")
        return _ext(code, bytes(r.take(n)))
    if b == 0xca:
        return r.unpack(">f")
    if b == 0xcb:
        return r.unpack(">d")
    if 0xcc <= b <= 0xcf:                                   # uint 8..64
        return r.unpack((">B", ">H", ">I", ">Q")[b - 0xcc])
    if 0xd0 <= b <= 0xd3:                                   # int 8..64
        return r.unpack((">b", ">h", ">i", ">q")[b - 0xd0])
    if 0xd4 <= b <= 0xd8:                                   # fixext 1..16
        code = r.unpack(">b")
        return _ext(code, bytes(r.take(1 << (b - 0xd4))))
    if b in (0xd9, 0xda, 0xdb):                             # str 8/16/32
        n = r.unpack((">B", ">H", ">I")[b - 0xd9])
        return bytes(r.take(n)).decode()
    if b in (0xdc, 0xdd):                                   # array 16/32
        n = r.unpack(">H" if b == 0xdc else ">I")
        return [_decode(r) for _ in range(n)]
    if b in (0xde, 0xdf):                                   # map 16/32
        return _map(r, r.unpack(">H" if b == 0xde else ">I"))
    raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")


def _map(r: _Reader, n: int) -> dict:
    out = {}
    for _ in range(n):
        k = _decode(r)
        out[k] = _decode(r)
    return out


def msgpack_restore(data: bytes):
    """Decode flax msgpack bytes into a nested dict of numpy arrays."""
    r = _Reader(data)
    tree = _decode(r)
    if r.pos != len(r.buf):
        raise ValueError(f"{len(r.buf) - r.pos} trailing bytes after the "
                         "msgpack object")
    return tree


def load(path: str):
    """Read a flax msgpack checkpoint file into a nested dict."""
    with open(path, "rb") as f:
        return msgpack_restore(f.read())
