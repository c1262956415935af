"""A small MessagePack writer and reader for checkpoint manifests and the
``grpc_sim`` transport's bodies.

The manifest (``meta.msgpack.zlib``) needs maps, arrays, strings, ints,
nil and bools; ``grpc_sim`` frames its messages as maps of bytes
(``bin`` 8/16/32) and its typed errors carry a float ``retry_after``
(float 64). This module writes and reads exactly that subset with the
encodings the ``msgpack`` package picks (``packb(obj, use_bin_type=True)``
gives the same bytes), so what either side writes reads on the other; it
also reads float 32. Any other type raises.
"""
from __future__ import annotations

import struct
from typing import Any, Tuple


def packb(obj: Any) -> bytes:
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


def _pack(obj: Any, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True or obj is False:
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, int):
        _pack_int(obj, out)
    elif isinstance(obj, float):
        out += b"\xcb" + struct.pack(">d", obj)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        raw = memoryview(obj).cast("B")
        n = raw.nbytes
        if n < 1 << 8:
            out += bytes((0xC4, n))
        elif n < 1 << 16:
            out += b"\xc5" + struct.pack(">H", n)
        else:
            out += b"\xc6" + struct.pack(">I", n)
        out += raw
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        n = len(raw)
        if n < 32:
            out.append(0xA0 | n)
        elif n < 1 << 8:
            out += bytes((0xD9, n))
        elif n < 1 << 16:
            out += b"\xda" + struct.pack(">H", n)
        else:
            out += b"\xdb" + struct.pack(">I", n)
        out += raw
    elif isinstance(obj, (list, tuple)):
        _header(len(obj), 0x90, 0xDC, out)
        for x in obj:
            _pack(x, out)
    elif isinstance(obj, dict):
        _header(len(obj), 0x80, 0xDE, out)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"msgpack_lite: cannot pack {type(obj).__name__}")


def _header(n: int, fix: int, code16: int, out: bytearray) -> None:
    if n < 16:
        out.append(fix | n)
    elif n < 1 << 16:
        out += bytes((code16,)) + struct.pack(">H", n)
    else:
        out += bytes((code16 + 1,)) + struct.pack(">I", n)


def _pack_int(v: int, out: bytearray) -> None:
    if 0 <= v < 128:
        out.append(v)
    elif -32 <= v < 0:
        out.append(v & 0xFF)
    elif v >= 0:
        for code, fmt, top in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                               (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
            if v < top:
                out += bytes((code,)) + struct.pack(fmt, v)
                return
        raise OverflowError(f"msgpack_lite: {v} does not fit in 64 bits")
    else:
        for code, fmt, lo in ((0xD0, ">b", -(1 << 7)), (0xD1, ">h", -(1 << 15)),
                              (0xD2, ">i", -(1 << 31)), (0xD3, ">q", -(1 << 63))):
            if v >= lo:
                out += bytes((code,)) + struct.pack(fmt, v)
                return
        raise OverflowError(f"msgpack_lite: {v} does not fit in 64 bits")


def unpackb(data: bytes) -> Any:
    obj, end = _unpack(memoryview(data), 0)
    if end != len(data):
        raise ValueError(f"msgpack_lite: {len(data) - end} trailing bytes")
    return obj


_FIXED = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
          0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
          0xCA: ">f", 0xCB: ">d"}
_LENGTHS = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I",       # bin 8/16/32
            0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}       # str 8/16/32


def _unpack(buf: memoryview, i: int) -> Tuple[Any, int]:
    c = buf[i]
    i += 1
    if c < 0x80:
        return c, i
    if c >= 0xE0:
        return c - 0x100, i
    if 0xA0 <= c <= 0xBF:
        return _str(buf, i, c & 0x1F)
    if 0x90 <= c <= 0x9F:
        return _array(buf, i, c & 0x0F)
    if 0x80 <= c <= 0x8F:
        return _map(buf, i, c & 0x0F)
    if c == 0xC0:
        return None, i
    if c in (0xC2, 0xC3):
        return c == 0xC3, i
    if c in _FIXED:
        fmt = _FIXED[c]
        size = struct.calcsize(fmt)
        return struct.unpack_from(fmt, buf, i)[0], i + size
    if c in _LENGTHS:
        fmt = _LENGTHS[c]
        n = struct.unpack_from(fmt, buf, i)[0]
        i += struct.calcsize(fmt)
        if c <= 0xC6:
            return bytes(buf[i:i + n]), i + n
        return _str(buf, i, n)
    if c in (0xDC, 0xDD, 0xDE, 0xDF):
        fmt = ">H" if c in (0xDC, 0xDE) else ">I"
        n = struct.unpack_from(fmt, buf, i)[0]
        i += struct.calcsize(fmt)
        return (_array if c in (0xDC, 0xDD) else _map)(buf, i, n)
    raise ValueError(f"msgpack_lite: unsupported type byte 0x{c:02x}")


def _str(buf: memoryview, i: int, n: int) -> Tuple[str, int]:
    return bytes(buf[i:i + n]).decode("utf-8"), i + n


def _array(buf: memoryview, i: int, n: int) -> Tuple[list, int]:
    out = []
    for _ in range(n):
        x, i = _unpack(buf, i)
        out.append(x)
    return out, i


def _map(buf: memoryview, i: int, n: int) -> Tuple[dict, int]:
    out = {}
    for _ in range(n):
        k, i = _unpack(buf, i)
        v, i = _unpack(buf, i)
        out[k] = v
    return out, i
