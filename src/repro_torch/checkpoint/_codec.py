"""The subset of MessagePack that a checkpoint manifest uses.

``packb`` writes the bytes that ``msgpack.packb`` writes with its defaults
(``use_bin_type=True``) for nil, bool, int (in its smallest format),
float (as float 64), str, list/tuple (as array) and dict (as map); any
other type raises ``TypeError``.  ``unpackb`` reads those formats back as
``msgpack.unpackb`` does (arrays to lists).  The ``msgpack`` package is
not needed.
"""

from __future__ import annotations

import struct


def packb(obj) -> bytes:
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


def _pack_len(n: int, fix_tag: int, fix_max: int, tags: tuple,
              out: bytearray) -> None:
    """A length header: the fix form below ``fix_max``, else 8/16/32-bit
    (``tags`` has a ``None`` where a width does not exist)."""
    if n < fix_max:
        out.append(fix_tag | n)
        return
    for tag, fmt, limit in zip(tags, (">B", ">H", ">I"),
                               (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if tag is not None and n <= limit:
            out.append(tag)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack: length {n} too large")


def _pack_int(v: int, out: bytearray) -> None:
    if 0 <= v < 0x80:
        out.append(v)
    elif -0x20 <= v < 0:
        out.append(v & 0xFF)
    elif v >= 0:
        for tag, fmt, limit in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                                (0xCE, ">I", 0xFFFFFFFF),
                                (0xCF, ">Q", 0xFFFFFFFFFFFFFFFF)):
            if v <= limit:
                out.append(tag)
                out += struct.pack(fmt, v)
                return
        raise OverflowError(f"msgpack: int {v} too large")
    else:
        for tag, fmt, limit in ((0xD0, ">b", -0x80), (0xD1, ">h", -0x8000),
                                (0xD2, ">i", -0x80000000),
                                (0xD3, ">q", -0x8000000000000000)):
            if v >= limit:
                out.append(tag)
                out += struct.pack(fmt, v)
                return
        raise OverflowError(f"msgpack: int {v} too small")


def _pack(obj, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True:
        out.append(0xC3)
    elif obj is False:
        out.append(0xC2)
    elif isinstance(obj, int):
        _pack_int(obj, out)
    elif isinstance(obj, float):
        out.append(0xCB)
        out += struct.pack(">d", obj)
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _pack_len(len(data), 0xA0, 32, (0xD9, 0xDA, 0xDB), out)
        out += data
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), 0x90, 16, (None, 0xDC, 0xDD), out)
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        _pack_len(len(obj), 0x80, 16, (None, 0xDE, 0xDF), out)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"msgpack: cannot serialize {type(obj).__name__}")


# Fixed-width formats: tag -> (struct format, byte count).
_SCALARS = {
    0xCB: (">d", 8),
    0xCC: (">B", 1), 0xCD: (">H", 2), 0xCE: (">I", 4), 0xCF: (">Q", 8),
    0xD0: (">b", 1), 0xD1: (">h", 2), 0xD2: (">i", 4), 0xD3: (">q", 8),
}
# Length-prefixed formats: tag -> (kind, struct format of the length).
_SIZED = {
    0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
    0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
    0xDE: ("map", ">H"), 0xDF: ("map", ">I"),
}


def unpackb(data: bytes):
    obj, end = _unpack(memoryview(data), 0)
    if end != len(data):
        raise ValueError(f"msgpack: {len(data) - end} extra bytes")
    return obj


def _unpack(buf: memoryview, i: int):
    tag = buf[i]
    i += 1
    if tag < 0x80:
        return tag, i
    if tag >= 0xE0:
        return tag - 0x100, i
    if 0x80 <= tag <= 0x8F:
        return _container("map", tag & 0x0F, buf, i)
    if 0x90 <= tag <= 0x9F:
        return _container("array", tag & 0x0F, buf, i)
    if 0xA0 <= tag <= 0xBF:
        n = tag & 0x1F
        return str(buf[i:i + n], "utf-8"), i + n
    if tag == 0xC0:
        return None, i
    if tag in (0xC2, 0xC3):
        return tag == 0xC3, i
    if tag in _SCALARS:
        fmt, size = _SCALARS[tag]
        return struct.unpack_from(fmt, buf, i)[0], i + size
    if tag in _SIZED:
        kind, fmt = _SIZED[tag]
        n = struct.unpack_from(fmt, buf, i)[0]
        i += struct.calcsize(fmt)
        if kind == "str":
            return str(buf[i:i + n], "utf-8"), i + n
        return _container(kind, n, buf, i)
    raise ValueError(f"msgpack: unsupported format byte 0x{tag:02x}")


def _container(kind: str, n: int, buf: memoryview, i: int):
    if kind == "array":
        items = []
        for _ in range(n):
            v, i = _unpack(buf, i)
            items.append(v)
        return items, i
    out = {}
    for _ in range(n):
        k, i = _unpack(buf, i)
        v, i = _unpack(buf, i)
        out[k] = v
    return out, i
