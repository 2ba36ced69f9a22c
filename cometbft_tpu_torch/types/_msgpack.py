"""The subset of MessagePack that the port's codec needs, with no
third-party package.

``packb(obj)`` gives the bytes of ``msgpack.packb(obj, use_bin_type=True)``
and ``unpackb(raw)`` inverts them as ``msgpack.unpackb(raw, raw=False)``
does, for these types:

- ``None``, ``bool`` (tested before ``int``: a bool is an int in Python);
- ``int`` from -2**63 to 2**64 - 1: positive and negative fixint, then
  the smallest of uint8/16/32/64 for a positive value and int8/16/32/64
  for a negative one (an out-of-range int raises OverflowError);
- ``str`` (UTF-8): fixstr up to 31 bytes, str8, str16, str32;
- ``bytes``, ``bytearray``, ``memoryview``: bin8, bin16, bin32;
- ``list`` and ``tuple`` (both decode as lists): fixarray up to 15
  items, array16, array32;
- ``dict``, keys in insertion order: fixmap up to 15 entries, map16,
  map32.

Anything else raises TypeError when packed; a byte that starts any
other type (floats, extension types) raises ValueError when unpacked, as
do truncated input and bytes left over after the object.
"""

from __future__ import annotations

import struct

__all__ = ["packb", "unpackb"]

_B = struct.Struct(">B").pack
_H = struct.Struct(">H").pack
_I = struct.Struct(">I").pack
_Q = struct.Struct(">Q").pack
_b = struct.Struct(">b").pack
_h = struct.Struct(">h").pack
_i = struct.Struct(">i").pack
_q = struct.Struct(">q").pack


def _pack_int(v: int, out: list) -> None:
    if 0 <= v <= 0x7F:
        out.append(_B(v))
    elif -32 <= v < 0:
        out.append(_b(v))                       # 0xe0-0xff
    elif v > 0:
        if v <= 0xFF:
            out.append(b"\xcc" + _B(v))
        elif v <= 0xFFFF:
            out.append(b"\xcd" + _H(v))
        elif v <= 0xFFFFFFFF:
            out.append(b"\xce" + _I(v))
        elif v <= 0xFFFFFFFFFFFFFFFF:
            out.append(b"\xcf" + _Q(v))
        else:
            raise OverflowError("Integer value out of range")
    elif v >= -0x80:
        out.append(b"\xd0" + _b(v))
    elif v >= -0x8000:
        out.append(b"\xd1" + _h(v))
    elif v >= -0x80000000:
        out.append(b"\xd2" + _i(v))
    elif v >= -0x8000000000000000:
        out.append(b"\xd3" + _q(v))
    else:
        raise OverflowError("Integer value out of range")


def _pack_len(n: int, fix: int, fix_max: int, c8, c16: bytes, c32: bytes,
              out: list) -> None:
    if n <= fix_max:
        out.append(_B(fix | n))
    elif c8 is not None and n <= 0xFF:
        out.append(c8 + _B(n))
    elif n <= 0xFFFF:
        out.append(c16 + _H(n))
    elif n <= 0xFFFFFFFF:
        out.append(c32 + _I(n))
    else:
        raise ValueError("object too large for msgpack")


def _pack_none(obj, out: list) -> None:
    out.append(b"\xc0")


def _pack_bool(obj, out: list) -> None:
    out.append(b"\xc3" if obj else b"\xc2")


def _pack_str(obj, out: list) -> None:
    raw = obj.encode("utf-8")
    _pack_len(len(raw), 0xA0, 31, b"\xd9", b"\xda", b"\xdb", out)
    out.append(raw)


def _pack_bin(obj, out: list) -> None:
    raw = bytes(obj)
    n = len(raw)
    if n <= 0xFF:
        out.append(b"\xc4" + _B(n))
    elif n <= 0xFFFF:
        out.append(b"\xc5" + _H(n))
    elif n <= 0xFFFFFFFF:
        out.append(b"\xc6" + _I(n))
    else:
        raise ValueError("bin too large for msgpack")
    out.append(raw)


def _pack_array(obj, out: list) -> None:
    _pack_len(len(obj), 0x90, 15, None, b"\xdc", b"\xdd", out)
    for x in obj:
        _PACKERS.get(type(x), _pack_other)(x, out)


def _pack_map(obj, out: list) -> None:
    _pack_len(len(obj), 0x80, 15, None, b"\xde", b"\xdf", out)
    for k, v in obj.items():
        _PACKERS.get(type(k), _pack_other)(k, out)
        _PACKERS.get(type(v), _pack_other)(v, out)


def _pack_other(obj, out: list) -> None:
    """Subclasses of the supported types (bool before int, as msgpack
    tests it); anything else raises TypeError."""
    if isinstance(obj, bool):
        _pack_bool(obj, out)
    elif isinstance(obj, int):
        _pack_int(obj, out)
    elif isinstance(obj, str):
        _pack_str(obj, out)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        _pack_bin(obj, out)
    elif isinstance(obj, (list, tuple)):
        _pack_array(obj, out)
    elif isinstance(obj, dict):
        _pack_map(obj, out)
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


# exact type -> packer; a dict lookup instead of a chain of isinstance
_PACKERS = {type(None): _pack_none, bool: _pack_bool, int: _pack_int,
            str: _pack_str, bytes: _pack_bin, bytearray: _pack_bin,
            memoryview: _pack_bin, list: _pack_array, tuple: _pack_array,
            dict: _pack_map}


def packb(obj) -> bytes:
    out: list = []
    _PACKERS.get(type(obj), _pack_other)(obj, out)
    return b"".join(out)


# first byte -> (kind, width of the length or value that follows)
_FIXED = {
    0xCC: ("u", 1), 0xCD: ("u", 2), 0xCE: ("u", 4), 0xCF: ("u", 8),
    0xD0: ("i", 1), 0xD1: ("i", 2), 0xD2: ("i", 4), 0xD3: ("i", 8),
    0xD9: ("str", 1), 0xDA: ("str", 2), 0xDB: ("str", 4),
    0xC4: ("bin", 1), 0xC5: ("bin", 2), 0xC6: ("bin", 4),
    0xDC: ("array", 2), 0xDD: ("array", 4),
    0xDE: ("map", 2), 0xDF: ("map", 4),
}
_CONST = {0xC0: None, 0xC2: False, 0xC3: True}


def unpackb(raw: bytes):
    buf = bytes(raw)
    end = len(buf)

    def need(off: int, n: int) -> int:
        if off + n > end:
            raise ValueError("msgpack: truncated input")
        return off + n

    def read(off: int):
        """(object, offset after it) of the object at ``off``."""
        if off >= end:
            raise ValueError("msgpack: truncated input")
        b = buf[off]
        off += 1
        if b <= 0x7F:
            return b, off
        if b >= 0xE0:
            return b - 0x100, off
        if 0xA0 <= b <= 0xBF:
            stop = need(off, b & 0x1F)
            return buf[off:stop].decode("utf-8"), stop
        if 0x90 <= b <= 0x9F:
            n, kind = b & 0x0F, "array"
        elif 0x80 <= b <= 0x8F:
            n, kind = b & 0x0F, "map"
        elif b in _CONST:
            return _CONST[b], off
        else:
            kind, width = _FIXED.get(b, (None, 0))
            if kind is None:
                raise ValueError(f"msgpack: unsupported type byte 0x{b:02x}")
            stop = need(off, width)
            if kind == "i":
                return int.from_bytes(buf[off:stop], "big", signed=True), stop
            n = int.from_bytes(buf[off:stop], "big")
            off = stop
            if kind == "u":
                return n, off
            if kind == "str":
                stop = need(off, n)
                return buf[off:stop].decode("utf-8"), stop
            if kind == "bin":
                stop = need(off, n)
                return buf[off:stop], stop
        if kind == "array":
            out = []
            for _ in range(n):
                x, off = read(off)
                out.append(x)
            return out, off
        out = {}
        for _ in range(n):
            k, off = read(off)
            out[k], off = read(off)
        return out, off

    obj, off = read(0)
    if off != end:
        raise ValueError(f"msgpack: {end - off} bytes of extra data after "
                         "the object")
    return obj
