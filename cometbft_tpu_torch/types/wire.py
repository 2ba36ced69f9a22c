"""Minimal proto3 wire-format writer.

The reference's canonical sign-bytes and hashing are defined over protobuf
encodings (``types/canonical.go``, ``types/vote.go:150``, header field
hashing in ``types/block.go``).  This module provides the deterministic
encoder primitives those layers need — hand-rolled (no generated code) so
the byte layout is explicit and auditable.  proto3 semantics: fields with
zero values are omitted unless explicitly forced.

The port's own copy of ``cometbft_tpu/types/wire.py``.
"""

from __future__ import annotations

__all__ = [
    "varint", "zigzag", "tag", "field_varint", "field_bytes", "field_string",
    "field_fixed64", "field_sfixed64", "field_message", "length_prefixed",
    "WIRE_VARINT", "WIRE_FIXED64", "WIRE_BYTES",
]

WIRE_VARINT = 0
WIRE_FIXED64 = 1
WIRE_BYTES = 2


def varint(n: int) -> bytes:
    """Unsigned LEB128; negative int64 encodes as its 2^64 complement."""
    if n < 0:
        n += 1 << 64
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def zigzag(n: int) -> int:
    return (n << 1) ^ (n >> 63)


def tag(field: int, wire_type: int) -> bytes:
    return varint((field << 3) | wire_type)


def field_varint(field: int, value: int, force: bool = False) -> bytes:
    if value == 0 and not force:
        return b""
    return tag(field, WIRE_VARINT) + varint(value)


def field_fixed64(field: int, value: int, force: bool = False) -> bytes:
    if value == 0 and not force:
        return b""
    return tag(field, WIRE_FIXED64) + (value & ((1 << 64) - 1)).to_bytes(8, "little")


def field_sfixed64(field: int, value: int, force: bool = False) -> bytes:
    return field_fixed64(field, value & ((1 << 64) - 1) if value < 0 else value,
                         force)


def field_bytes(field: int, value: bytes, force: bool = False) -> bytes:
    if not value and not force:
        return b""
    return tag(field, WIRE_BYTES) + varint(len(value)) + bytes(value)


def field_string(field: int, value: str, force: bool = False) -> bytes:
    return field_bytes(field, value.encode("utf-8"), force)


def field_message(field: int, encoded: bytes | None,
                  force: bool = False) -> bytes:
    """Embedded message; None omits the field, b'' emits an empty message."""
    if encoded is None and not force:
        return b""
    enc = encoded or b""
    return tag(field, WIRE_BYTES) + varint(len(enc)) + enc


def length_prefixed(encoded: bytes) -> bytes:
    """Length-delimited framing (the reference's SignBytes outermost layer,
    protoio.MarshalDelimited)."""
    return varint(len(encoded)) + encoded
