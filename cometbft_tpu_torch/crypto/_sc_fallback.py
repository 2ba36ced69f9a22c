"""X25519 and ChaCha20-Poly1305 for the p2p secret connection
(counterpart of ``cometbft_tpu/crypto/_sc_fallback.py``; RFC 7748 and
RFC 8439), with no third-party package.

- X25519 is Python (the Montgomery ladder of RFC 7748 §5): it runs twice
  a connection, at the handshake.
- :class:`ChaCha20Poly1305` seals and opens every frame through the
  native library (``native.aead_seal``/``aead_open``, ``csrc/host/
  aead.cpp``, built with ``g++`` at first use).  A failed build raises
  ``native.NativeBuildError``: there is no Python substitute on the
  connection's path.
- :func:`seal_plain` and :func:`open_plain` are the cipher in Python,
  the plain version the tests hold the native library against.

The classes keep the names and methods of the ``cryptography`` classes
the JAX package's secret connection uses (``X25519PrivateKey.generate``,
``public_key``, ``exchange``; ``X25519PublicKey.from_public_bytes``,
``public_bytes_raw``; ``ChaCha20Poly1305(key).encrypt``/``decrypt``).
"""

from __future__ import annotations

import os
import struct
from hmac import compare_digest

from .. import native as _native

__all__ = ["InvalidTag", "x25519", "X25519PublicKey", "X25519PrivateKey",
           "ChaCha20Poly1305", "seal_plain", "open_plain"]

_P = 2**255 - 19
_A24 = 121665


class InvalidTag(Exception):
    pass


def x25519(k: bytes, u: bytes) -> bytes:
    """RFC 7748 §5 scalar multiplication (Montgomery ladder)."""
    kb = bytearray(k)
    kb[0] &= 248
    kb[31] &= 127
    kb[31] |= 64
    ki = int.from_bytes(kb, "little")
    x1 = int.from_bytes(u, "little") & ((1 << 255) - 1)
    x2, z2, x3, z3 = 1, 0, x1, 1
    swap = 0
    for t in reversed(range(255)):
        kt = (ki >> t) & 1
        if swap ^ kt:
            x2, x3 = x3, x2
            z2, z3 = z3, z2
        swap = kt
        a = (x2 + z2) % _P
        aa = a * a % _P
        b = (x2 - z2) % _P
        bb = b * b % _P
        e = (aa - bb) % _P
        c = (x3 + z3) % _P
        d = (x3 - z3) % _P
        da = d * a % _P
        cb = c * b % _P
        x3 = (da + cb) % _P
        x3 = x3 * x3 % _P
        z3 = (da - cb) % _P
        z3 = x1 * z3 * z3 % _P
        x2 = aa * bb % _P
        z2 = e * (aa + _A24 * e) % _P
    if swap:
        x2, x3 = x3, x2
        z2, z3 = z3, z2
    return (x2 * pow(z2, _P - 2, _P) % _P).to_bytes(32, "little")


_BASE_U = (9).to_bytes(32, "little")


class X25519PublicKey:
    def __init__(self, raw: bytes):
        self._raw = bytes(raw)

    @classmethod
    def from_public_bytes(cls, raw: bytes) -> "X25519PublicKey":
        if len(raw) != 32:
            raise ValueError("X25519 public key must be 32 bytes")
        return cls(raw)

    def public_bytes_raw(self) -> bytes:
        return self._raw


class X25519PrivateKey:
    def __init__(self, raw: bytes):
        self._raw = bytes(raw)

    @classmethod
    def generate(cls) -> "X25519PrivateKey":
        return cls(os.urandom(32))

    def public_key(self) -> X25519PublicKey:
        return X25519PublicKey(x25519(self._raw, _BASE_U))

    def exchange(self, peer: X25519PublicKey) -> bytes:
        shared = x25519(self._raw, peer.public_bytes_raw())
        if shared == b"\x00" * 32:
            raise ValueError("X25519 exchange produced the zero point")
        return shared


class ChaCha20Poly1305:
    """RFC 8439 AEAD (32-byte key, 12-byte nonces, 16-byte tag) over the
    native library."""

    def __init__(self, key: bytes):
        if len(key) != 32:
            raise ValueError("ChaCha20Poly1305 key must be 32 bytes")
        self._key = bytes(key)

    def encrypt(self, nonce: bytes, data: bytes, aad: bytes | None) -> bytes:
        return _native.aead_seal(self._key, nonce, data, aad or b"")

    def decrypt(self, nonce: bytes, data: bytes, aad: bytes | None) -> bytes:
        if len(data) < 16:
            raise InvalidTag("ciphertext shorter than the tag")
        out = _native.aead_open(self._key, nonce, data, aad or b"")
        if out is None:
            raise InvalidTag("poly1305 tag mismatch")
        return out


# ------------------------------------------- the plain version (tests only)

def _rotl(x: int, n: int) -> int:
    return ((x << n) | (x >> (32 - n))) & 0xFFFFFFFF


def _chacha_block(key_words, counter: int, nonce_words) -> bytes:
    init = [0x61707865, 0x3320646E, 0x79622D32, 0x6B206574,
            *key_words, counter & 0xFFFFFFFF, *nonce_words]
    s = list(init)

    def qr(a, b, c, d):
        s[a] = (s[a] + s[b]) & 0xFFFFFFFF
        s[d] = _rotl(s[d] ^ s[a], 16)
        s[c] = (s[c] + s[d]) & 0xFFFFFFFF
        s[b] = _rotl(s[b] ^ s[c], 12)
        s[a] = (s[a] + s[b]) & 0xFFFFFFFF
        s[d] = _rotl(s[d] ^ s[a], 8)
        s[c] = (s[c] + s[d]) & 0xFFFFFFFF
        s[b] = _rotl(s[b] ^ s[c], 7)

    for _ in range(10):
        qr(0, 4, 8, 12)
        qr(1, 5, 9, 13)
        qr(2, 6, 10, 14)
        qr(3, 7, 11, 15)
        qr(0, 5, 10, 15)
        qr(1, 6, 11, 12)
        qr(2, 7, 8, 13)
        qr(3, 4, 9, 14)
    return struct.pack("<16I",
                       *((s[i] + init[i]) & 0xFFFFFFFF for i in range(16)))


def _chacha_stream(key: bytes, counter: int, nonce: bytes,
                   data: bytes) -> bytes:
    kw = struct.unpack("<8I", key)
    nw = struct.unpack("<3I", nonce)
    out = bytearray(len(data))
    for i in range(0, len(data), 64):
        ks = _chacha_block(kw, counter + i // 64, nw)
        chunk = data[i:i + 64]
        out[i:i + len(chunk)] = bytes(a ^ b for a, b in zip(chunk, ks))
    return bytes(out)


def _poly1305(key32: bytes, msg: bytes) -> bytes:
    r = int.from_bytes(key32[:16], "little") \
        & 0x0FFFFFFC0FFFFFFC0FFFFFFC0FFFFFFF
    s = int.from_bytes(key32[16:32], "little")
    p = (1 << 130) - 5
    acc = 0
    for i in range(0, len(msg), 16):
        blk = msg[i:i + 16]
        acc = (acc + int.from_bytes(blk, "little")
               + (1 << (8 * len(blk)))) * r % p
    return ((acc + s) & ((1 << 128) - 1)).to_bytes(16, "little")


def _pad16(b: bytes) -> bytes:
    return b"\x00" * (-len(b) % 16)


def _mac(key: bytes, nonce: bytes, aad: bytes, ct: bytes) -> bytes:
    otk = _chacha_block(struct.unpack("<8I", key), 0,
                        struct.unpack("<3I", nonce))[:32]
    data = (aad + _pad16(aad) + ct + _pad16(ct)
            + struct.pack("<QQ", len(aad), len(ct)))
    return _poly1305(otk, data)


def seal_plain(key: bytes, nonce: bytes, data: bytes, aad: bytes) -> bytes:
    """RFC 8439 seal in Python (the plain version of
    ``native.aead_seal``)."""
    ct = _chacha_stream(key, 1, nonce, data)
    return ct + _mac(key, nonce, aad, ct)


def open_plain(key: bytes, nonce: bytes, data: bytes, aad: bytes):
    """RFC 8439 open in Python: the plaintext, or None on a bad tag."""
    if len(data) < 16:
        return None
    ct, tag = data[:-16], data[-16:]
    if not compare_digest(_mac(key, nonce, aad, ct), tag):
        return None
    return _chacha_stream(key, 1, nonce, ct)
