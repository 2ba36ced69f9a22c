"""Pure-Python Ed25519 with ZIP-215 verification semantics.

The port's own copy of the reference implementation: the correctness
oracle for the CUDA kernels (``ops/ed25519.py``, ``ops/rlc.py``), the source
of the constant [j]B table, and the key generator and signer for fixtures.  Verification is **cofactored** with **permissive point decoding**
(ZIP-215), matching the semantics CometBFT inherits from curve25519-voi
(reference: ``crypto/ed25519/ed25519.go:169-221`` — `VerifyOptions` there are
ZIP-215 / batch-compatible).  Concretely:

- ``S`` must be canonical (``S < L``); otherwise reject.
- ``A`` and ``R`` encodings may be non-canonical (``y >= p`` accepted) and may
  be small-order / mixed-order points; the ``x = 0`` with sign-bit-1 encodings
  are accepted.
- The verification equation is cofactored: ``[8][S]B == [8]R + [8][h]A``.

Signing is standard RFC 8032.  Everything uses Python big ints — slow, but
exact; the hot path lives on the GPU.
"""

from __future__ import annotations

import hashlib

__all__ = [
    "P", "L", "D", "BX", "BY",
    "sign", "verify_zip215", "public_key_from_seed",
    "pt_decompress_zip215", "pt_compress", "pt_add", "pt_mul", "pt_equal",
    "IDENTITY", "sc_reduce64",
]

P = 2**255 - 19
L = 2**252 + 27742317777372353535851937790883648493
D = (-121665 * pow(121666, P - 2, P)) % P
SQRT_M1 = pow(2, (P - 1) // 4, P)  # sqrt(-1) mod p

BY = (4 * pow(5, P - 2, P)) % P
# Recover base-point x with even parity (RFC 8032: x is the "positive" root).
def _xrecover(y: int) -> int | None:
    xx = (y * y - 1) * pow(D * y * y + 1, P - 2, P) % P
    x = pow(xx, (P + 3) // 8, P)
    if (x * x - xx) % P != 0:
        x = x * SQRT_M1 % P
    if (x * x - xx) % P != 0:
        return None
    return x

BX = _xrecover(BY)
assert BX is not None
if BX % 2 == 1:
    BX = P - BX

# Points are extended homogeneous coordinates (X, Y, Z, T) with x=X/Z, y=Y/Z,
# T = XY/Z.  IDENTITY = (0, 1).
IDENTITY = (0, 1, 1, 0)
BASE = (BX, BY, 1, BX * BY % P)


def pt_add(p1, p2):
    # add-2008-hwcd-3 for a=-1 twisted Edwards (the ed25519 curve form).
    x1, y1, z1, t1 = p1
    x2, y2, z2, t2 = p2
    a = (y1 - x1) * (y2 - x2) % P
    b = (y1 + x1) * (y2 + x2) % P
    c = 2 * D * t1 % P * t2 % P
    dd = 2 * z1 * z2 % P
    e, f, g, h = b - a, dd - c, dd + c, b + a
    return (e * f % P, g * h % P, f * g % P, e * h % P)


def pt_double(p1):
    x1, y1, z1, _ = p1
    a = x1 * x1 % P
    b = y1 * y1 % P
    c = 2 * z1 * z1 % P
    h = (a + b) % P
    e = (h - (x1 + y1) * (x1 + y1)) % P
    g = (a - b) % P
    f = (c + g) % P
    return (e * f % P, g * h % P, f * g % P, e * h % P)


def pt_neg(p1):
    x1, y1, z1, t1 = p1
    return ((-x1) % P, y1, z1, (-t1) % P)


def pt_mul(k: int, pt):
    q = IDENTITY
    while k > 0:
        if k & 1:
            q = pt_add(q, pt)
        pt = pt_double(pt)
        k >>= 1
    return q


def pt_equal(p1, p2) -> bool:
    x1, y1, z1, _ = p1
    x2, y2, z2, _ = p2
    return (x1 * z2 - x2 * z1) % P == 0 and (y1 * z2 - y2 * z1) % P == 0


def pt_compress(p1) -> bytes:
    x1, y1, z1, _ = p1
    zi = pow(z1, P - 2, P)
    x, y = x1 * zi % P, y1 * zi % P
    return int.to_bytes(y | ((x & 1) << 255), 32, "little")


def pt_decompress_zip215(s: bytes):
    """Permissive (ZIP-215) decoding: non-canonical y accepted; x=0/sign=1
    accepted.  Returns an extended point or None if x^2 has no root."""
    if len(s) != 32:
        return None
    enc = int.from_bytes(s, "little")
    sign = enc >> 255
    y = (enc & ((1 << 255) - 1)) % P
    x = _xrecover(y)
    if x is None:
        return None
    if x & 1 != sign:
        x = (-x) % P
    return (x, y, 1, x * y % P)


def sc_reduce64(b: bytes) -> int:
    return int.from_bytes(b, "little") % L


def _clamp(a: bytes) -> int:
    k = bytearray(a)
    k[0] &= 248
    k[31] &= 127
    k[31] |= 64
    return int.from_bytes(bytes(k), "little")


def public_key_from_seed(seed: bytes) -> bytes:
    h = hashlib.sha512(seed).digest()
    a = _clamp(h[:32])
    return pt_compress(pt_mul(a, BASE))


def sign(seed: bytes, msg: bytes) -> bytes:
    h = hashlib.sha512(seed).digest()
    a = _clamp(h[:32])
    prefix = h[32:]
    pub = pt_compress(pt_mul(a, BASE))
    r = sc_reduce64(hashlib.sha512(prefix + msg).digest())
    rb = pt_compress(pt_mul(r, BASE))
    k = sc_reduce64(hashlib.sha512(rb + pub + msg).digest())
    s = (r + k * a) % L
    return rb + int.to_bytes(s, 32, "little")


def verify_zip215(pub: bytes, msg: bytes, sig: bytes) -> bool:
    if len(sig) != 64 or len(pub) != 32:
        return False
    s = int.from_bytes(sig[32:], "little")
    if s >= L:
        return False
    a = pt_decompress_zip215(pub)
    r = pt_decompress_zip215(sig[:32])
    if a is None or r is None:
        return False
    h = sc_reduce64(hashlib.sha512(sig[:32] + pub + msg).digest())
    # [8]([S]B - [h]A - R) == identity
    q = pt_add(pt_mul(s, BASE), pt_neg(pt_add(pt_mul(h, a), r)))
    q = pt_double(pt_double(pt_double(q)))
    return pt_equal(q, IDENTITY)
