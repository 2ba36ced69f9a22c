"""Pure-Python secp256k1 ECDSA (RFC 6979 deterministic nonces).

A copy of ``cometbft_tpu/crypto/_secp256k1_py.py``: key derivation,
signing and verification in big-int Python, low-S normalised,
compressed SEC1 public keys.  It is the tests' plain version of the
native signer and verifier (``csrc/host/secp256k1.cpp``); nothing on the
port's paths calls it.
"""

from __future__ import annotations

import hashlib
import hmac

P = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEFFFFFC2F
N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
GX = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
GY = 0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8

_INF = None                      # point at infinity sentinel


def _add(p1, p2):
    if p1 is _INF:
        return p2
    if p2 is _INF:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if (y1 + y2) % P == 0:
            return _INF
        lam = (3 * x1 * x1) * pow(2 * y1, -1, P) % P
    else:
        lam = (y2 - y1) * pow(x2 - x1, -1, P) % P
    x3 = (lam * lam - x1 - x2) % P
    return (x3, (lam * (x1 - x3) - y1) % P)


def _mul(k: int, pt):
    acc, add = _INF, pt
    while k:
        if k & 1:
            acc = _add(acc, add)
        add = _add(add, add)
        k >>= 1
    return acc


def pubkey_from_scalar(d: int) -> bytes:
    """Compressed SEC1 encoding of d*G."""
    x, y = _mul(d, (GX, GY))
    return bytes([2 + (y & 1)]) + x.to_bytes(32, "big")


def decompress(raw: bytes):
    """(x, y) from a 33-byte compressed SEC1 point; raises ValueError."""
    if len(raw) != 33 or raw[0] not in (2, 3):
        raise ValueError("not a compressed secp256k1 point")
    x = int.from_bytes(raw[1:], "big")
    if x >= P:
        raise ValueError("x out of range")
    y2 = (x * x * x + 7) % P
    y = pow(y2, (P + 1) // 4, P)
    if y * y % P != y2:
        raise ValueError("point not on curve")
    if (y & 1) != (raw[0] & 1):
        y = P - y
    return (x, y)


def rfc6979_k(d: int, h1: bytes) -> int:
    """Deterministic nonce (RFC 6979 §3.2) for SHA-256, curve order N."""
    holen = 32
    x = d.to_bytes(32, "big")
    # bits2octets: h1 as int (qlen == hlen == 256, no shift), reduced mod N
    z = int.from_bytes(h1, "big") % N
    bo = z.to_bytes(32, "big")
    v = b"\x01" * holen
    k = b"\x00" * holen
    k = hmac.new(k, v + b"\x00" + x + bo, hashlib.sha256).digest()
    v = hmac.new(k, v, hashlib.sha256).digest()
    k = hmac.new(k, v + b"\x01" + x + bo, hashlib.sha256).digest()
    v = hmac.new(k, v, hashlib.sha256).digest()
    while True:
        v = hmac.new(k, v, hashlib.sha256).digest()
        cand = int.from_bytes(v, "big")
        if 1 <= cand < N:
            return cand
        k = hmac.new(k, v + b"\x00", hashlib.sha256).digest()
        v = hmac.new(k, v, hashlib.sha256).digest()


def sign(d: int, msg: bytes) -> tuple[int, int]:
    """(r, s) over SHA-256(msg), low-S normalized."""
    h1 = hashlib.sha256(msg).digest()
    z = int.from_bytes(h1, "big") % N
    k = rfc6979_k(d, h1)
    while True:
        x, _y = _mul(k, (GX, GY))
        r = x % N
        if r != 0:
            s = pow(k, -1, N) * (z + r * d) % N
            if s != 0:
                break
        # astronomically unlikely; RFC 6979 retries with an updated K
        k = (k + 1) % N or 1
    if s > N // 2:
        s = N - s
    return r, s


def verify(pub_raw: bytes, msg: bytes, r: int, s: int) -> bool:
    if not (1 <= r < N and 1 <= s < N):
        return False
    try:
        q = decompress(pub_raw)
    except ValueError:
        return False
    z = int.from_bytes(hashlib.sha256(msg).digest(), "big") % N
    w = pow(s, -1, N)
    pt = _add(_mul(z * w % N, (GX, GY)), _mul(r * w % N, q))
    if pt is _INF:
        return False
    return pt[0] % N == r
