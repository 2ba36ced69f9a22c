"""BLS12-381 keys, signatures and aggregation on the host.

Counterpart of ``cometbft_tpu/crypto/bls12381.py`` with its native
backend: the standard G2Basic suite (BLS_SIG_BLS12381G2_XMD:SHA-256_
SSWU_RO_NUL_), 32-byte private keys, 48-byte compressed G1 public keys,
96-byte compressed G2 signatures, and proofs of possession under the POP_
suite.  Everything but the HKDF key derivation runs in the host C++
library ``csrc/host/bls12381.cpp`` (``native.load``), which checks itself
with ``bls_selftest`` when it is loaded; a library that does not build
or fails its self-test raises, and there is no pure-Python substitute.

The pairings stay on the host: an aggregate commit costs two of them
(:func:`verify_aggregate_affine`) over the G1 sum that the device folds
(``crypto/blsagg.py``, kernel ``ops/blsg1.py``).  Signing uses a
double-and-add ladder that is not constant-time: keys made here serve
tests and fixtures, not a validator that signs in production.
"""

from __future__ import annotations

import ctypes
import hashlib
import hmac

from .. import native
from .keys import BLS12381_KEY_TYPE, address_hash

__all__ = ["PRIV_KEY_SIZE", "PUB_KEY_SIZE", "SIGNATURE_LENGTH", "P", "R",
           "keygen", "sk_to_pk", "sign", "Bls12381PubKey", "Bls12381PrivKey",
           "pk_to_affine", "aggregate_affine", "negate_affine",
           "verify_aggregate_affine", "aggregate_signatures", "pop_prove",
           "pop_verify"]

PRIV_KEY_SIZE = 32
PUB_KEY_SIZE = 48
SIGNATURE_LENGTH = 96
P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB  # noqa: E501
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001

_c, _n, _i = ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int
_SIGNATURES = {
    "bls_sk_to_pk": [_c, _c],
    "bls_sign": [_c, _c, _n, _c],
    "bls_verify": [_c, _c, _n, _c],
    "bls_agg_sigs": [_c, _n, _i, _c],
    "bls_pk_to_affine": [_c, _c],
    "bls_agg_affine": [_c, _n, _c],
    "bls_verify_agg_affine": [_c, _c, _n, _c],
    "bls_pop_prove": [_c, _c],
    "bls_pop_verify": [_c, _c],
}
_LIB: list = []


def _lib():
    """The host library, loaded and self-tested once per process."""
    if not _LIB:
        lib = native.load("bls12381")
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.bls_selftest.restype = ctypes.c_int
        if lib.bls_selftest() != 1:
            raise RuntimeError("bls12381 host library failed its self-test")
        _LIB.append(lib)
    return _LIB[0]


def keygen(ikm: bytes, key_info: bytes = b"") -> int:
    """HKDF key derivation (draft-irtf-cfrg-bls-signature KeyGen), the
    JAX package's ``_bls12381_py.keygen``."""
    if len(ikm) < 32:
        raise ValueError("ikm must be >= 32 bytes")
    salt = b"BLS-SIG-KEYGEN-SALT-"
    sk = 0
    while sk == 0:
        prk = hmac.new(hashlib.sha256(salt).digest(), ikm + b"\x00",
                       hashlib.sha256).digest()
        okm, t = b"", b""
        info = key_info + (48).to_bytes(2, "big")
        for i in range(1, 3):
            t = hmac.new(prk, t + info + bytes([i]), hashlib.sha256).digest()
            okm += t
        sk = int.from_bytes(okm[:48], "big") % R
        salt = hashlib.sha256(salt).digest()
    return sk


def sk_to_pk(sk: int) -> bytes:
    """Compressed public key of secret ``sk`` (0 < sk < r)."""
    out = ctypes.create_string_buffer(PUB_KEY_SIZE)
    _lib().bls_sk_to_pk(sk.to_bytes(PRIV_KEY_SIZE, "big"), out)
    return out.raw


def sign(sk: int, msg: bytes) -> bytes:
    out = ctypes.create_string_buffer(SIGNATURE_LENGTH)
    _lib().bls_sign(sk.to_bytes(PRIV_KEY_SIZE, "big"), msg, len(msg), out)
    return out.raw


def aggregate_signatures(sigs, check: bool = True) -> bytes:
    """Fold compressed G2 signatures into one; ``check=False`` skips the
    per-input subgroup checks for signatures verified before."""
    sigs = [bytes(s) for s in sigs]
    if not sigs:
        raise ValueError("cannot aggregate an empty signature set")
    for s in sigs:
        if len(s) != SIGNATURE_LENGTH:
            raise ValueError(
                f"signature must be {SIGNATURE_LENGTH} bytes, got {len(s)}")
    out = ctypes.create_string_buffer(SIGNATURE_LENGTH)
    if _lib().bls_agg_sigs(b"".join(sigs), len(sigs), 1 if check else 0,
                           out) != 1:
        raise ValueError("aggregate input not a valid G2 signature")
    return out.raw


def pop_prove(priv: bytes) -> bytes:
    """Proof of possession of a raw 32-byte secret key: the public key's
    bytes signed under the POP_ suite."""
    priv = bytes(priv)
    if len(priv) != PRIV_KEY_SIZE:
        raise ValueError(f"privkey must be {PRIV_KEY_SIZE} bytes")
    out = ctypes.create_string_buffer(SIGNATURE_LENGTH)
    _lib().bls_pop_prove(priv, out)
    return out.raw


def pop_verify(pk: bytes, pop: bytes) -> bool:
    pk, pop = bytes(pk), bytes(pop)
    if len(pk) != PUB_KEY_SIZE or len(pop) != SIGNATURE_LENGTH:
        return False
    return _lib().bls_pop_verify(pk, pop) == 1


def pk_to_affine(pk: bytes) -> bytes:
    """Decompress and subgroup-check a public key into 96 bytes x||y
    (canonical big-endian); raises ValueError for an invalid key."""
    pk = bytes(pk)
    out = ctypes.create_string_buffer(96)
    if len(pk) != PUB_KEY_SIZE or _lib().bls_pk_to_affine(pk, out) != 1:
        raise ValueError("not a valid G1 pubkey")
    return out.raw


def aggregate_affine(pts) -> bytes:
    """Sum of affine G1 points (x||y each); raises ValueError on malformed
    input or an infinity sum."""
    pts = [bytes(p) for p in pts]
    if any(len(p) != 96 for p in pts):
        raise ValueError("affine G1 point must be 96 bytes (x||y)")
    out = ctypes.create_string_buffer(96)
    rc = _lib().bls_agg_affine(b"".join(pts), len(pts), out)
    if rc == 2:
        raise ValueError("aggregate is the point at infinity")
    if rc != 1:
        raise ValueError("affine input not on the G1 curve" if pts
                         else "cannot aggregate an empty point set")
    return out.raw


def negate_affine(xy: bytes) -> bytes:
    """-P for an affine point: y -> p - y."""
    xy = bytes(xy)
    if len(xy) != 96:
        raise ValueError("affine G1 point must be 96 bytes (x||y)")
    y = int.from_bytes(xy[48:], "big")
    return xy[:48] + ((P - y) % P).to_bytes(48, "big")


def verify_aggregate_affine(xy: bytes, msg: bytes, sig: bytes) -> bool:
    """Verify an aggregate signature against a summed affine public key:
    two pairings.  False, never an exception, on malformed input."""
    xy, sig = bytes(xy), bytes(sig)
    if len(xy) != 96 or len(sig) != SIGNATURE_LENGTH:
        return False
    return _lib().bls_verify_agg_affine(xy, msg, len(msg), sig) == 1


class Bls12381PubKey:
    SIZE = PUB_KEY_SIZE

    def __init__(self, raw: bytes):
        if len(raw) != PUB_KEY_SIZE:
            raise ValueError(f"bls12_381 pubkey must be {PUB_KEY_SIZE} "
                             f"bytes, got {len(raw)}")
        self._raw = bytes(raw)

    def bytes(self) -> bytes:
        return self._raw

    def type(self) -> str:
        return BLS12381_KEY_TYPE

    def address(self) -> bytes:
        return address_hash(self._raw)

    def verify_signature(self, msg: bytes, sig: bytes) -> bool:
        if len(sig) != SIGNATURE_LENGTH:
            return False
        return _lib().bls_verify(self._raw, msg, len(msg), bytes(sig)) == 1

    def __eq__(self, other):
        return isinstance(other, Bls12381PubKey) and self._raw == other._raw

    def __hash__(self):
        return hash((BLS12381_KEY_TYPE, self._raw))

    def __repr__(self):
        return f"PubKey{{bls12_381:{self._raw.hex()[:16]}…}}"


class Bls12381PrivKey:
    SIZE = PRIV_KEY_SIZE

    def __init__(self, raw: bytes):
        if len(raw) != PRIV_KEY_SIZE:
            raise ValueError(f"bls12_381 privkey must be {PRIV_KEY_SIZE} "
                             f"bytes, got {len(raw)}")
        self._raw = bytes(raw)

    @classmethod
    def from_secret(cls, secret: bytes) -> "Bls12381PrivKey":
        """Deterministic key from a short secret, padded to the 48 bytes
        of key material as in the JAX package (tests and fixtures)."""
        return cls(keygen(secret.ljust(48, b"\x9b")).to_bytes(
            PRIV_KEY_SIZE, "big"))

    def bytes(self) -> bytes:
        return self._raw

    def type(self) -> str:
        return BLS12381_KEY_TYPE

    def sign(self, msg: bytes) -> bytes:
        return sign(int.from_bytes(self._raw, "big"), msg)

    def pub_key(self) -> Bls12381PubKey:
        return Bls12381PubKey(sk_to_pk(int.from_bytes(self._raw, "big")))
