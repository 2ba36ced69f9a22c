"""Ed25519 keys, key type names and addresses for the port.

Counterpart of ``cometbft_tpu/crypto/keys.py`` for the two key types the
port carries: ``ed25519`` here and ``bls12_381`` in
``crypto/bls12381.py``.  Ed25519: 32-byte public keys, 64-byte private
keys (seed || pubkey), addresses = first 20 bytes of SHA-256 of the
pubkey.  Key derivation and signing go through the native signer
(``native.ed25519_pubkey``/``ed25519_sign``, ``csrc/host/
ed25519_sign.cpp``, built with ``g++`` at first use; a failed build
raises ``native.NativeBuildError``), which is not constant-time: keys
made here are for tests, fixtures and in-process networks, not for a
validator that signs in production.  ``verify_signature`` is the
pure-Python ZIP-215 oracle (``crypto/_ed25519_py.py``): a test surface
only, since every verification on the port's paths runs on the device
(``crypto/batch.py``, ``crypto/scheduler.py``).
"""

from __future__ import annotations

import hashlib
import os

from .. import native as _native
from . import _ed25519_py as _ref

__all__ = ["ED25519_KEY_TYPE", "BLS12381_KEY_TYPE", "ADDRESS_SIZE",
           "address_hash", "Ed25519PubKey", "Ed25519PrivKey",
           "pub_key_from_type_bytes"]

ED25519_KEY_TYPE = "ed25519"
BLS12381_KEY_TYPE = "bls12_381"
ADDRESS_SIZE = 20


def address_hash(b: bytes) -> bytes:
    """Address = first 20 bytes of SHA-256 (crypto/crypto.go:18)."""
    return hashlib.sha256(b).digest()[:ADDRESS_SIZE]


class Ed25519PubKey:
    SIZE = 32

    def __init__(self, raw: bytes):
        if len(raw) != self.SIZE:
            raise ValueError(f"ed25519 pubkey must be {self.SIZE} bytes")
        self._raw = bytes(raw)

    def bytes(self) -> bytes:
        return self._raw

    def type(self) -> str:
        return ED25519_KEY_TYPE

    def address(self) -> bytes:
        return address_hash(self._raw)

    def verify_signature(self, msg: bytes, sig: bytes) -> bool:
        return _ref.verify_zip215(self._raw, msg, sig)

    def __eq__(self, other):
        return isinstance(other, Ed25519PubKey) and self._raw == other._raw

    def __hash__(self):
        return hash((ED25519_KEY_TYPE, self._raw))

    def __repr__(self):
        return f"PubKey{{ed25519:{self._raw.hex()[:16]}…}}"


class Ed25519PrivKey:
    """64-byte private key: seed || pubkey (the reference layout)."""

    SIZE = 64

    def __init__(self, raw: bytes):
        if len(raw) == 32:           # a bare seed
            raw = raw + _native.ed25519_pubkey(raw)
        if len(raw) != self.SIZE:
            raise ValueError(f"ed25519 privkey must be {self.SIZE} bytes")
        self._raw = bytes(raw)

    @classmethod
    def generate(cls) -> "Ed25519PrivKey":
        return cls(os.urandom(32))

    @classmethod
    def from_secret(cls, secret: bytes) -> "Ed25519PrivKey":
        """Deterministic key from a secret (GenPrivKeyFromSecret); the same
        secret gives the same key as ``cometbft_tpu``'s."""
        return cls(hashlib.sha256(secret).digest())

    def bytes(self) -> bytes:
        return self._raw

    def type(self) -> str:
        return ED25519_KEY_TYPE

    def sign(self, msg: bytes) -> bytes:
        return _native.ed25519_sign(self._raw[:32], msg)

    def pub_key(self) -> Ed25519PubKey:
        return Ed25519PubKey(self._raw[32:])


def pub_key_from_type_bytes(key_type: str, raw: bytes):
    """A public key from its type name and bytes (the JAX package's
    ``crypto/keys.py:63``) for the port's two key types; any other type,
    secp256k1 included, raises ValueError."""
    if key_type == ED25519_KEY_TYPE:
        return Ed25519PubKey(raw)
    if key_type == BLS12381_KEY_TYPE:
        from .bls12381 import Bls12381PubKey

        return Bls12381PubKey(raw)
    raise ValueError(f"unsupported pubkey type {key_type!r}")
