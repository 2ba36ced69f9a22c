"""secp256k1 ECDSA keys (reference: ``crypto/secp256k1/secp256k1.go``).

Counterpart of ``cometbft_tpu/crypto/secp256k1.py``, with its semantics:

- address = RIPEMD-160(SHA-256(33-byte compressed pubkey))
  (``secp256k1.go:147-166``), RIPEMD-160 from the port's own host
  library (``native.ripemd160``), since ``hashlib`` has it only where
  its OpenSSL build does;
- signature = 64-byte big-endian r || s over SHA-256(msg), S normalised
  to the low half on signing; verification rejects r or s outside
  [1, n) and high-S (malleable) signatures.

Every operation runs in ``csrc/host/secp256k1.cpp`` (``native.py``;
built with ``g++`` at first use, a failed build raises
``native.NativeBuildError``).  Verification on the host is not a
fallback: no TPU kernel of the JAX package computes secp256k1, and the
JAX package verifies these lanes on its host with the same C++
(``cometbft_tpu/crypto/batch.py:991-998``, over
``native/secp256k1.cpp:953``), so in a mixed-key batch the port's
``BatchVerifier`` sends the Ed25519 lanes to the device and these to
the host.  The signer is not constant-time: keys made here are for
tests, fixtures and in-process networks, not for a validator that signs
in production.
"""

from __future__ import annotations

import hashlib
import os

from .. import native as _native
from . import _secp256k1_py as _py

__all__ = ["SECP256K1_KEY_TYPE", "PUB_KEY_SIZE", "PRIV_KEY_SIZE",
           "SIG_SIZE", "Secp256k1PubKey", "Secp256k1PrivKey"]

SECP256K1_KEY_TYPE = "secp256k1"
PUB_KEY_SIZE = 33          # compressed
PRIV_KEY_SIZE = 32
SIG_SIZE = 64
_N = _py.N                 # the curve order (SEC2 v2)


class Secp256k1PubKey:
    SIZE = PUB_KEY_SIZE

    def __init__(self, raw: bytes):
        if len(raw) != self.SIZE:
            raise ValueError(f"secp256k1 pubkey must be {self.SIZE} bytes")
        self._raw = bytes(raw)
        _py.decompress(self._raw)    # a key off the curve is refused here

    def bytes(self) -> bytes:
        return self._raw

    def type(self) -> str:
        return SECP256K1_KEY_TYPE

    def address(self) -> bytes:
        """RIPEMD-160(SHA-256(pubkey)) (secp256k1.go:147-166)."""
        return _native.ripemd160(hashlib.sha256(self._raw).digest())

    def verify_signature(self, msg: bytes, sig: bytes) -> bool:
        return _native.secp256k1_verify(self._raw, msg, sig)

    def __eq__(self, other):
        return (isinstance(other, Secp256k1PubKey)
                and self._raw == other._raw)

    def __hash__(self):
        return hash((SECP256K1_KEY_TYPE, self._raw))

    def __repr__(self):
        return f"PubKey{{secp256k1:{self._raw.hex()[:16]}…}}"


class Secp256k1PrivKey:
    SIZE = PRIV_KEY_SIZE

    def __init__(self, raw: bytes):
        if len(raw) != self.SIZE:
            raise ValueError(f"secp256k1 privkey must be {self.SIZE} bytes")
        self._raw = bytes(raw)
        if not 1 <= int.from_bytes(self._raw, "big") < _N:
            raise ValueError("secp256k1 scalar out of range")
        self._pub: Secp256k1PubKey | None = None

    @classmethod
    def generate(cls) -> "Secp256k1PrivKey":
        while True:
            cand = os.urandom(32)
            if 1 <= int.from_bytes(cand, "big") < _N:
                return cls(cand)

    @classmethod
    def from_secret(cls, secret: bytes) -> "Secp256k1PrivKey":
        """One-way derivation like GenPrivKeySecp256k1 (secp256k1.go:95):
        SHA-256(secret) reduced into [1, n - 1]; the same secret gives
        the JAX package's key."""
        v = int.from_bytes(hashlib.sha256(secret).digest(), "big")
        return cls((v % (_N - 1) + 1).to_bytes(32, "big"))

    def bytes(self) -> bytes:
        return self._raw

    def type(self) -> str:
        return SECP256K1_KEY_TYPE

    def sign(self, msg: bytes) -> bytes:
        """RFC 6979 deterministic ECDSA over SHA-256(msg), low-S: a
        function of (key, msg) alone, the JAX package's bytes."""
        return _native.secp256k1_sign(self._raw, msg)

    def pub_key(self) -> Secp256k1PubKey:
        if self._pub is None:
            self._pub = Secp256k1PubKey(_native.secp256k1_pubkey(self._raw))
        return self._pub
