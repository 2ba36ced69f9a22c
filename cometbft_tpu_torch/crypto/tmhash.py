"""SHA-256 hash helpers (reference: ``crypto/tmhash/hash.go``).

The port's own copy of ``cometbft_tpu/crypto/tmhash.py``."""

from __future__ import annotations

import hashlib

__all__ = ["SIZE", "TRUNCATED_SIZE", "sum_sha256", "sum_truncated"]

SIZE = 32
TRUNCATED_SIZE = 20


def sum_sha256(b: bytes) -> bytes:
    return hashlib.sha256(b).digest()


def sum_truncated(b: bytes) -> bytes:
    return hashlib.sha256(b).digest()[:TRUNCATED_SIZE]
