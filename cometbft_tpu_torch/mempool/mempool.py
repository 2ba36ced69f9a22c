"""The Mempool interface and the disabled mempool (reference:
``mempool/mempool.go:26-100``, ``mempool/nop_mempool.go``; counterpart
of ``cometbft_tpu/mempool/mempool.py``)."""

from __future__ import annotations

import contextlib
from abc import ABC, abstractmethod

from ..crypto.tmhash import sum_sha256

__all__ = ["TxKey", "Mempool", "NopMempool"]


def TxKey(tx: bytes) -> bytes:
    """A transaction's mempool identity: the SHA-256 the tx merkle tree
    hashes."""
    return sum_sha256(tx)


class Mempool(ABC):
    @abstractmethod
    async def check_tx(self, tx: bytes): ...

    @abstractmethod
    def reap_max_bytes_max_gas(self, max_bytes: int,
                               max_gas: int) -> list[bytes]: ...

    @abstractmethod
    async def update(self, height: int, txs: list[bytes],
                     tx_results: list) -> None: ...

    @abstractmethod
    def lock(self): ...

    @abstractmethod
    def size(self) -> int: ...

    @abstractmethod
    async def flush(self) -> None: ...

    def size_bytes(self) -> int:
        """Total bytes of pooled transactions (0 when unsupported)."""
        return 0

    def is_full(self, incoming_bytes: int = 0) -> bool:
        return False

    def get_tx(self, key: bytes):
        """A transaction by key, or None."""
        return None

    def txs_available(self):
        """An event set when transactions arrive (None: unsupported)."""
        return None


class NopMempool(Mempool):
    """The disabled mempool of applications that keep their own."""

    async def check_tx(self, tx):
        raise RuntimeError("mempool is disabled")

    def reap_max_bytes_max_gas(self, max_bytes, max_gas):
        return []

    async def update(self, height, txs, tx_results):
        pass

    def lock(self):
        return contextlib.nullcontext()

    def size(self):
        return 0

    async def flush(self):
        pass
