"""Key-value store abstraction (reference: the cometbft-db interface:
Get/Set/Delete/Iterator/Batch over pluggable backends).

Counterpart of ``cometbft_tpu/storage/db.py:40-130``: the ``KVStore``
interface, ``DataDirLock``, the height-ordered key layout and the
in-memory ``MemDB`` that the light client's trusted store uses.  The
crash-safe append-only ``LogDB`` and ``open_db`` come with the storage
slice of the port.
"""

from __future__ import annotations

import fcntl
import os
from abc import ABC, abstractmethod

__all__ = ["KVStore", "DataDirLock", "height_key", "MemDB"]


class KVStore(ABC):
    @abstractmethod
    def get(self, key: bytes) -> bytes | None: ...

    @abstractmethod
    def set(self, key: bytes, value: bytes) -> None: ...

    @abstractmethod
    def delete(self, key: bytes) -> None: ...

    @abstractmethod
    def iterate(self, start: bytes = b"", end: bytes | None = None):
        """Yield (key, value) sorted ascending, key in [start, end)."""

    @abstractmethod
    def close(self) -> None: ...

    def set_batch(self, items: dict[bytes, bytes | None]) -> None:
        """Grouped write: a None value deletes.  Backends may override it
        to make the batch one durable append."""
        for k, v in items.items():
            if v is None:
                self.delete(k)
            else:
                self.set(k, v)

    def has(self, key: bytes) -> bool:
        return self.get(key) is not None


class DataDirLock:
    """Exclusive advisory lock on a node home's data dir, held for the
    life of the process, so offline tooling refuses to touch a live
    node's stores.  flock is released when the process dies, so a
    crashed node never wedges its home."""

    def __init__(self, data_dir: str):
        os.makedirs(data_dir, exist_ok=True)
        self.path = os.path.join(data_dir, "LOCK")
        self._fd = os.open(self.path, os.O_CREAT | os.O_RDWR, 0o644)
        try:
            fcntl.flock(self._fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError:
            os.close(self._fd)
            raise RuntimeError(
                f"data dir {data_dir} is locked by a running node — "
                "stop it before running offline tooling") from None
        os.write(self._fd, str(os.getpid()).encode())

    def release(self) -> None:
        if self._fd is not None:
            fcntl.flock(self._fd, fcntl.LOCK_UN)
            os.close(self._fd)
            self._fd = None


def height_key(prefix: bytes, height: int) -> bytes:
    """Height-ordered key: ``prefix`` then the height as 8 big-endian
    bytes, so keys sort by height."""
    return prefix + height.to_bytes(8, "big")


class MemDB(KVStore):
    def __init__(self):
        self._data: dict[bytes, bytes] = {}

    def get(self, key):
        return self._data.get(key)

    def set(self, key, value):
        self._data[bytes(key)] = bytes(value)

    def delete(self, key):
        self._data.pop(key, None)

    def iterate(self, start=b"", end=None):
        for k in sorted(self._data):
            if k < start:
                continue
            if end is not None and k >= end:
                break
            yield k, self._data[k]

    def close(self):
        pass
