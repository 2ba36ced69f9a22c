"""Storage layer (counterpart of ``cometbft_tpu/storage``): the key-value
interface and its in-memory backend.  The append-only log backend, the
block store and the state store come with later slices of the port."""

from .db import DataDirLock, KVStore, MemDB, height_key

__all__ = ["KVStore", "MemDB", "DataDirLock", "height_key"]
