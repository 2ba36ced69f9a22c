"""Storage layer (counterpart of ``cometbft_tpu/storage``): the key-value
interface and its in-memory backend, the block store and the state
store.  The append-only log backend comes with the storage slice of the
port."""

from .blockstore import BlockMeta, BlockStore
from .db import DataDirLock, KVStore, MemDB, height_key
from .statestore import State, StateStore, rollback_state

__all__ = ["KVStore", "MemDB", "DataDirLock", "height_key", "BlockStore",
           "BlockMeta", "State", "StateStore", "rollback_state"]
