"""Storage layer (counterpart of ``cometbft_tpu/storage``): the key-value
interface with its in-memory, append-only log and native backends, the block
store and the state store."""

from .blockstore import BlockMeta, BlockStore
from .db import DataDirLock, KVStore, LogDB, MemDB, height_key, open_db
from .statestore import State, StateStore, rollback_state

__all__ = ["KVStore", "MemDB", "LogDB", "open_db", "DataDirLock",
           "height_key", "BlockStore", "BlockMeta", "State", "StateStore",
           "rollback_state"]
