"""Statesync (counterpart of ``cometbft_tpu/statesync``): snapshot
discovery, light-verified restore and the content-addressed chunk
fabric."""

from .cache import AdmissionGate, ChunkLRU
from .manifest import ChunkManifest, hash_chunk, manifest_root
from .reactor import CHUNK_CHANNEL, SNAPSHOT_CHANNEL, StatesyncReactor
from .stateprovider import StateProvider
from .syncer import StatesyncError, StatesyncFatalError, Syncer

__all__ = ["StatesyncReactor", "StateProvider", "Syncer", "StatesyncError",
           "StatesyncFatalError", "ChunkManifest", "ChunkLRU",
           "AdmissionGate", "hash_chunk", "manifest_root",
           "SNAPSHOT_CHANNEL", "CHUNK_CHANNEL"]
