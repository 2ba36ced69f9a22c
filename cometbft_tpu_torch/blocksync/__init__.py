"""Blocksync (counterpart of ``cometbft_tpu/blocksync``): the block pool
and the windowed reactor that catches a lagging node up."""

from .pool import BlockPool
from .reactor import BATCH_WINDOW, BLOCKSYNC_CHANNEL, BlocksyncReactor

__all__ = ["BlockPool", "BlocksyncReactor", "BLOCKSYNC_CHANNEL",
           "BATCH_WINDOW"]
