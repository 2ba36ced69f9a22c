"""Mempool (counterpart of ``cometbft_tpu/mempool``): the interface, the
CList FIFO implementation and the disabled mempool.  The gossip reactor
comes with the networked node."""

from .clist_mempool import CListMempool
from .mempool import Mempool, NopMempool, TxKey

__all__ = ["Mempool", "NopMempool", "CListMempool", "TxKey"]
