"""Mempool (counterpart of ``cometbft_tpu/mempool``): the interface, the
CList FIFO implementation, the disabled mempool and the gossip reactor
(``mempool/reactor.py``)."""

from .clist_mempool import CListMempool
from .mempool import Mempool, NopMempool, TxKey

__all__ = ["Mempool", "NopMempool", "CListMempool", "TxKey"]
