"""Mempool (counterpart of ``cometbft_tpu/mempool``): the interface and
the disabled mempool.  The CList mempool and its reactor come with the
node slice of the port."""

from .mempool import Mempool, NopMempool, TxKey

__all__ = ["Mempool", "NopMempool", "TxKey"]
