"""Event indexers (counterpart of ``cometbft_tpu/indexer``; reference:
``state/txindex/kv`` and ``state/indexer/block/kv``): the kv tx and
block indexers and the service that pumps the event bus into them.  The
SQL event sink is ``indexer/psql.py``."""

from .block import BlockIndexer
from .service import IndexerService
from .tx import TxIndexer

__all__ = ["TxIndexer", "BlockIndexer", "IndexerService"]
