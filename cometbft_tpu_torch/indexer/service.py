"""IndexerService: pumps the event bus's Tx and block events into the
indexers (counterpart of ``cometbft_tpu/indexer/service.py``; reference:
``state/txindex/indexer_service.go``)."""

from __future__ import annotations

import asyncio

from ..libs import log as tmlog
from ..libs.service import BaseService
from ..types import events as ev
from .block import BlockIndexer
from .tx import TxIndexer


class IndexerService(BaseService):
    def __init__(self, event_bus, tx_indexer: TxIndexer,
                 block_indexer: BlockIndexer, name: str = "indexer"):
        super().__init__(name=name)
        self.event_bus = event_bus
        self.tx_indexer = tx_indexer
        self.block_indexer = block_indexer
        self._tasks: list[asyncio.Task] = []

    async def on_start(self) -> None:
        # unbuffered: the indexer must see EVERY event — the default
        # drop-oldest subscription would lose txs of large blocks
        tx_sub = self.event_bus.subscribe(
            f"{self.name}:tx", {"tm.event": ev.EVENT_TX}, unbuffered=True)
        blk_sub = self.event_bus.subscribe(
            f"{self.name}:blk", {"tm.event": ev.EVENT_NEW_BLOCK_EVENTS},
            unbuffered=True)
        self._tasks = [
            asyncio.create_task(self._pump_tx(tx_sub)),
            asyncio.create_task(self._pump_blocks(blk_sub)),
        ]

    async def on_stop(self) -> None:
        for t in self._tasks:
            t.cancel()
        self._tasks = []
        self.event_bus.unsubscribe(f"{self.name}:tx")
        self.event_bus.unsubscribe(f"{self.name}:blk")

    async def _pump_tx(self, sub) -> None:
        lg = tmlog.logger("indexer", name=self.name)
        while True:
            msg = await sub.queue.get()
            try:
                d = msg.data
                self.tx_indexer.index(d["height"], d["index"],
                                      bytes(d["tx"]), d["result"],
                                      dict(msg.attrs))
            except Exception as e:    # one bad event must not stop indexing
                lg.error("tx index failed", err=repr(e))

    async def _pump_blocks(self, sub) -> None:
        lg = tmlog.logger("indexer", name=self.name)
        while True:
            msg = await sub.queue.get()
            try:
                self.block_indexer.index(int(msg.data["height"]),
                                         list(msg.data["events"]))
            except Exception as e:
                lg.error("block index failed", err=repr(e))
