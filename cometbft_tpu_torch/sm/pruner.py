"""Background pruner honoring app + data-companion retain heights
(counterpart of ``cometbft_tpu/sm/pruner.py``; reference:
``state/pruner.go``; the companion height is ADR-101's data-companion
pull API, which the JAX package serves over RPC).

Blocks and state below min(app_retain, companion_retain) are eligible;
either height being unset (0) blocks pruning on that axis only if the
companion feature is in use — an unset companion means "no companion,
app decides" like the reference default."""

from __future__ import annotations

import asyncio

from ..libs import log as tmlog
from ..libs import metrics
from ..libs.service import BaseService
from ..storage.statestore import K_RETAIN
from ..types import _msgpack


class Pruner(BaseService):
    def __init__(self, state_store, block_store, interval: float = 10.0,
                 name: str = "pruner"):
        super().__init__(name=f"pruner:{name}")
        self.state_store = state_store
        self.block_store = block_store
        self.interval = interval
        self.log = tmlog.logger("pruner", node=name)
        self.m_pruned = metrics.counter("pruner_blocks_pruned_total",
                                        "blocks removed by the pruner")
        self._task: asyncio.Task | None = None
        self._wake = asyncio.Event()

    # ------------------------------------------------------ retain heights
    # persisted through the StateStore's retain-height record
    # (state/store.go:112-152) — one source of truth

    def set_app_retain_height(self, height: int) -> None:
        _, dc = self.retain_heights()
        self.state_store.set_retain_heights(height, dc)
        self._wake.set()

    def set_companion_retain_height(self, height: int) -> None:
        app, _ = self.retain_heights()
        self.state_store.set_retain_heights(app, height)
        self._wake.set()

    def retain_heights(self) -> tuple[int, int]:
        raw = self.state_store.db.get(K_RETAIN)
        if not raw:
            return 0, 0
        d = _msgpack.unpackb(raw)
        return d["app"], d["dc"]

    def effective_retain_height(self) -> int:
        return self.state_store.get_retain_height()

    # ------------------------------------------- lifecycle (BaseService)

    async def on_start(self) -> None:
        self._task = asyncio.create_task(self._routine())

    async def on_stop(self) -> None:
        task, self._task = self._task, None
        if task is not None:
            task.cancel()
            try:
                await task
            except asyncio.CancelledError:
                pass

    async def _routine(self) -> None:
        while True:
            self._wake.clear()
            try:
                await asyncio.wait_for(self._wake.wait(), self.interval)
            except asyncio.TimeoutError:
                pass
            try:
                self.prune_once()
            except Exception as e:
                self.log.warn("prune failed", err=repr(e))

    def prune_once(self) -> int:
        target = self.effective_retain_height()
        if target <= self.block_store.base():
            return 0
        target = min(target, self.block_store.height())
        pruned = self.block_store.prune_blocks(target)
        self.state_store.prune_states(target)
        if pruned:
            self.m_pruned.inc(pruned)
            self.log.debug("pruned", blocks=pruned, new_base=target)
        return pruned
