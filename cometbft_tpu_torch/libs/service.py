"""Service lifecycle base (counterpart of
``cometbft_tpu/libs/service.py``; reference:
``libs/service/service.go:99,132`` ``BaseService``): idempotent
start/stop, an ``is_running`` flag, a ``wait()`` for termination, and
overridable on_start/on_stop hooks.  The port's verification scheduler
(``crypto/scheduler.py``) runs on it."""

from __future__ import annotations

import asyncio

from . import log as tmlog


class ServiceError(Exception):
    pass


class BaseService:
    def __init__(self, name: str | None = None):
        self.name = name or type(self).__name__
        self.log = tmlog.logger("service", name=self.name)
        self._running = False
        self._stopped_ev = asyncio.Event()

    # --------------------------------------------------------------- hooks

    async def on_start(self) -> None:
        """Subclass hook; spawn tasks here."""

    async def on_stop(self) -> None:
        """Subclass hook; cancel tasks here."""

    # ----------------------------------------------------------- lifecycle

    @property
    def is_running(self) -> bool:
        return self._running

    async def start(self) -> None:
        """service.go Start: error on double start.  The running flag
        flips BEFORE awaiting on_start (the reference's atomic CAS), so a
        concurrent second start() gets ServiceError instead of running
        on_start twice; a failed on_start resets and releases waiters."""
        if self._running:
            raise ServiceError(f"service {self.name} already running")
        self._running = True
        self._stopped_ev.clear()
        try:
            await self.on_start()
        except BaseException:
            self._running = False
            self._stopped_ev.set()
            raise
        self.log.debug("service started")

    async def stop(self) -> None:
        """service.go Stop: idempotent."""
        if not self._running:
            return
        self._running = False
        await self.on_stop()
        self._stopped_ev.set()
        self.log.debug("service stopped")

    async def wait(self) -> None:
        """Block until the service stops — or until a start attempt fails
        (service.go Wait)."""
        await self._stopped_ev.wait()
