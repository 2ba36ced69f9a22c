"""Timeout ticker (counterpart of ``cometbft_tpu/consensus/ticker.py``;
reference: ``internal/consensus/ticker.go``): one pending timeout at a
time; scheduling overrides the previous.

A ``loop.call_later`` handle, not a task: consensus reschedules on every
step transition.  ``call_later`` rides ``loop.time()``, the clock that
``libs/clock.py``'s async functions schedule on as well."""

from __future__ import annotations

import asyncio
from dataclasses import dataclass


@dataclass(frozen=True)
class TimeoutInfo:
    duration_ns: int
    height: int
    round: int
    step: int


class TimeoutTicker:
    def __init__(self, deliver):
        """``deliver(TimeoutInfo)`` is called on the event loop when a
        timeout fires (posts into the consensus queue)."""
        self._deliver = deliver
        self._handle: asyncio.TimerHandle | None = None

    def schedule(self, ti: TimeoutInfo) -> None:
        if self._handle is not None:
            self._handle.cancel()
        self._handle = asyncio.get_running_loop().call_later(
            ti.duration_ns / 1e9, self._fire, ti)

    def _fire(self, ti: TimeoutInfo) -> None:
        self._handle = None
        self._deliver(ti)

    def stop(self) -> None:
        if self._handle is not None:
            self._handle.cancel()
            self._handle = None
