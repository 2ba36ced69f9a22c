"""The node-wide clock seam (counterpart of ``cometbft_tpu/libs/clock.py``):
every sleep, timeout and monotonic read of the clock-managed packages
(blocksync here) goes through this module.

With no clock installed (every real node) each function is a branch on a
module global followed by the ``time`` or ``asyncio`` call it stands
for.  :func:`install` puts in a process-wide clock whose
:meth:`Clock.monotonic` and :meth:`Clock.walltime_ns` replace the direct
time reads; the async functions stay thin delegates, since they schedule
on ``loop.time()``.  The simulator's virtual loop, which installs one,
comes with a later slice of the port."""

from __future__ import annotations

import asyncio
import time as _time

__all__ = ["Clock", "install", "uninstall", "installed", "monotonic",
           "walltime_ns", "monotonic_ns", "walltime", "sleep", "wait_for"]

_CLOCK = None      # None: real time; else the installed clock


class Clock:
    """The interface an installable clock implements."""

    def monotonic(self) -> float:
        raise NotImplementedError

    def walltime_ns(self) -> int:
        raise NotImplementedError


def install(clk: Clock) -> None:
    """Install the process-wide clock (before any node is built, so that
    reads at construction land on it too)."""
    global _CLOCK
    _CLOCK = clk


def uninstall() -> None:
    global _CLOCK
    _CLOCK = None


def installed() -> Clock | None:
    return _CLOCK


def monotonic() -> float:
    if _CLOCK is None:
        return _time.monotonic()
    return _CLOCK.monotonic()


def walltime_ns() -> int:
    if _CLOCK is None:
        return _time.time_ns()
    return _CLOCK.walltime_ns()


def monotonic_ns() -> int:
    if _CLOCK is None:
        return _time.monotonic_ns()
    return int(_CLOCK.monotonic() * 1e9)


def walltime() -> float:
    if _CLOCK is None:
        return _time.time()
    return _CLOCK.walltime_ns() / 1e9


async def sleep(delay: float, result=None):
    return await asyncio.sleep(delay, result)


async def wait_for(awaitable, timeout: float | None):
    return await asyncio.wait_for(awaitable, timeout)
