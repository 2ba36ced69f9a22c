"""Event-loop responsiveness watchdog (counterpart of ``cometbft_tpu/libs/
loopwatch.py``; the asyncio analogue of the reference's deadlock-detecting
mutexes, ``libs/sync/deadlock.go``).

One synchronous call on the loop's thread (a device check of the plain
versions, blocking IO) freezes every subsystem at once.  The watchdog
measures the loop's scheduling lag from a monitor thread and turns
stalls into log lines and metrics; the RPC's overload shedding
(``rpc/core.py:_check_overload``) reads the last lag.
"""

from __future__ import annotations

import asyncio
import threading
import time

from . import metrics as _metrics
from .log import logger

_LOG = logger("loopwatch")


class LoopWatchdog:
    """Heartbeats the loop via ``call_soon_threadsafe``; if a beat takes
    more than ``stall_threshold_s`` to run, the loop was blocked that
    long by synchronous work."""

    def __init__(self, loop: asyncio.AbstractEventLoop | None = None,
                 interval_s: float = 0.5,
                 stall_threshold_s: float = 1.0,
                 name: str = "node"):
        self._loop = loop or asyncio.get_event_loop()
        self.interval_s = interval_s
        self.stall_threshold_s = stall_threshold_s
        self.name = name
        self.stalls = 0
        self.worst_stall_s = 0.0
        # the MOST RECENT beat's scheduling lag: call_soon_threadsafe
        # lands behind everything already queued, so this doubles as a
        # backlog signal — RPC admission control sheds broadcast load
        # when it climbs (the flood that starves consensus into round
        # churn announces itself here first)
        self.last_lag_s = 0.0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._gauge = _metrics.gauge(
            "loop_worst_stall_seconds",
            "longest observed event-loop stall")
        self._counter = _metrics.counter(
            "loop_stalls_total",
            "event-loop stalls above threshold")

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"loopwatch-{self.name}")
        self._thread.start()

    def stop(self) -> None:
        """Signal-only shutdown: stop() is typically called FROM the
        watched loop, and joining would block the very thread an
        in-flight heartbeat needs to land on (the daemon thread exits on
        its own after the wait)."""
        self._stop.set()
        self._thread = None

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            beat = threading.Event()
            sent = time.monotonic()
            try:
                self._loop.call_soon_threadsafe(beat.set)
            except RuntimeError:
                return                       # loop closed
            # wait generously; a stall longer than 60 s is still reported
            beat.wait(60.0)
            lag = time.monotonic() - sent
            if self._stop.is_set():
                return              # shutdown lag is not a loop stall
            self.last_lag_s = lag
            if lag >= self.stall_threshold_s:
                self.stalls += 1
                self.worst_stall_s = max(self.worst_stall_s, lag)
                self._counter.inc(node=self.name)
                self._gauge.set(self.worst_stall_s, node=self.name)
                _LOG.error("event loop stalled",
                           node=self.name, stall_s=round(lag, 3),
                           hint="synchronous work on the loop thread "
                                "(a synchronous device check? blocking IO?)")
