"""Virtual-time event loop: the deterministic driver under the scenario
lab (counterpart of ``cometbft_tpu/sim/vtime.py``).

A :class:`VirtualTimeLoop` is a stock ``asyncio.SelectorEventLoop``
whose notion of time is a counter instead of the wall clock:

- ``loop.time()`` returns virtual seconds, so every ``asyncio.sleep``,
  ``wait_for``, ``call_later`` and ping/timeout in the whole node stack
  schedules against virtual time with no code changes;
- the selector's ``select(timeout)`` is wrapped: when the loop is
  quiescent (no ready callbacks, no pending I/O events) and the next
  action is a timer ``timeout`` seconds away, the wrapper jumps virtual
  time forward by exactly that amount and returns at once.

Determinism: the ready queue is FIFO and the timer heap breaks ties by
schedule sequence, so given deterministic inputs (seeded RNGs, the
in-memory transport, no real I/O) every callback runs in the same order
on every run, which is what makes the chaos ``signature()`` and the
verdict JSON replay-identical for a fixed seed.

Work on other threads freezes virtual time.  Its result arrives through
the self-pipe at an unpredictable real moment; if virtual time jumped
while a thread ran, timeouts would fire "during" the work.  While an
executor future is outstanding, or a device job awaited through
``crypto/batch.py:device_await`` (the device-owner thread's hop: the
scheduler's micro-batches, a handshake's challenge check) has not been
handed back, the wrapper waits in short real-time slices without
advancing virtual time.  A synchronous device call
(``crypto/batch.py:device_call``, every one-lane check of the lab's
nodes) blocks the loop's own thread, so no virtual time passes during
it whatever the device's speed.

A quiescent loop with nothing scheduled and no outside work pending is a
deadlock: after a bounded number of empty real-time waits the loop
raises :class:`VirtualTimeDeadlock`.
"""

from __future__ import annotations

import asyncio
import random

from ..crypto import batch as _batch
from ..libs import clock

__all__ = ["VirtualTimeLoop", "VirtualClock", "VirtualTimeDeadlock", "run",
           "VIRTUAL_EPOCH_NS"]

# bounded real-time wait while nothing is scheduled (outside work pending
# or a true deadlock): 50 ms * 600 = 30 s of real silence before we abort
_IDLE_SLICE_S = 0.05
_MAX_IDLE_ROUNDS = 600

# virtual wall-clock epoch: a fixed, recognizably fake date, so block
# timestamps (hence block hashes) are a pure function of the seed
VIRTUAL_EPOCH_NS = 1_800_000_000_000_000_000


class VirtualTimeDeadlock(RuntimeError):
    """The loop went quiescent with no timers scheduled and no outside
    work outstanding: every task waits on an event that cannot fire."""


class VirtualClock(clock.Clock):
    """The ``libs.clock`` implementation bound to a virtual loop."""

    def __init__(self, loop: "VirtualTimeLoop",
                 epoch_ns: int = VIRTUAL_EPOCH_NS):
        self._loop = loop
        self.epoch_ns = epoch_ns

    def monotonic(self) -> float:
        return self._loop.time()

    def walltime_ns(self) -> int:
        return self.epoch_ns + int(self._loop.time() * 1e9)


class VirtualTimeLoop(asyncio.SelectorEventLoop):
    def __init__(self):
        super().__init__()
        self._vt_now = 0.0
        self._vt_idle_rounds = 0
        self._vt_executor_pending = 0
        self._vt_wrap_selector()

    # --------------------------------------------------------------- time

    def time(self) -> float:
        return self._vt_now

    def advance(self, seconds: float) -> None:
        """Manual jump (tests); the selector wrapper is the normal
        driver."""
        self._vt_now += float(seconds)

    # ---------------------------------------------------------- scheduling

    def _vt_wrap_selector(self) -> None:
        real_select = self._selector.select

        def select(timeout=None):
            # read the outside work BEFORE polling: a device job counted
            # out has already written its wakeup to the self-pipe
            outside = self._vt_executor_pending + \
                _batch.device_jobs_in_flight()
            events = real_select(0)
            if events:
                self._vt_idle_rounds = 0
                return events
            if outside > 0:
                # another thread owns the next wakeup: wait for the
                # self-pipe in real time, virtual time frozen
                self._vt_idle_rounds = 0
                return real_select(_IDLE_SLICE_S)
            if timeout is None:
                # nothing ready, nothing scheduled, no outside work: only
                # an unmanaged thread could wake us.  A few bounded
                # real-time slices, then it is a deadlock.
                self._vt_idle_rounds += 1
                if self._vt_idle_rounds > _MAX_IDLE_ROUNDS:
                    raise VirtualTimeDeadlock(
                        "virtual-time loop is quiescent with no timers "
                        f"scheduled; {len(asyncio.all_tasks(self))} tasks "
                        "are waiting on events that can never fire")
                return real_select(_IDLE_SLICE_S)
            self._vt_idle_rounds = 0
            if timeout > 0:
                # quiescent: the next timer is `timeout` virtual seconds
                # out; jump straight to it
                self._vt_now += timeout
            return []

        self._selector.select = select

    def run_in_executor(self, executor, func, *args):
        fut = super().run_in_executor(executor, func, *args)
        self._vt_executor_pending += 1

        def _done(_f):
            self._vt_executor_pending -= 1

        fut.add_done_callback(_done)
        return fut


def run(main, *, seed: int = 0, epoch_ns: int = VIRTUAL_EPOCH_NS):
    """Run ``main`` (a coroutine or a no-arg callable returning one) to
    completion on a fresh virtual-time loop with the virtual clock
    installed and the global ``random`` module seeded: the one entry
    point every scenario and test goes through.

    The clock is installed before the coroutine is created, so reads at
    construction (``ConsensusState``'s step stamp, MConnection liveness
    stamps) land on virtual time, and uninstalled afterwards."""
    loop = VirtualTimeLoop()
    vclock = VirtualClock(loop, epoch_ns=epoch_ns)
    prev_clock = clock.installed()
    clock.install(vclock)
    random.seed(seed)
    asyncio.set_event_loop(loop)
    try:
        coro = main() if callable(main) else main
        return loop.run_until_complete(coro)
    finally:
        try:
            # drain stragglers so their destructors don't fire against a
            # closed loop (reactor gossip tasks, reconnect loops)
            pending = [t for t in asyncio.all_tasks(loop) if not t.done()]
            for t in pending:
                t.cancel()
            if pending:
                loop.run_until_complete(
                    asyncio.gather(*pending, return_exceptions=True))
        except Exception:
            pass
        if prev_clock is None:
            clock.uninstall()
        else:
            clock.install(prev_clock)
        asyncio.set_event_loop(None)
        try:
            loop.close()
        except Exception:
            pass
