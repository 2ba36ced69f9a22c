"""Flow-rate metering and limiting (counterpart of
``cometbft_tpu/libs/flowrate.py``; reference: ``internal/flowrate``, the
send and receive metering of MConnection).

A Monitor tracks an exponentially-weighted transfer rate; ``limit`` returns
how many bytes may be sent now to stay under a target rate (the caller
sleeps when it gets 0).  ``rate`` decays while the stream is idle, so the
p2p telemetry a silent peer exports converges to zero instead of freezing
at its last burst.
"""

from __future__ import annotations

import time


class Monitor:
    def __init__(self, sample_period: float = 0.1, ema_alpha: float = 0.25,
                 now=time.monotonic):
        self._now = now
        self._period = sample_period
        self._alpha = ema_alpha
        self._start = now()
        self._sample_start = self._start
        self._sample_bytes = 0
        self._rate = 0.0            # bytes/sec EMA
        self.total = 0

    def update(self, n: int) -> None:
        t = self._now()
        self.total += n
        self._sample_bytes += n
        elapsed = t - self._sample_start
        if elapsed >= self._period:
            inst = self._sample_bytes / elapsed
            self._rate = (self._alpha * inst
                          + (1 - self._alpha) * self._rate)
            self._sample_start = t
            self._sample_bytes = 0

    @property
    def rate(self) -> float:
        """Bytes/sec EMA, read-only and idle-decaying: the pending
        partial window folds in as one sample, and every further full
        period without an ``update`` decays the estimate by
        ``(1 - alpha)`` — a connection that stops transferring reads as
        approaching zero, not as its last burst forever.  Internal EMA
        state is untouched (``update`` remains the only writer)."""
        t = self._now()
        elapsed = t - self._sample_start
        if elapsed < self._period:
            return self._rate
        inst = self._sample_bytes / elapsed
        r = self._alpha * inst + (1 - self._alpha) * self._rate
        extra = int(elapsed / self._period) - 1
        if extra > 0:
            r *= (1 - self._alpha) ** extra
        return r

    def status(self) -> dict:
        t = self._now()
        dur = max(t - self._start, 1e-9)
        return {"bytes": self.total, "duration_s": dur,
                "avg_rate": self.total / dur, "inst_rate": self.rate}

    def limit(self, want: int, max_rate: float | None) -> int:
        """How many of ``want`` bytes may transfer now under ``max_rate``
        (None = unlimited).  0 means back off.  The elapsed window is
        floored at one sample period: at ``t == start`` (a connection's
        very first write, the monotonic-clock startup edge) the budget is
        one period's allowance instead of a guaranteed-0 that would
        stall every fresh connection's first packet."""
        if not max_rate:
            return want
        t = self._now()
        allowed = max_rate * max(t - self._start, self._period) - self.total
        return max(0, min(want, int(allowed)))
