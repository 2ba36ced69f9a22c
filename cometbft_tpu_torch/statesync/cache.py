"""Serving-side protection for the snapshot fabric: a byte-budgeted
chunk LRU and an admission gate (counterpart of
``cometbft_tpu/statesync/cache.py``).

Forty concurrent bootstrappers all fetch the SAME snapshot — the newest
one every serving peer offers — so chunk loads are massively shared.
Without a cache each ``creq`` costs an ABCI ``load_snapshot_chunk``
round trip (for real apps: a disk read + serialization), multiplied by
every fetcher; with the LRU the fleet hits RAM.  The admission gate
bounds how many loads run concurrently and how many may queue — beyond
that the request is SHED (dropped; the fetcher's timeout/rotation
machinery re-requests elsewhere), because a slow answer to everyone is
strictly worse than a fast answer to most (the RPC gate's discipline)."""

from __future__ import annotations

import asyncio
import functools
from collections import OrderedDict


@functools.cache
def _serve_metrics():
    from types import SimpleNamespace

    from ..libs import metrics as m

    return SimpleNamespace(
        chunks_served=m.counter(
            "statesync_chunks_served_total",
            "snapshot chunks served to fetching peers"),
        manifests_served=m.counter(
            "statesync_manifests_served_total",
            "chunk manifests served to fetching peers"),
        cache_hits=m.counter(
            "statesync_chunk_cache_hits_total",
            "chunk requests answered from the serving LRU (no app "
            "round trip)"),
        cache_misses=m.counter(
            "statesync_chunk_cache_misses_total",
            "chunk requests that had to load from the app — a high "
            "miss ratio under concurrent bootstrap means the cache "
            "byte budget is too small for the snapshot"),
        shed=m.counter(
            "statesync_serve_shed_total",
            "serving requests shed by the admission gate (concurrency "
            "+ queue budget exhausted) — fetchers retry other peers, "
            "the local node keeps its event loop"))


class ChunkLRU:
    """Byte-budgeted LRU for served snapshot chunks, keyed by
    ``(height, format, index)`` (same shape as ``light/serve.py``'s
    header cache: count cap + byte cap, never evicts below one entry)."""

    __slots__ = ("max_size", "max_bytes", "d", "sizes", "bytes")

    def __init__(self, max_size: int = 1024, max_bytes: int = 0):
        self.max_size = max_size
        self.max_bytes = max_bytes          # 0 = no byte budget
        self.d: OrderedDict = OrderedDict()
        self.sizes: dict = {}
        self.bytes = 0

    def get(self, key):
        if key not in self.d:
            return None
        self.d.move_to_end(key)
        return self.d[key]

    def put(self, key, value: bytes) -> int:
        """Insert and evict down to budget; returns evictions."""
        nbytes = len(value)
        if key in self.d:
            self.bytes -= self.sizes.get(key, 0)
            del self.d[key]
        self.d[key] = value
        self.sizes[key] = nbytes
        self.bytes += nbytes
        evicted = 0
        while len(self.d) > self.max_size or \
                (self.max_bytes and self.bytes > self.max_bytes
                 and len(self.d) > 1):
            old, _ = self.d.popitem(last=False)
            self.bytes -= self.sizes.pop(old, 0)
            evicted += 1
        return evicted

    def __len__(self) -> int:
        return len(self.d)


class AdmissionGate:
    """Concurrency + queue-depth budget for serving work.

    ``try_queue()`` answers synchronously whether a new request may even
    WAIT: once ``max_queued`` requests are already parked behind a fully
    busy gate, further arrivals are shed at the door — queueing them
    would only grow latency for everyone (the fetcher side re-requests
    from another peer far sooner than a deep queue would drain)."""

    def __init__(self, concurrency: int = 8, max_queued: int = 64):
        self.concurrency = max(1, int(concurrency))
        self.max_queued = max(0, int(max_queued))
        self._sem = asyncio.Semaphore(self.concurrency)
        self.waiting = 0
        self.shed = 0

    def try_queue(self) -> bool:
        """Admit (True) or shed (False) a new serving request."""
        if self._sem.locked() and self.waiting >= self.max_queued:
            self.shed += 1
            return False
        return True

    async def __aenter__(self):
        self.waiting += 1
        try:
            await self._sem.acquire()
        finally:
            self.waiting -= 1
        return self

    async def __aexit__(self, *exc):
        self._sem.release()
        return False
