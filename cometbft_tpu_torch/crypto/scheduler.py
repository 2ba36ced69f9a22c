"""The verification scheduler and the verified-signature cache, on the
device.

Counterpart of ``cometbft_tpu/crypto/scheduler.py``.  Live consensus
gossip arrives as single votes; this module batches them:

- ``verify()`` (async) and ``submit_nowait()`` park each ``(pub, msg,
  sig)`` request; requests coalesce until the oldest has waited
  ``max_wait_ms`` (window flush) or ``max_lanes`` lanes are pending
  (size flush).  The lane cap is the configured size: the JAX package
  snaps it down to a TPU compile bucket, and the port's kernels take any
  lane count.
- one dispatch runs the whole micro-batch through ``BatchVerifier`` on
  the scheduler's device, queued on the device-owner thread
  (``crypto/batch.py:device_submit``) behind whatever device work is
  ahead of it, then demultiplexes per-item verdicts back to the callers.
- a bounded LRU **verified-signature cache** keyed by ``(pubkey bytes,
  sha256(msg), sig)`` remembers positive verdicts only.  It is consulted
  and seeded by this scheduler, by ``VoteSet._verify`` (sync, through
  :func:`verify_cached`) and by the ``VerifyCommit*`` family
  (``types/validation.py``), so a vote gossiped to k peers and then
  re-checked inside the commit costs one device lane instead of k + 1.
  Failed verdicts are never cached.  Requests for a key already pending
  or in flight attach to it instead of taking another lane.

Evidence-grade checks (the conflicting-vote branch of
``VoteSet.add_vote``, the proposal signature in consensus, duplicate-vote
evidence) use :func:`verify_uncached`: a fresh device verification that
neither reads nor seeds the cache.

Where the JAX package verifies on the host, the port verifies on the
scheduler's device, and an error that persists reaches the caller:

- a batch of one is a one-lane ``BatchVerifier`` call like any other
  batch;
- a ``verify_sync`` miss (``VoteSet._verify`` on the consensus event
  loop) is a one-lane device call on the device-owner thread, which the
  caller waits for; a flush queued ahead of it needs nothing from the
  event loop, so the wait always ends;
- a failed batch dispatch re-verifies item by item, one lane a call; if
  that fails too, awaiting callers get the exception and
  ``submit_nowait`` callbacks get False (nothing is cached, so the
  consensus handler verifies the vote again itself and meets the error);
- past the verdict deadline an awaiting caller verifies its one lane on
  the device from a worker thread, not behind the device-owner queue.

With no scheduler registered, :func:`verify_cached` and
:func:`verify_uncached` raise ``RuntimeError``: the port has no host
verifier to fall back to.  Every harness and test registers one (on
``"cpu"`` in the tests, where the kernels' plain versions run).

One process-wide scheduler is shared by every in-process node, refcounted
through :func:`acquire_scheduler`/:func:`release_scheduler`.
``stats()`` counts flushes, lanes, cache hits and misses, and the
one-lane device checks by source (``sync``, ``uncached``, ``direct``,
``recover``, ``overdue``).
"""

from __future__ import annotations

import asyncio
import collections
import hashlib
import threading
import time

from ..libs import failures
from ..libs import metrics
from ..libs import tracing
from ..libs.service import BaseService
from . import batch as cryptobatch
from . import plan as _plan

__all__ = ["cache_key", "VerifiedSigCache", "VerificationScheduler",
           "get_scheduler", "set_scheduler", "acquire_scheduler",
           "release_scheduler", "cache_active", "dense_cache_active",
           "verify_cached", "verify_uncached", "cache_lookup",
           "cache_seed"]


def _sched_metrics():
    """Registered once (``libs.metrics`` dedups by name)."""
    return (
        metrics.histogram(
            "crypto_sched_batch_lanes",
            "micro-batch occupancy at dispatch (lanes per flush)",
            buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)),
        metrics.histogram(
            "crypto_sched_wait_seconds",
            "time a request waited in the coalescing window"),
        metrics.histogram(
            "crypto_sched_latency_seconds",
            "end-to-end single-verification latency through the scheduler"),
        metrics.counter(
            "crypto_sched_cache_hits_total",
            "verified-signature cache hits, by consulting subsystem"),
        metrics.counter(
            "crypto_sched_cache_misses_total",
            "verified-signature cache misses, by consulting subsystem"),
        metrics.counter(
            "crypto_sched_dedup_inflight_total",
            "requests coalesced onto an identical in-flight verification"),
        metrics.counter(
            "crypto_sched_flush_total",
            "micro-batch flushes, by trigger (window/size/stop)"),
        metrics.counter(
            "crypto_sched_lanes_total",
            "scheduler-verified lanes, by verdict"),
    )


# ------------------------------------------------------------------ cache


def cache_key(pub_bytes: bytes, msg: bytes, sig: bytes) -> tuple:
    """Cache key for one verification: the message is folded through
    sha256 so keys stay bounded whatever the message size."""
    return (pub_bytes, hashlib.sha256(msg).digest(), sig)


class VerifiedSigCache:
    """Bounded LRU of positively verified signatures.

    Thread-safe: consulted from the event loop (scheduler, vote sets) and
    from worker threads.  Only ``True`` verdicts are stored; there is no
    API to record a failure, so a bug cannot turn this into a
    forged-signature oracle.  Eviction is plain LRU by dict order."""

    def __init__(self, max_size: int = 65536):
        self.max_size = max(0, int(max_size))
        self._entries: dict[tuple, None] = {}
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return len(self._entries)

    def hit(self, key: tuple) -> bool:
        """True iff ``key`` was verified before; refreshes recency."""
        if self.max_size == 0:
            return False
        with self._lock:
            if key not in self._entries:
                return False
            del self._entries[key]
            self._entries[key] = None
            return True

    def seed(self, key: tuple) -> None:
        if self.max_size == 0:
            return
        with self._lock:
            if key in self._entries:
                del self._entries[key]
            self._entries[key] = None
            while len(self._entries) > self.max_size:
                del self._entries[next(iter(self._entries))]

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()


# -------------------------------------------------------------- scheduler


class _OverdueSentinel:
    """Resolved into a request's future when its deadline passes before
    the verdict is demuxed: awaiting callers verify their lane alone."""


_OVERDUE = _OverdueSentinel()


class _Request:
    __slots__ = ("key", "pub", "msg", "sig", "future", "callbacks",
                 "t_enqueue", "timer", "height")

    def __init__(self, key, pub, msg, sig, height=0):
        self.key = key
        self.pub = pub
        self.msg = msg
        self.sig = sig
        # block height of the signature (0 = unknown), stamped on the
        # flush and dispatch trace records
        self.height = height
        # one shared future for every awaiting caller, plain callbacks
        # for the fire-and-forget path
        self.future: asyncio.Future | None = None
        self.callbacks: list = []
        self.t_enqueue = time.perf_counter()
        self.timer: asyncio.TimerHandle | None = None


class VerificationScheduler(BaseService):
    """Latency-bounded micro-batching over ``BatchVerifier`` on
    ``device`` (a device, ``"cpu"`` for the plain versions, or None for
    the plan's devices; resolved here, so a scheduler without a card
    raises at construction).  ``max_lanes`` caps a batch (a size flush);
    ``max_wait_ms`` bounds how long the first request of a window
    waits."""

    def __init__(self, device=None, max_wait_ms: float = 2.0,
                 max_lanes: int = 256, cache_size: int = 65536,
                 verify_timeout_s: float = 0.0,
                 name: str = "vote-sched"):
        super().__init__(name=name)
        _plan.resolve_devices(device)          # raises without a card
        self.device = device
        self.max_wait_s = max(0.0, float(max_wait_ms)) / 1e3
        self.max_lanes = max(1, int(max_lanes))
        # deadline on awaiting a verdict future: ~5x the window, floored
        # at 1 s; past it the caller verifies its lane alone
        self.verify_timeout_s = (float(verify_timeout_s)
                                 if verify_timeout_s and verify_timeout_s > 0
                                 else max(1.0, 5.0 * self.max_wait_s))
        self.cache = VerifiedSigCache(cache_size)
        self._pending: dict[tuple, _Request] = {}
        # dispatched, not yet demuxed: identical requests attach here
        self._inflight: dict[tuple, _Request] = {}
        self._timer: asyncio.TimerHandle | None = None
        self._dispatches: set[asyncio.Task] = set()
        self._loop: asyncio.AbstractEventLoop | None = None
        self._m = _sched_metrics()
        (_, _, _, hits, misses, dedup, _, lanes) = self._m
        self._bound: dict[str, tuple] = {
            s: (hits.bind(source=s), misses.bind(source=s))
            for s in ("scheduler", "votes", "commit", "sync")}
        self._dedup_b = dedup.bind()
        self._lanes_ok = lanes.bind(verdict="ok")
        self._lanes_bad = lanes.bind(verdict="bad")
        self._occ_b = self._m[0].bind()
        self._wait_b = self._m[1].bind()
        self._lat_b = self._m[2].bind()
        # per-instance tallies for stats() (the metrics registry is
        # process-global and outlives instances)
        self._t_hits = 0
        self._t_misses = 0
        self._t_dedup = 0
        self._t_ok = 0
        self._t_bad = 0
        self._t_batches = 0
        self._t_lanes_sum = 0
        self._t_max_lanes = 0
        self._t_single: collections.Counter = collections.Counter()
        self._t_lock = threading.Lock()

    # ----------------------------------------------------------- lifecycle

    async def on_start(self) -> None:
        self._loop = asyncio.get_running_loop()

    def _abandon(self) -> None:
        """Synchronous teardown for an instance whose event loop is gone:
        parked requests are dropped (their futures belong to the dead
        loop)."""
        self._running = False
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None
        self._pending.clear()
        self._inflight.clear()

    async def on_stop(self) -> None:
        """Flush everything still pending, then wait for in-flight
        dispatches to demux their verdicts."""
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None
        if self._pending:
            self._flush("stop")
        for t in list(self._dispatches):
            try:
                await t
            except Exception:
                pass

    # ------------------------------------------------------ device checks

    def _check_lanes(self, items) -> list[bool]:
        """Verdicts of ``(pub, msg, sig)`` items in one ``BatchVerifier``
        call on the scheduler's device (on the calling thread)."""
        bv = cryptobatch.create_batch_verifier(self.device)
        for pub, msg, sig in items:
            bv.add(pub, msg, sig)
        return [bool(ok) for ok in bv.verify()[1]]

    def _check_one(self, pub, msg: bytes, sig: bytes, source: str,
                   owner: bool = True) -> bool:
        """One lane on the device: on the device-owner thread (queued
        behind the work ahead of it) unless ``owner`` is False.  Counted
        in ``stats()["single_checks"]`` under ``source``."""
        with self._t_lock:
            self._t_single[source] += 1

        def run():
            return self._check_lanes([(pub, msg, sig)])[0]

        return run() if not owner else cryptobatch.device_call(run)

    # -------------------------------------------------------------- verify

    def _enqueue(self, pub, msg, sig, key, height: int = 0) -> _Request:
        """The request to attach to: one already pending or in flight
        for ``key``, or a new one (which may trigger a size flush)."""
        req = self._pending.get(key) or self._inflight.get(key)
        if req is not None:
            self._dedup_b.inc()
            self._t_dedup += 1
            return req
        req = _Request(key, pub, bytes(msg), bytes(sig), height)
        self._pending[key] = req
        if len(self._pending) >= self.max_lanes:
            self._flush("size")
        elif self._timer is None:
            self._timer = (self._loop or asyncio.get_event_loop()) \
                .call_later(self.max_wait_s, self._flush, "window")
        return req

    async def verify(self, pub, msg: bytes, sig: bytes) -> bool:
        """Coalescing single-verification entry point for async callers.
        When the service is not running the lane is checked alone."""
        t0 = time.perf_counter()
        key = cache_key(pub.bytes(), msg, sig)
        hit_b, miss_b = self._bound["scheduler"]
        if self.cache.hit(key):
            hit_b.inc()
            self._t_hits += 1
            return True
        miss_b.inc()
        self._t_misses += 1
        if not self.is_running:
            ok = self._check_one(pub, msg, sig, "direct")
            if ok:
                self.cache.seed(key)
            self._lat_b.observe(time.perf_counter() - t0)
            return ok
        req = self._enqueue(pub, msg, sig, key)
        if req.future is None:
            loop = asyncio.get_running_loop()
            req.future = loop.create_future()
            req.timer = loop.call_later(self.verify_timeout_s,
                                        self._overdue, req)
        res = _OVERDUE
        try:
            # shield: one caller's cancellation must not cancel the
            # future its batchmates share
            res = await asyncio.shield(req.future)
        except asyncio.CancelledError:
            self._lat_b.observe(time.perf_counter() - t0)
            raise
        except Exception as e:       # the batch and its recovery failed
            self.log.error("scheduler verdict failed; verifying the "
                           "lane alone", err=repr(e))
        if res is _OVERDUE:
            # off the event loop and off the device-owner queue: the
            # deadline usually means that queue is stuck
            ok = bool(await asyncio.to_thread(
                self._check_one, pub, msg, sig, "overdue", False))
            if ok:
                self.cache.seed(key)
        else:
            ok = bool(res)
        self._lat_b.observe(time.perf_counter() - t0)
        return ok

    def _overdue(self, req: _Request) -> None:
        req.timer = None
        if req.future is not None and not req.future.done():
            req.future.set_result(_OVERDUE)

    def submit_nowait(self, pub, msg: bytes, sig: bytes, on_done=None,
                      height: int = 0) -> None:
        """Fire-and-forget coalescing submission (consensus vote
        prefetch): ``on_done(ok)`` runs on the event loop once the
        verdict lands; cache hits and the not-running path call it
        synchronously.  An exception from ``on_done`` is logged, never
        raised into its batchmates' demux."""
        key = cache_key(pub.bytes(), msg, sig)
        hit_b, miss_b = self._bound["scheduler"]
        if self.cache.hit(key):
            hit_b.inc()
            self._t_hits += 1
            if on_done is not None:
                on_done(True)
            return
        miss_b.inc()
        self._t_misses += 1
        if not self.is_running:
            ok = self._check_one(pub, msg, sig, "direct")
            if ok:
                self.cache.seed(key)
            if on_done is not None:
                on_done(ok)
            return
        req = self._enqueue(pub, msg, sig, key, height)
        if on_done is not None:
            req.callbacks.append(on_done)

    def verify_sync(self, pub, msg: bytes, sig: bytes,
                    source: str = "sync") -> bool:
        """Synchronous cached verification for callers that cannot await
        (``VoteSet._verify`` inside the consensus handler): a cache hit,
        or one lane on the device, waited for; a positive verdict seeds
        the cache."""
        key = cache_key(pub.bytes(), msg, sig)
        bound = self._bound.get(source)
        if bound is None:
            bound = (self._m[3].bind(source=source),
                     self._m[4].bind(source=source))
            self._bound[source] = bound
        if self.cache.hit(key):
            bound[0].inc()
            self._t_hits += 1
            return True
        bound[1].inc()
        self._t_misses += 1
        ok = self._check_one(pub, msg, sig, "sync")
        if ok:
            self.cache.seed(key)
        return ok

    def verify_fresh(self, pub, msg: bytes, sig: bytes) -> bool:
        """One lane on the device that neither reads nor seeds the cache
        (:func:`verify_uncached`)."""
        return self._check_one(pub, msg, sig, "uncached")

    # ------------------------------------------------------------ dispatch

    def _flush(self, reason: str) -> None:
        """Move the pending window into one dispatch task (on the event
        loop: a timer callback, or inline from enqueue or stop)."""
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None
        if not self._pending:
            return
        batch = list(self._pending.values())
        self._pending.clear()
        for req in batch:
            self._inflight[req.key] = req
        self._m[6].inc(reason=reason)
        self._t_batches += 1
        self._t_lanes_sum += len(batch)
        self._t_max_lanes = max(self._t_max_lanes, len(batch))
        now = time.perf_counter()
        self._occ_b.observe(len(batch))
        for req in batch:
            self._wait_b.observe(now - req.t_enqueue)
        if tracing.is_enabled():
            hs = [r.height for r in batch if r.height]
            tracing.event("crypto.sched", "flush", reason=reason,
                          lanes=len(batch), h_lo=min(hs, default=0),
                          h_hi=max(hs, default=0))
        loop = self._loop or asyncio.get_running_loop()
        task = loop.create_task(self._dispatch(batch))
        self._dispatches.add(task)
        task.add_done_callback(self._dispatches.discard)

    async def _dispatch(self, batch: list[_Request]) -> None:
        sp = None
        if tracing.is_enabled():
            hs = [r.height for r in batch if r.height]
            sp = tracing.begin("crypto.sched", "dispatch",
                               lanes=len(batch), device=str(self.device),
                               h_lo=min(hs, default=0),
                               h_hi=max(hs, default=0))
        err = None
        try:
            oks = await asyncio.wrap_future(cryptobatch.device_submit(
                lambda: self._verify_batch(batch)))
        except Exception as e:
            # not a signature verdict: every batchmate still deserves a
            # real one, so verify item by item, one lane a call
            self.log.error("batch dispatch failed; verifying items one "
                           "by one", err=repr(e))
            try:
                oks = await asyncio.wrap_future(cryptobatch.device_submit(
                    lambda: self._verify_items(batch)))
            except Exception as e2:
                self.log.error("per-item verification failed",
                               err=repr(e2))
                err = e2
                oks = [False] * len(batch)
        tracing.finish(sp, ok=sum(map(bool, oks)))
        for req, ok in zip(batch, oks):
            ok = bool(ok)
            self._inflight.pop(req.key, None)
            if ok:
                self.cache.seed(req.key)
                self._lanes_ok.inc()
                self._t_ok += 1
            elif err is None:
                self._lanes_bad.inc()
                self._t_bad += 1
            if req.timer is not None:
                req.timer.cancel()
                req.timer = None
            if req.future is not None and not req.future.done():
                if err is not None:
                    req.future.set_exception(err)
                else:
                    req.future.set_result(ok)
            for cb in req.callbacks:
                try:
                    cb(ok)
                except Exception as e:
                    self.log.error("submit_nowait callback failed",
                                   err=repr(e))

    def _verify_batch(self, batch: list[_Request]) -> list[bool]:
        """Device-owner body: one ``BatchVerifier`` pass over the batch,
        however many lanes (a batch of one is a one-lane call)."""
        if failures.fire("sched.dispatch.raise") is not None:
            raise RuntimeError("chaos: injected scheduler dispatch "
                               "failure")
        return self._check_lanes([(r.pub, r.msg, r.sig) for r in batch])

    def _verify_items(self, batch: list[_Request]) -> list[bool]:
        """Recovery after a failed dispatch: one one-lane device call per
        item, no injection site."""
        return [self._check_one(r.pub, r.msg, r.sig, "recover", False)
                for r in batch]

    # ------------------------------------------------------------- surface

    def stats(self) -> dict:
        """This instance's cache and coalescing tallies, and its one-lane
        device checks by source."""
        lookups = self._t_hits + self._t_misses
        with self._t_lock:
            single = dict(self._t_single)
        return {
            "cache_size": len(self.cache),
            "cache_hits": self._t_hits,
            "cache_misses": self._t_misses,
            "cache_hit_rate": (self._t_hits / lookups) if lookups else 0.0,
            "dedup_inflight": self._t_dedup,
            "batches": self._t_batches,
            "batch_lanes": self._t_lanes_sum,
            "max_batch_lanes": self._t_max_lanes,
            "mean_batch_lanes": (self._t_lanes_sum / self._t_batches)
            if self._t_batches else 0.0,
            "lanes_ok": self._t_ok,
            "lanes_bad": self._t_bad,
            "single_checks": single,
        }


# ------------------------------------------------- process-wide registry

_GLOBAL: VerificationScheduler | None = None
_REFS = 0


def get_scheduler() -> VerificationScheduler | None:
    return _GLOBAL


def set_scheduler(sched: VerificationScheduler | None) -> None:
    """Install (or clear) the process-wide scheduler directly, bypassing
    the refcount (tests and tooling)."""
    global _GLOBAL, _REFS
    _GLOBAL = sched
    _REFS = 0 if sched is None else max(_REFS, 1)


async def acquire_scheduler(device=None, max_wait_ms: float = 2.0,
                            max_lanes: int = 256, cache_size: int = 65536,
                            verify_timeout_s: float = 0.0
                            ) -> VerificationScheduler:
    """Start (or share) the process-wide scheduler: the first caller's
    settings win.  A scheduler left over from another (dead) event loop
    is discarded, not reused."""
    global _GLOBAL, _REFS
    loop = asyncio.get_running_loop()
    if _GLOBAL is not None and (_GLOBAL._loop is not loop
                                or not _GLOBAL.is_running):
        _GLOBAL._abandon()
        _GLOBAL = None
        _REFS = 0
    if _GLOBAL is None:
        sched = VerificationScheduler(
            device=device, max_wait_ms=max_wait_ms, max_lanes=max_lanes,
            cache_size=cache_size, verify_timeout_s=verify_timeout_s)
        await sched.start()
        _GLOBAL = sched
    _REFS += 1
    return _GLOBAL


async def release_scheduler() -> None:
    """Drop one reference; the last release stops the service."""
    global _GLOBAL, _REFS
    if _GLOBAL is None:
        return
    _REFS -= 1
    if _REFS <= 0:
        sched, _GLOBAL, _REFS = _GLOBAL, None, 0
        await sched.stop()


# ----------------------------------------------- sync helpers (hot path)


def _registered() -> VerificationScheduler:
    sched = _GLOBAL
    if sched is None:
        raise RuntimeError(
            "no verification scheduler registered: the port verifies "
            "signatures on a device only (acquire_scheduler(device=...))")
    return sched


def cache_active() -> bool:
    """True when a scheduler (hence a cache) is registered."""
    return _GLOBAL is not None


def dense_cache_active() -> bool:
    """Gate for the dense commit paths: an empty cache cannot hit, and
    the per-lane key build is pure overhead then."""
    return _GLOBAL is not None and len(_GLOBAL.cache) > 0


def verify_cached(pub, msg: bytes, sig: bytes,
                  source: str = "votes") -> bool:
    """Cached single verification for sync call sites
    (``VoteSet._verify``): a cache hit, else one lane on the
    scheduler's device, seeding the cache.  Raises ``RuntimeError`` with
    no scheduler registered."""
    return _registered().verify_sync(pub, msg, sig, source=source)


def verify_uncached(pub, msg: bytes, sig: bytes) -> bool:
    """Evidence-grade verification: one fresh lane on the scheduler's
    device that never reads or seeds the cache (conflicting votes,
    proposals, duplicate-vote evidence).  Raises ``RuntimeError`` with no
    scheduler registered."""
    return _registered().verify_fresh(pub, msg, sig)


def cache_lookup(pub_bytes: bytes, msg: bytes, sig: bytes,
                 source: str = "commit") -> bool:
    """Dense-path cache consult (``types/validation.py``): True iff this
    exact (pub, msg, sig) was positively verified before."""
    sched = _GLOBAL
    if sched is None:
        return False
    key = cache_key(pub_bytes, msg, sig)
    bound = sched._bound.get(source)
    if bound is None:
        bound = (sched._m[3].bind(source=source),
                 sched._m[4].bind(source=source))
        sched._bound[source] = bound
    if sched.cache.hit(key):
        bound[0].inc()
        return True
    bound[1].inc()
    return False


def cache_seed(pub_bytes: bytes, msg: bytes, sig: bytes) -> None:
    """Record a positive verdict obtained outside the scheduler (a
    successful ``VerifyCommit*`` seeds its lanes)."""
    sched = _GLOBAL
    if sched is None:
        return
    sched.cache.seed(cache_key(pub_bytes, msg, sig))
