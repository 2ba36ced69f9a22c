"""Sharded FIFO mempool (counterpart of
``cometbft_tpu/mempool/clist_mempool.py``; reference:
``mempool/clist_mempool.go``).

Under a single-threaded asyncio runtime the reference's concurrent
linked list and mutexes become tx maps guarded by admission gates.
Kept: LRU cache dedup (committed txs stay cached), the post-block
recheck of survivors through the app's mempool connection, gas- and
byte-capped reaping, and the "txs available" signal for the consensus
proposer (``mempool/clist_mempool.go:241,307,383,497``).

The pool is sharded by tx-hash prefix: each shard owns its tx map, byte
total and admission gate, and a process-wide arrival sequence keeps
proposer FIFO (reaping merges the shards by ``seq``).  CheckTx round
trips are coalesced per shard by a latency-bounded batcher (a window or
``coalesce_max`` requests, then the burst goes to the app together).
The burst cap and the recheck chunk are the configured sizes: the JAX
package snaps both to its TPU compile buckets
(``cometbft_tpu/mempool/clist_mempool.py:176,328``), and the port's
kernels have none."""

from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass

from ..abci.client import ABCIClient
from ..libs import tracing
from .cache import LRUTxCache
from .mempool import Mempool, TxKey

__all__ = ["CListMempool", "TxRejectedError", "MempoolFullError"]

DEFAULT_SHARDS = 4
DEFAULT_MAX_TXS_BYTES = 1 << 30          # reference config default: 1 GiB
DEFAULT_COALESCE_MS = 1.0
DEFAULT_COALESCE_MAX = 64


@dataclass
class _MempoolTx:
    tx: bytes
    gas_wanted: int
    height: int          # height when first admitted
    seq: int = 0         # arrival order (assigned BEFORE the app
    #   round-trip, so concurrent admissions completing out of order
    #   still reap/gossip in arrival-FIFO order)
    key: bytes = b""     # TxKey(tx), kept so the gossip walk never
    #   re-hashes the pool (it used to sha256 every tx per peer per pass)


class TxRejectedError(Exception):
    def __init__(self, code: int, log: str):
        self.code = code
        self.log = log
        super().__init__(f"tx rejected: code={code} {log}")


class MempoolFullError(TxRejectedError):
    """Capacity rejection raised by the mempool itself (pool full).
    Its own type so the gossip reactor can tell OUR backpressure apart
    from an app rejection without parsing log strings the app
    controls."""


class _AdmissionGate:
    """Reader-writer gate for admission vs update (one per shard).

    Readers are concurrent ``check_tx`` admissions: each spans an app
    round-trip, and serializing them on one lock lets a single slow
    CheckTx stall every other admission AND the gossip intake (the
    reference instead pipelines async CheckTx on a dedicated connection,
    ``mempool/clist_mempool.go:241``).  The writer is the executor's
    FinalizeBlock..Commit..update critical section (and flush), which
    must see no in-flight admissions.  Writer-preferring, so a stream of
    admissions can never starve block execution.

    Scope note: this removes the MEMPOOL's serialization.  How much
    actually overlaps depends on the app connection: SocketClient
    pipelines (futures matched by id), so concurrent admissions overlap
    transport latency and server queueing; LocalClient serializes on one
    lock because the ABCI app contract is serial per connection — the
    same bound the reference's mutex-guarded local client has."""

    def __init__(self):
        self._readers = 0
        self._writers_waiting = 0
        self._writer_active = False
        self._cond = asyncio.Condition()

    async def acquire_read(self):
        async with self._cond:
            while self._writer_active or self._writers_waiting:
                await self._cond.wait()
            self._readers += 1

    async def release_read(self):
        async with self._cond:
            self._readers -= 1
            if self._readers == 0:
                self._cond.notify_all()

    async def acquire_write(self):
        async with self._cond:
            self._writers_waiting += 1
            try:
                while self._writer_active or self._readers:
                    await self._cond.wait()
            finally:
                self._writers_waiting -= 1
            self._writer_active = True

    async def release_write(self):
        async with self._cond:
            self._writer_active = False
            self._cond.notify_all()


class _AllShardsWriteCtx:
    """The executor's critical section: the writer side of EVERY shard's
    gate, acquired in shard order (one fixed order — no lock cycles) and
    released in reverse."""

    __slots__ = ("_shards",)

    def __init__(self, shards: "list[_Shard]"):
        self._shards = shards

    async def __aenter__(self):
        acquired = 0
        try:
            for shard in self._shards:
                await shard.gate.acquire_write()
                acquired += 1
        except BaseException:
            # partial acquire (cancelled while waiting on shard k's
            # in-flight admissions): __aexit__ never runs when
            # __aenter__ raises, so release what we hold or every
            # later check_tx on those shards wedges forever
            for shard in reversed(self._shards[:acquired]):
                await shard.gate.release_write()
            raise

    async def __aexit__(self, *exc):
        for shard in reversed(self._shards):
            await shard.gate.release_write()


class _CheckTxCoalescer:
    """Latency-bounded CheckTx batcher — ``crypto/scheduler.py``'s
    window/size-flush design applied to app round trips.  Each shard
    owns one: requests park behind a future until either the oldest has
    waited ``window_s`` or ``max_lanes`` are pending, then the whole
    burst fires into the app connection CONCURRENTLY (SocketClient
    pipelines it as one wire burst; LocalClient drains it back-to-back
    without yielding to per-tx callers in between) and per-item results
    demux to the awaiting admissions.  An app whose CheckTx routes
    signature checks through the ``VerificationScheduler`` sees the
    burst inside one coalescing window — one verify micro-batch, not
    ``max_lanes`` single scalar multiplications."""

    __slots__ = ("app", "window_s", "max_lanes", "_pending", "_timer",
                 "_tasks", "_occ_hist")

    def __init__(self, app: ABCIClient, window_s: float, max_lanes: int,
                 occ_hist=None):
        self.app = app
        self.window_s = max(0.0, float(window_s))
        self.max_lanes = max(1, int(max_lanes))
        self._pending: list[tuple[bytes, bool, asyncio.Future]] = []
        self._timer: asyncio.TimerHandle | None = None
        self._tasks: set[asyncio.Task] = set()
        self._occ_hist = occ_hist

    async def check(self, tx: bytes, recheck: bool = False):
        """One coalesced CheckTx round trip (returns CheckTxResponse)."""
        if self.window_s <= 0:          # coalescing disabled: direct
            return await self.app.check_tx(tx, recheck=recheck)
        loop = asyncio.get_running_loop()
        fut = loop.create_future()
        self._pending.append((tx, recheck, fut))
        if len(self._pending) >= self.max_lanes:
            self._flush()
        elif self._timer is None:
            self._timer = loop.call_later(self.window_s, self._flush)
        return await fut

    def _flush(self) -> None:
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None
        if not self._pending:
            return
        batch, self._pending = self._pending, []
        if self._occ_hist is not None:
            self._occ_hist.observe(len(batch))
        task = asyncio.ensure_future(self._dispatch(batch))
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)

    async def _dispatch(self, batch) -> None:
        results = await asyncio.gather(
            *(self.app.check_tx(tx, recheck=rc) for tx, rc, _ in batch),
            return_exceptions=True)
        for (_, _, fut), res in zip(batch, results):
            if fut.done():              # caller gone (cancelled await)
                continue
            if isinstance(res, BaseException):
                fut.set_exception(res)
            else:
                fut.set_result(res)

    def drain(self) -> None:
        """Flush whatever is parked (update() about to wait on the
        writer gates: parked admissions hold reader slots and would
        deadlock the critical section if their window timer were the
        only thing that ever fired them ... it does fire, but draining
        eagerly keeps the writer wait bounded by the app RTT, not the
        window)."""
        self._flush()


class _Shard:
    """One admission shard: its own tx map, running byte total, gate,
    and CheckTx coalescer."""

    __slots__ = ("index", "txs", "bytes", "gate", "checker")

    def __init__(self, index: int, app: ABCIClient, window_s: float,
                 max_lanes: int, occ_hist=None):
        self.index = index
        self.txs: dict[bytes, _MempoolTx] = {}
        self.bytes = 0
        self.gate = _AdmissionGate()
        self.checker = _CheckTxCoalescer(app, window_s, max_lanes,
                                         occ_hist=occ_hist)

    def ordered(self) -> list[_MempoolTx]:
        """Shard items in arrival order.  Insertion order usually IS
        arrival order; it diverges only when concurrent admissions
        complete out of order, so sort lazily (timsort on nearly-sorted
        is ~O(n))."""
        items = list(self.txs.values())
        for a, b in zip(items, items[1:]):
            if a.seq > b.seq:
                items.sort(key=lambda i: i.seq)
                break
        return items


class CListMempool(Mempool):
    def __init__(self, app_conn: ABCIClient, max_txs: int = 5000,
                 max_tx_bytes: int = 1024 * 1024, cache_size: int = 10_000,
                 keep_invalid_txs_in_cache: bool = False,
                 metrics_node: str = "", shards: int = DEFAULT_SHARDS,
                 max_txs_bytes: int = DEFAULT_MAX_TXS_BYTES,
                 coalesce_ms: float = DEFAULT_COALESCE_MS,
                 coalesce_max: int = DEFAULT_COALESCE_MAX,
                 recheck: bool = True):
        self.app = app_conn
        self.max_txs = max_txs
        self.max_tx_bytes = max_tx_bytes
        self.max_txs_bytes = max(0, int(max_txs_bytes))
        self.recheck = recheck
        self.cache = LRUTxCache(cache_size)
        self.keep_invalid = keep_invalid_txs_in_cache
        self._arrival = 0                # next arrival sequence number
        self._size = 0                   # live txs across shards (O(1))
        self._bytes = 0                  # live tx bytes across shards (O(1))
        from ..libs import metrics as _m

        # labeled per node: multi-node in-process ensembles (tier-1
        # tests) share the process-wide registry
        self._m_node = metrics_node
        self._m_size = _m.gauge("mempool_size",
                                "txs currently in the mempool")
        self._m_bytes = _m.gauge("mempool_size_bytes",
                                 "bytes of txs currently in the mempool")
        self._m_shard = _m.gauge("mempool_shard_txs",
                                 "txs currently in one mempool shard")
        self._m_admit = _m.histogram(
            "mempool_admission_seconds",
            "CheckTx admission latency (entry -> admitted/rejected), "
            "including the coalescing window and the app round trip",
            buckets=(0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                     0.1, 0.25, 0.5, 1, 2.5))
        self._m_coalesce = _m.histogram(
            "mempool_coalesce_lanes",
            "CheckTx burst occupancy at coalescer flush (txs per burst)",
            buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256))
        self._m_reap = _m.histogram(
            "mempool_reap_seconds",
            "proposal reap latency (mempool -> block tx list)",
            buckets=(0.00005, 0.0001, 0.00025, 0.0005, 0.001, 0.0025,
                     0.005, 0.01, 0.05, 0.1))
        self._m_recheck = _m.histogram(
            "mempool_recheck_seconds",
            "post-commit survivor recheck latency (whole pass)",
            buckets=(0.0001, 0.0005, 0.001, 0.005, 0.01, 0.05, 0.1,
                     0.5, 1, 5))
        self._admit_b = self._m_admit.bind(node=metrics_node)
        coalesce_b = self._m_coalesce.bind(node=metrics_node)
        self.n_shards = max(1, int(shards))
        self._shards = [
            _Shard(i, app_conn, coalesce_ms / 1e3, coalesce_max,
                   occ_hist=coalesce_b)
            for i in range(self.n_shards)]
        self._shard_g = [self._m_shard.bind(node=metrics_node, shard=str(i))
                         for i in range(self.n_shards)]
        # recheck chunk: how many survivor CheckTx requests fire into
        # the pipeline per gather (bounds task fan-out at a large
        # backlog)
        self._recheck_chunk = max(256, 4 * coalesce_max * self.n_shards)
        self._txs_available = asyncio.Event()
        self._notified_available = False
        # edge callback fired once per height on the first admitted tx
        # (the reference's TxsAvailable channel consumer is consensus)
        self.on_txs_available = None
        # removal hook: the gossip reactor prunes its per-tx maps
        # (senders, announcers) when txs leave the pool
        self.on_txs_removed = None
        self.height = 0

    # ------------------------------------------------------------ sharding

    def _shard_of(self, key: bytes) -> "_Shard":
        """Shard routing by tx-hash prefix: the key IS a sha256 digest,
        so its first bytes are uniform — no extra hashing needed."""
        return self._shards[int.from_bytes(key[:2], "big") % self.n_shards]

    # ------------------------------------------------------------- check_tx

    def is_full(self, incoming_bytes: int = 0) -> bool:
        """True when the pool cannot take ``incoming_bytes`` more: BOTH
        capacity axes (tx count and bytes).  The gossip reactor's shed
        paths consult this — byte-full must shed exactly like
        count-full."""
        if self._size >= self.max_txs:
            return True
        return (self.max_txs_bytes > 0
                and self._bytes + incoming_bytes > self.max_txs_bytes)


    async def check_tx(self, tx: bytes) -> None:
        """Admit a tx (rpc broadcast_tx / p2p gossip entry).  Raises
        TxRejectedError on app rejection; silently ignores cache hits."""
        t0 = time.perf_counter()
        if len(tx) > self.max_tx_bytes:
            raise TxRejectedError(1, "tx too large")
        if self.is_full(len(tx)):
            raise MempoolFullError(1, "mempool is full")
        key = TxKey(tx)
        if not self.cache.push(key):
            return                       # seen before (maybe committed)
        shard = self._shard_of(key)
        # reader side of the shard's gate: many admissions run their app
        # round-trips CONCURRENTLY (one slow CheckTx no longer stalls
        # every other admission); update/flush take the writer side
        await shard.gate.acquire_read()
        try:
            self._arrival += 1
            seq = self._arrival          # before the await: arrival order
            res = await shard.checker.check(tx, recheck=False)
            if not res.is_ok:
                if not self.keep_invalid:
                    self.cache.remove(key)
                raise TxRejectedError(res.code, res.log)
            if self.is_full(len(tx)):
                self.cache.remove(key)   # full while we were in flight
                raise MempoolFullError(1, "mempool is full")
            if key not in shard.txs:
                shard.txs[key] = _MempoolTx(tx, res.gas_wanted,
                                            self.height, seq, key)
                shard.bytes += len(tx)
                self._size += 1
                self._bytes += len(tx)
                self._set_gauges(shard)
                self._notify_available()
        finally:
            await shard.gate.release_read()
            self._admit_b.observe(time.perf_counter() - t0)

    def _set_gauges(self, shard: "_Shard | None" = None) -> None:
        self._m_size.set(self._size, node=self._m_node)
        self._m_bytes.set(self._bytes, node=self._m_node)
        if shard is not None:
            self._shard_g[shard.index].set(len(shard.txs))

    def _notify_available(self):
        if self._size and not self._notified_available:
            self._notified_available = True
            self._txs_available.set()
            if self.on_txs_available is not None:
                self.on_txs_available()

    def txs_available(self) -> asyncio.Event:
        return self._txs_available

    # --------------------------------------------------------------- reaping

    def _ordered(self) -> list[_MempoolTx]:
        """Items in global arrival order: per-shard FIFO lists merged by
        arrival seq (each shard list is sorted, so this is a k-way
        merge, not a full sort)."""
        per_shard = [s.ordered() for s in self._shards if s.txs]
        if not per_shard:
            return []
        if len(per_shard) == 1:
            return per_shard[0]
        import heapq

        return list(heapq.merge(*per_shard, key=lambda i: i.seq))

    def reap_max_bytes_max_gas(self, max_bytes: int,
                               max_gas: int) -> list[bytes]:
        t0 = time.perf_counter()
        out, total_bytes, total_gas = [], 0, 0
        for item in self._ordered():
            total_bytes += len(item.tx)
            if max_bytes >= 0 and total_bytes > max_bytes:
                break
            total_gas += item.gas_wanted
            if max_gas >= 0 and total_gas > max_gas:
                break
            out.append(item.tx)
        dt = time.perf_counter() - t0
        self._m_reap.observe(dt, node=self._m_node)
        tracing.event("mempool", "reap", node=self._m_node, txs=len(out),
                      pool=self._size, dur_us=int(dt * 1e6))
        return out

    def reap_max_txs(self, n: int) -> list[bytes]:
        return [item.tx for item in self._ordered()[:n]]

    # ---------------------------------------------------------------- update

    def lock(self):
        """The executor holds this across FinalizeBlock-Commit-update
        (state/execution.go:295,391-460): the writer side of EVERY
        shard's admission gate — exclusive against in-flight check_tx
        readers.  Parked coalescer windows are drained first so the
        writer wait is bounded by the app RTT, not the window timer."""
        for shard in self._shards:
            shard.checker.drain()
        return _AllShardsWriteCtx(self._shards)

    def _remove(self, key: bytes, removed: list[bytes]) -> "_MempoolTx | None":
        shard = self._shard_of(key)
        item = shard.txs.pop(key, None)
        if item is not None:
            shard.bytes -= len(item.tx)
            self._size -= 1
            self._bytes -= len(item.tx)
            removed.append(key)
        return item

    async def update(self, height: int, txs: list[bytes],
                     tx_results: list) -> None:
        """Remove committed txs, keep them cached, recheck survivors.
        Caller must hold lock() (like the reference's Lock/Update
        contract)."""
        self.height = height
        self._notified_available = False
        self._txs_available.clear()
        removed: list[bytes] = []
        for i, tx in enumerate(txs):
            key = TxKey(tx)
            ok = i >= len(tx_results) or tx_results[i].is_ok
            if ok:
                self.cache.push(key)     # committed txs stay in cache
            elif not self.keep_invalid:
                self.cache.remove(key)
            self._remove(key, removed)
        # batched recheck of survivors against the post-block app state:
        # fire a chunk of CheckTx requests into the pipeline together
        # and demux per-item verdicts, instead of one awaited round trip
        # per tx (the serial loop was the recheck bottleneck at scale)
        t0 = time.perf_counter()
        rechecked = dropped = 0
        try:
            if self.recheck and self._size:
                survivors: list[tuple[bytes, _MempoolTx]] = []
                for shard in self._shards:
                    survivors.extend(shard.txs.items())
                chunk = self._recheck_chunk
                for lo in range(0, len(survivors), chunk):
                    part = survivors[lo:lo + chunk]
                    results = await asyncio.gather(
                        *(self.app.check_tx(item.tx, recheck=True)
                          for _, item in part),
                        return_exceptions=True)
                    err: BaseException | None = None
                    for (key, item), res in zip(part, results):
                        if isinstance(res, BaseException):
                            # infra failure, not a verdict: keep the
                            # tx, surface the error after demuxing
                            # batchmates
                            err = err or res
                            continue
                        rechecked += 1
                        if not res.is_ok:
                            self._remove(key, removed)
                            dropped += 1
                            if not self.keep_invalid:
                                self.cache.remove(key)
                    if err is not None:
                        raise err
        finally:
            # a mid-pass infra error must not leave stale gauges or
            # unpruned gossip bookkeeping for txs ALREADY removed
            if rechecked:
                dt = time.perf_counter() - t0
                self._m_recheck.observe(dt, node=self._m_node)
                tracing.event("mempool", "recheck", node=self._m_node,
                              height=height, rechecked=rechecked,
                              dropped=dropped, dur_us=int(dt * 1e6))
            for shard in self._shards:
                self._shard_g[shard.index].set(len(shard.txs))
            self._set_gauges()
            if removed and self.on_txs_removed is not None:
                self.on_txs_removed(removed)
            if self._size:
                self._notify_available()

    def size(self) -> int:
        return self._size

    def size_bytes(self) -> int:
        """O(1): a running total maintained on admit/remove (was a full
        pool walk per call)."""
        return self._bytes

    async def flush(self) -> None:
        for shard in self._shards:      # same RTT-bounded writer wait
            shard.checker.drain()       # contract as lock()
        async with _AllShardsWriteCtx(self._shards):
            removed = [k for s in self._shards for k in s.txs]
            for i, shard in enumerate(self._shards):
                shard.txs.clear()
                shard.bytes = 0
                self._shard_g[i].set(0)
            self._size = 0
            self._bytes = 0
            self._set_gauges()
            self.cache.reset()
            self._txs_available.clear()
            self._notified_available = False
            if removed and self.on_txs_removed is not None:
                self.on_txs_removed(removed)

    def contents(self) -> list[bytes]:
        """Iteration snapshot for the gossip reactor (arrival order)."""
        return [i.tx for i in self._ordered()]

    def items(self) -> list[tuple[bytes, bytes]]:
        """``(tx key, tx)`` snapshot in arrival order — the gossip
        reactor's walk, WITHOUT re-hashing every tx per peer per pass
        (keys ride on the pool entries)."""
        return [(i.key, i.tx) for i in self._ordered()]

    def get_tx(self, key: bytes) -> bytes | None:
        """Body lookup by tx key (content-addressed gossip serves fetch
        requests from here)."""
        item = self._shard_of(key).txs.get(key)
        return None if item is None else item.tx

    def stats(self) -> dict:
        """Operator/bench surface."""
        return {
            "size": self._size,
            "size_bytes": self._bytes,
            "shards": [len(s.txs) for s in self._shards],
            "arrival_seq": self._arrival,
        }
