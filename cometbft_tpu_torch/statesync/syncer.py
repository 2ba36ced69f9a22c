"""Statesync syncer: bootstrap a fresh node from an application snapshot
instead of replaying the chain (counterpart of
``cometbft_tpu/statesync/syncer.py``; reference: ``statesync/syncer.go:53,144,
240,321,357`` + ``chunks.go`` + ``snapshots.go``).

Flow (syncer.go SyncAny):
1. discover snapshots from peers;
2. verify the snapshot height against the light client (trusted app
   hash from header h+1) and OfferSnapshot to the local app;
3. negotiate the chunk manifest (per-chunk sha256 bound to the snapshot
   hash, see ``manifest.py``) from the peers whose offers agree on it;
4. fetch chunks from the peers advertising the snapshot — every chunk
   verified against the manifest BEFORE it is spooled, a mismatch bans
   the sender and re-requests only that chunk from another holder —
   then ApplySnapshotChunk in strict index order;
5. ABCI Info must land on (height, app_hash);
6. bootstrap the state store from the light-client state and record the
   trusted commit so consensus/blocksync can continue from h.

The spool is content-addressed (``_BlobPool``): chunk bytes are stored
under their sha256, so duplicate deliveries, identical chunks across
heights/formats (app state barely changes block-to-block) and snapshot
retry rounds all hit the same blob.  Released blobs are RETAINED up to
a byte budget, which is what makes a failed restore resumable — the
next attempt adopts every blob the manifest says it already has."""

from __future__ import annotations

import asyncio
import errno
import functools
import hashlib
import os
import shutil
import tempfile
import threading

from ..libs import aio, clock, failures

from ..abci import types as abci
from ..libs import log as tmlog
from .manifest import manifest_root, valid_hash_list
from .stateprovider import StateProvider


@functools.cache
def _ss_metrics():
    from types import SimpleNamespace

    from ..libs import metrics as m

    return SimpleNamespace(
        senders_banned=m.counter(
            "statesync_senders_banned_total",
            "snapshot senders the app rejected (REJECT_SENDER offers or "
            "ApplySnapshotChunk reject_senders) — a stalled sync with "
            "this climbing means the snapshot sources are bad, not "
            "the network"),
        formats_rejected=m.counter(
            "statesync_formats_rejected_total",
            "snapshot offers rejected with REJECT_FORMAT (final per "
            "format for the whole sync)"),
        chunks_verified=m.counter(
            "statesync_chunks_verified_total",
            "fetched chunks that passed the manifest hash check before "
            "spooling"),
        hash_mismatches=m.counter(
            "statesync_chunk_hash_mismatches_total",
            "fetched chunks whose sha256 did not match the manifest — "
            "each one is a corrupt or malicious sender caught BEFORE "
            "the app saw the bytes"),
        chunks_dedup=m.counter(
            "statesync_chunks_dedup_total",
            "spool writes satisfied by an existing content-addressed "
            "blob (duplicate delivery, cross-snapshot identical chunk, "
            "or retry-round resume)"),
        chunks_resumed=m.counter(
            "statesync_chunks_resumed_total",
            "chunks adopted from the retained blob pool at restore "
            "start instead of being re-fetched (resumable multi-peer "
            "fetch)"),
        restore_resets=m.counter(
            "statesync_restore_resets_total",
            "full restore resets (APPLY_CHUNK_RETRY / refetch of an "
            "applied chunk) — with manifest verification active this "
            "should stay at zero"),
        spool_fatal=m.counter(
            "statesync_spool_fatal_io_total",
            "chunk-spool writes that died on a fatal IO error (ENOSPC/"
            "EIO/...): the sync fails with the disk as the cause "
            "instead of decaying into a fetch timeout"))


CHUNK_TIMEOUT = 10.0
# Outstanding chunk requests per serving peer (the reference runs 4
# concurrent chunk fetchers, statesync/syncer.go chunkFetchers): enough
# to keep every peer's pipe full, bounded so one node is never flooded
# and restore throughput scales with the number of serving peers.
MAX_INFLIGHT_PER_PEER = 4
DISCOVERY_TIME = 0.5
DISCOVERY_ROUNDS = 5
# Byte budget for retained (released-but-kept) spool blobs — the
# resumability / cross-snapshot dedup window.
SPOOL_RETAIN_BYTES = 64 * 1024 * 1024

# Mirrors the consensus fsyncgate discipline (consensus/state.py): these
# errnos mean the STORAGE is gone, not that this one write was unlucky.
_FATAL_IO_ERRNOS = frozenset({errno.EIO, errno.ENOSPC, errno.EROFS,
                              errno.EDQUOT, errno.ENXIO})


def _is_fatal_io_error(e: OSError) -> bool:
    return getattr(e, "errno", None) in _FATAL_IO_ERRNOS


class StatesyncError(Exception):
    pass


class StatesyncFatalError(StatesyncError):
    """Unretryable failure (fatal spool IO): retrying another snapshot
    would hit the same dead disk, so this aborts the whole sync with
    the real cause instead of burning the remaining rounds."""


class _RejectFormat(StatesyncError):
    """App returned OFFER_SNAPSHOT_REJECT_FORMAT (syncer.go:38)."""


class _RejectSender(StatesyncError):
    """App returned OFFER_SNAPSHOT_REJECT_SENDER (syncer.go:40)."""


class _PendingSnapshot:
    def __init__(self, snapshot):
        self.snapshot = snapshot
        self.peers: list[str] = []
        # peer -> advertised manifest root (absent for legacy peers)
        self.manifest_roots: dict[str, bytes] = {}


class _BlobPool:
    """Content-addressed blob storage under the spool dir (or in memory
    for the deterministic sim, which must not touch disk or threads).

    Blobs are refcounted by the chunk stores indexing into the pool;
    a blob whose last reference is released moves to a byte-budgeted
    retained tier instead of being deleted, so identical chunks across
    snapshot attempts / heights / formats never transfer twice."""

    def __init__(self, in_memory: bool = False, retain_bytes: int = 0):
        self.in_memory = bool(in_memory)
        self.retain_bytes = max(0, int(retain_bytes))
        self._dir: str | None = None     # created on first disk write
        self._mem: dict[bytes, bytes] = {}
        self._refs: dict[bytes, int] = {}
        self._sizes: dict[bytes, int] = {}
        self._retained: dict[bytes, int] = {}    # hash -> size, LRU order
        self._retained_bytes = 0
        self._closed = False
        self.dedup_hits = 0
        # guards every map transition against writer threads (disk
        # spool writes run in asyncio.to_thread)
        self._mu = threading.Lock()
        self._tmp_seq = 0

    def _path(self, h: bytes) -> str:
        return os.path.join(self._dir, h.hex() + ".blob")

    def put(self, h: bytes, data: bytes) -> bool:
        """Store ``data`` under its hash and take one reference.
        Returns False when the pool is closed (late async write)."""
        with self._mu:
            if self._closed:
                return False
            if h in self._refs:
                self._refs[h] += 1
                self.dedup_hits += 1
                return True
            if h in self._retained:
                self._retained_bytes -= self._retained.pop(h)
                self._refs[h] = 1
                self.dedup_hits += 1
                return True
            if self.in_memory:
                self._mem[h] = bytes(data)
                self._refs[h] = 1
                self._sizes[h] = len(data)
                return True
            if self._dir is None:
                self._dir = tempfile.mkdtemp(prefix="statesync-chunks-")
            # unique tmp per WRITE: concurrent duplicate deliveries of
            # the same content spool concurrently, and sharing one tmp
            # path would interleave their bytes into a torn file
            self._tmp_seq += 1
            tmp = self._path(h) + f".{self._tmp_seq}.tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        with self._mu:
            if self._closed:             # closed while writing: discard
                try:
                    os.remove(tmp)
                except OSError:
                    pass
                return False
            os.replace(tmp, self._path(h))
            self._refs[h] = self._refs.get(h, 0) + 1
            self._sizes[h] = len(data)
        return True

    def acquire(self, h: bytes) -> bool:
        """Take a reference on an EXISTING blob (resume/adopt path)."""
        with self._mu:
            if self._closed:
                return False
            if h in self._refs:
                self._refs[h] += 1
                return True
            if h in self._retained:
                self._retained_bytes -= self._retained.pop(h)
                self._refs[h] = 1
                return True
            return False

    def get(self, h: bytes) -> bytes:
        if self.in_memory:
            return self._mem[h]
        with open(self._path(h), "rb") as f:
            return f.read()

    def release(self, h: bytes) -> None:
        """Drop one reference; the last drop retires the blob into the
        byte-budgeted retained tier (or deletes it at budget 0)."""
        delete: list[bytes] = []
        with self._mu:
            n = self._refs.get(h)
            if n is None:
                return
            if n > 1:
                self._refs[h] = n - 1
                return
            del self._refs[h]
            size = self._sizes.get(h, 0)
            if self.retain_bytes > 0:
                self._retained[h] = size
                self._retained_bytes += size
                while self._retained_bytes > self.retain_bytes \
                        and len(self._retained) > 1:
                    old, osize = next(iter(self._retained.items()))
                    del self._retained[old]
                    self._retained_bytes -= osize
                    delete.append(old)
            else:
                delete.append(h)
        for d in delete:
            self._delete(d)

    def _delete(self, h: bytes) -> None:
        self._sizes.pop(h, None)
        if self.in_memory:
            self._mem.pop(h, None)
        elif self._dir is not None:
            try:
                os.remove(self._path(h))
            except OSError:
                pass

    def close(self) -> None:
        with self._mu:
            self._closed = True
            d, self._dir = self._dir, None
            self._mem.clear()
            self._refs.clear()
            self._sizes.clear()
            self._retained.clear()
            self._retained_bytes = 0
        if d is not None:
            shutil.rmtree(d, ignore_errors=True)


class _ChunkStore:
    """Received-chunk spool (reference: ``statesync/chunks.go`` — chunks
    land on disk, NOT in memory): a snapshot can be many GB, and
    out-of-order chunks would otherwise pile up in RAM while the strictly
    sequential applier waits for the next index.  Dict-shaped so the
    syncer reads naturally; one store indexes ONE snapshot attempt, and
    the bytes live in a (possibly shared, attempt-outliving)
    :class:`_BlobPool` keyed by content hash."""

    def __init__(self, pool: "_BlobPool | None" = None,
                 in_memory: bool = False, retain_bytes: int = 0):
        self._pool = pool if pool is not None else \
            _BlobPool(in_memory=in_memory, retain_bytes=retain_bytes)
        self._owns_pool = pool is None
        self._senders: dict[int, str] = {}
        self._hashes: dict[int, bytes] = {}
        self._closed = False             # late async writes must not
        #   resurrect the spool after close()
        self._mu = threading.Lock()

    @property
    def _dir(self):
        return self._pool._dir

    def __contains__(self, idx: int) -> bool:
        return idx in self._senders

    def __setitem__(self, idx: int, value) -> None:
        data, sender = value
        data = bytes(data)
        h = hashlib.sha256(data).digest()
        with self._mu:
            if self._closed:
                return
        if not self._pool.put(h, data):
            return
        old = None
        with self._mu:
            if self._closed:             # closed while writing: discard
                self._pool.release(h)
                return
            old = self._hashes.get(idx)
            self._hashes[idx] = h
            self._senders[idx] = sender
        if old is not None and old != h:
            self._pool.release(old)
        elif old == h:                   # duplicate delivery, same bytes
            self._pool.release(old)

    def __getitem__(self, idx: int):
        return self._pool.get(self._hashes[idx]), self._senders[idx]

    def adopt(self, idx: int, h: bytes, sender: str = "") -> bool:
        """Index an already-pooled blob as chunk ``idx`` (the manifest
        told us its hash) — the resumable-fetch fast path."""
        with self._mu:
            if self._closed or idx in self._hashes:
                return False
        if not self._pool.acquire(h):
            return False
        with self._mu:
            if self._closed or idx in self._hashes:
                self._pool.release(h)
                return False
            self._hashes[idx] = h
            self._senders[idx] = sender
        return True

    def _release_locked(self, idx: int) -> bytes | None:
        self._senders.pop(idx, None)
        return self._hashes.pop(idx, None)

    def pop(self, idx: int, default=None):
        with self._mu:
            if idx not in self._senders:
                return default
            sender = self._senders[idx]
            h = self._release_locked(idx)
        if h is not None:
            self._pool.release(h)
        return sender

    def pop_if_sender(self, idx: int, sender: str) -> bool:
        """Atomically remove chunk ``idx`` ONLY if it still came from
        ``sender`` — the banned-mid-write guard must not delete a fresh
        replacement a good peer just spooled over it."""
        with self._mu:
            if self._senders.get(idx) != sender:
                return False
            h = self._release_locked(idx)
        if h is not None:
            self._pool.release(h)
        return True

    def indices_from(self, sender: str) -> list[int]:
        return [i for i, s in self._senders.items() if s == sender]

    def clear(self) -> None:
        for idx in list(self._senders):
            self.pop(idx)

    def close(self) -> None:
        with self._mu:
            self._closed = True
            self._senders.clear()
            hashes = list(self._hashes.values())
            self._hashes.clear()
        for h in hashes:
            self._pool.release(h)
        if self._owns_pool:
            self._pool.close()


class Syncer:
    MAX_CHUNK_RETRIES = 3

    def __init__(self, app_conns, state_provider: StateProvider,
                 reactor=None, name: str = "syncer", *,
                 chunk_timeout: float = CHUNK_TIMEOUT,
                 max_inflight_per_peer: int = MAX_INFLIGHT_PER_PEER,
                 discovery_time: float = DISCOVERY_TIME,
                 discovery_rounds: int = DISCOVERY_ROUNDS,
                 chunk_retries: int = MAX_CHUNK_RETRIES,
                 spool_retain_bytes: int = SPOOL_RETAIN_BYTES,
                 in_memory_spool: bool = False):
        self.app_conns = app_conns
        self.provider = state_provider
        self.reactor = reactor
        self.name = name
        self.log = tmlog.logger("statesync", node=name)
        self.chunk_timeout = float(chunk_timeout)
        self.max_inflight_per_peer = int(max_inflight_per_peer)
        self.discovery_time = float(discovery_time)
        self.discovery_rounds = int(discovery_rounds)
        self.chunk_retries = int(chunk_retries)
        self._snapshots: dict[tuple, _PendingSnapshot] = {}
        self._pool = _BlobPool(in_memory=in_memory_spool,
                               retain_bytes=spool_retain_bytes)
        self._sync_spool = bool(in_memory_spool)   # write inline (sim)
        self._chunks = _ChunkStore(pool=self._pool)
        self._banned: set[str] = set()   # rejected / corrupting senders
        self._m = _ss_metrics()
        # plain-int mirrors of the statesync_* counters: the sim lab
        # reads per-NODE tallies, which process-wide metrics can't give
        self.tallies: dict[str, int] = {
            "chunks_verified": 0, "chunk_hash_mismatches": 0,
            "chunks_dedup": 0, "chunks_resumed": 0,
            "restore_resets": 0, "senders_banned": 0,
            "slow_strikes": 0}
        self._chunk_event = asyncio.Event()
        self._current: _PendingSnapshot | None = None
        self._manifest: list[bytes] | None = None   # per-chunk sha256
        self._manifest_box: list[bytes] | None = None
        self._manifest_event = asyncio.Event()
        self._expect_root: bytes | None = None
        self._fatal: StatesyncFatalError | None = None
        self._refetch: set[int] = set()  # verification-failed indices
        # per-peer slow strikes (request age-outs): slow peers are
        # deprioritized and reported at low weight — NOT banned, which
        # is reserved for provably bad bytes
        self._timeouts: dict[str, int] = {}
        # the event loop holds only weak refs to tasks; spool writes must
        # stay strongly referenced until done or they can be GC'd mid-write
        self._spool_tasks: set[asyncio.Task] = set()

    # ------------------------------------------------ reactor callbacks

    def add_snapshot(self, peer_id: str, snapshot,
                     manifest_root: bytes | None = None) -> None:
        key = (snapshot.height, snapshot.format, snapshot.hash)
        if peer_id in self._banned:
            return      # snapshots.go RejectPeer: bans outlive rounds
        pending = self._snapshots.setdefault(key,
                                             _PendingSnapshot(snapshot))
        if peer_id not in pending.peers:
            pending.peers.append(peer_id)
        if isinstance(manifest_root, (bytes, bytearray)) and manifest_root:
            pending.manifest_roots[peer_id] = bytes(manifest_root)

    def add_manifest(self, peer_id: str, height: int, format_: int,
                     snapshot_hash: bytes, hashes) -> None:
        """A ``mres`` hash list: verified against the offer-advertised
        root before it becomes THE manifest for the current restore."""
        cur = self._current
        if cur is None or self._expect_root is None or \
                cur.snapshot.height != height or \
                cur.snapshot.format != format_ or \
                snapshot_hash != cur.snapshot.hash:
            return      # stale / unsolicited manifest: drop
        if not valid_hash_list(cur.snapshot.hash, hashes,
                               cur.snapshot.chunks, self._expect_root):
            self.log.warn("manifest failed verification",
                          peer=peer_id[:8], height=height)
            self._note_sender_banned(
                peer_id, detail="manifest does not match its root")
            self.remove_peer(peer_id)
            self._manifest_box = None
            self._manifest_event.set()   # wake negotiation: next holder
            return
        self._manifest_box = [bytes(x) for x in hashes]
        self._manifest_event.set()

    def add_chunk(self, peer_id: str, height: int, format_: int,
                  index: int, chunk: bytes, snapshot_hash: bytes = b""
                  ) -> None:
        cur = self._current
        if cur is None or cur.snapshot.height != height or \
                cur.snapshot.format != format_ or \
                snapshot_hash != cur.snapshot.hash:
            return      # stale response from another snapshot: drop
        # the index comes off the WIRE and becomes a spool filename:
        # anything but an in-range int is malicious or corrupt
        if not isinstance(index, int) or isinstance(index, bool) or \
                not 0 <= index < cur.snapshot.chunks:
            self.log.warn("dropping chunk with invalid index",
                          peer=peer_id[:8], index=repr(index)[:40])
            return
        if peer_id in self._banned:
            return      # late delivery from a sender the app rejected
        if not isinstance(chunk, (bytes, bytearray)):
            return
        if self._manifest is not None:
            # content check BEFORE the spool (the whole point of the
            # manifest): bad bytes ban the sender and re-request THIS
            # chunk from another holder — the restore never resets
            if hashlib.sha256(bytes(chunk)).digest() != \
                    self._manifest[index]:
                self._m.hash_mismatches.inc(node=self.name)
                self.tallies["chunk_hash_mismatches"] += 1
                self.log.warn("chunk hash mismatch; banning sender",
                              peer=peer_id[:8], index=index)
                self._note_sender_banned(
                    peer_id, detail=f"chunk {index} hash mismatch")
                self.remove_peer(peer_id)
                self._refetch.add(index)
                self._chunk_event.set()
                return
            self._m.chunks_verified.inc(node=self.name)
            self.tallies["chunks_verified"] += 1
        if self._sync_spool:
            # deterministic-sim mode: the pool is in memory, so the
            # write is cheap and MUST stay on the loop (executor
            # completion order is real-time nondeterminism)
            try:
                self._spool_write(self._chunks, index, bytes(chunk),
                                  peer_id)
            except OSError as e:
                self._spool_failed(index, e)
                return
            self._chunk_event.set()
            return
        # spool write off the event loop: a multi-GB snapshot's chunks
        # must not stall consensus/p2p on disk IO.  The store ref is
        # captured so a write landing after a snapshot switch goes to the
        # (closed, write-refusing) OLD store, never the new one.
        store = self._chunks

        async def _spool():
            try:
                await asyncio.to_thread(
                    self._spool_write, store, index, bytes(chunk), peer_id)
            except OSError as e:
                self._spool_failed(index, e)
                return
            if self._chunks is not store:
                return                   # snapshot switched mid-write
            if peer_id in self._banned:
                # banned while the write was in flight: the purge already
                # ran, so the late insert must not resurrect poison (but
                # only OUR chunk — never a good peer's fresh replacement).
                # Flag the index for immediate re-request instead of
                # letting its stale `requested` entry age out.
                if store.pop_if_sender(index, peer_id):
                    self._refetch.add(index)
                self._chunk_event.set()
                return
            self._chunk_event.set()

        aio.spawn(_spool(), self._spool_tasks)

    def _spool_write(self, store: _ChunkStore, index: int, data: bytes,
                     peer_id: str) -> None:
        fired = failures.fire("statesync.spool.enospc", node=self.name)
        if fired is not None:
            raise OSError(errno.ENOSPC,
                          "injected: no space left on device")
        before = self._pool.dedup_hits
        store[index] = (data, peer_id)
        gained = self._pool.dedup_hits - before
        if gained:
            self._m.chunks_dedup.inc(gained, node=self.name)
            self.tallies["chunks_dedup"] += gained

    def _spool_failed(self, index: int, e: OSError) -> None:
        """Satellite of the fsyncgate discipline: a full/dead disk must
        surface as a DISK problem that fails the sync, not decay into a
        misleading fetch timeout."""
        if _is_fatal_io_error(e):
            self._m.spool_fatal.inc(node=self.name)
            self._fatal = StatesyncFatalError(
                f"chunk spool hit fatal IO error "
                f"({errno.errorcode.get(e.errno, e.errno)}): {e}")
            self.log.error("fatal chunk-spool IO error; failing sync",
                           index=index, err=repr(e))
            self._chunk_event.set()      # wake the fetch loop NOW
            return
        self.log.error("chunk spool write failed", index=index,
                       err=repr(e))

    def remove_peer(self, peer_id: str) -> None:
        for pending in self._snapshots.values():
            if peer_id in pending.peers:
                pending.peers.remove(peer_id)
        cur = self._current
        if cur is not None and peer_id in cur.peers:
            cur.peers.remove(peer_id)

    def _note_sender_banned(self, peer_id: str,
                            detail: str = "app rejected snapshot sender"
                            ) -> None:
        """One bad sender: count it (a stalled sync must be diagnosable
        from /metrics) and feed the p2p peer-quality scorer so the node
        drops/bans the peer node-wide, not just for this sync."""
        self._banned.add(peer_id)
        self._m.senders_banned.inc(node=self.name)
        self.tallies["senders_banned"] += 1
        sw = getattr(self.reactor, "switch", None) \
            if self.reactor is not None else None
        if sw is not None and hasattr(sw, "report_peer"):
            try:
                sw.report_peer(peer_id, "bad_snapshot_chunk",
                               detail=detail, disconnect=True)
            except Exception:
                pass

    def _note_slow_peer(self, peer_id: str) -> None:
        """A request age-out: slow, not (provably) evil.  Deprioritized
        in the fetch rotation and reported at low weight so persistent
        molasses eventually costs the peer its slot — but one hiccup
        never bans a peer the way bad bytes do."""
        self._timeouts[peer_id] = self._timeouts.get(peer_id, 0) + 1
        self.tallies["slow_strikes"] += 1
        sw = getattr(self.reactor, "switch", None) \
            if self.reactor is not None else None
        if sw is not None and hasattr(sw, "report_peer"):
            try:
                sw.report_peer(peer_id, "snapshot_timeout",
                               detail="chunk request aged out")
            except Exception:
                pass

    # ------------------------------------------------------------- sync

    async def sync(self, discovery_time: float | None = None,
                   rounds: int | None = None):
        """syncer.go SyncAny: returns (state, commit) for the restored
        height.  Raises StatesyncError when no snapshot can be restored.

        Discovery repeats per round with a FRESH offer pool: peers prune
        old snapshots as the chain advances, so offers must be recent
        relative to the fetch or the chunks will be gone by the time they
        are requested (the reference's retryHook re-requests snapshots
        for the same reason)."""
        if discovery_time is None:
            discovery_time = self.discovery_time
        if rounds is None:
            rounds = self.discovery_rounds
        rejected_formats: set[int] = set()   # REJECT_FORMAT is final
        try:
            return await self._sync_rounds(discovery_time, rounds,
                                           rejected_formats)
        finally:
            # success closed it already (idempotent); this covers the
            # all-rounds-exhausted raise, whose spool would otherwise
            # leak GBs in the temp dir for the process lifetime
            self._chunks.close()
            self._pool.close()

    async def _sync_rounds(self, discovery_time: float, rounds: int,
                           rejected_formats: set):
        for round_ in range(rounds):
            self._snapshots.clear()
            if self.reactor is not None:
                self.reactor.broadcast_snapshot_request()
            await clock.sleep(discovery_time)
            tried: set = set()
            while True:
                best = self._best_snapshot(tried, rejected_formats)
                if best is None:
                    break                    # pool exhausted: re-discover
                tried.add((best.snapshot.height, best.snapshot.format,
                           best.snapshot.hash))
                try:
                    return await self._restore(best)
                except StatesyncFatalError:
                    raise                    # dead disk: no more rounds
                except _RejectFormat:
                    # syncer.go:208 — skip every snapshot of this format
                    rejected_formats.add(best.snapshot.format)
                    self._m.formats_rejected.inc(node=self.name)
                    self.log.warn("snapshot format rejected",
                                  format=best.snapshot.format)
                except _RejectSender:
                    # syncer.go:212 — distrust every peer advertising it
                    banned = list(best.peers)
                    for p in banned:
                        self._note_sender_banned(p)
                        self.remove_peer(p)
                    self.log.warn("snapshot senders rejected",
                                  peers=len(banned))
                except StatesyncError as e:
                    self.log.warn("snapshot restore failed; trying next",
                                  height=best.snapshot.height, err=str(e))
        raise StatesyncError(f"no viable snapshots after {rounds} rounds")

    def _best_snapshot(self, tried: set,
                       rejected_formats: set | None = None
                       ) -> _PendingSnapshot | None:
        candidates = [p for k, p in self._snapshots.items()
                      if k not in tried and p.peers
                      and p.snapshot.format not in (rejected_formats or ())]
        if not candidates:
            return None
        return max(candidates, key=lambda p: p.snapshot.height)

    async def _restore(self, pending: _PendingSnapshot):
        snapshot = pending.snapshot
        h = snapshot.height
        self.log.info("restoring snapshot", height=h,
                      chunks=snapshot.chunks)

        # trusted app hash from the light client (syncer.go verifyApp prep)
        try:
            trusted_app_hash = await self.provider.app_hash(h)
        except Exception as e:
            raise StatesyncError(f"cannot verify snapshot height: {e}")

        resp = await self.app_conns.snapshot.offer_snapshot(
            snapshot, trusted_app_hash)
        if resp == abci.OFFER_SNAPSHOT_REJECT_FORMAT:
            raise _RejectFormat(f"format {snapshot.format}")
        if resp == abci.OFFER_SNAPSHOT_REJECT_SENDER:
            raise _RejectSender("providers rejected")
        if resp != abci.OFFER_SNAPSHOT_ACCEPT:
            raise StatesyncError(f"app rejected snapshot ({resp})")

        self._current = pending
        # a FRESH index per attempt (late async writes land in the old,
        # closed store) over the SHARED blob pool — so chunks fetched by
        # a failed attempt are adopted below instead of re-transferred
        self._chunks.close()
        self._chunks = _ChunkStore(pool=self._pool)
        # NOTE: self._banned persists across snapshots — a sender the
        # app rejected once stays distrusted for the whole sync
        try:
            self._manifest = await self._obtain_manifest(pending)
            if self._manifest is not None:
                resumed = 0
                for i, ch in enumerate(self._manifest):
                    if self._chunks.adopt(i, ch):
                        resumed += 1
                if resumed:
                    self._m.chunks_resumed.inc(resumed, node=self.name)
                    self.tallies["chunks_resumed"] += resumed
                    self.log.info("resumed chunks from spool",
                                  resumed=resumed, total=snapshot.chunks)
                    self._chunk_event.set()
            await self._fetch_and_apply(pending)
        finally:
            self._current = None
            self._manifest = None

        # the app must now report the snapshot height + trusted hash
        # (syncer.go verifyApp)
        info = await self.app_conns.query.info()
        if info.last_block_height != h:
            raise StatesyncError(
                f"app restored to height {info.last_block_height}, "
                f"expected {h}")
        if info.last_block_app_hash != trusted_app_hash:
            raise StatesyncError("app hash mismatch after restore")

        try:
            state = await self.provider.state(h)
            commit = await self.provider.commit(h)
        except Exception as e:
            # e.g. the chain hasn't reached h+2 yet so the light client
            # cannot assemble the post-h state: a retryable condition,
            # not a fatal one
            raise StatesyncError(f"cannot build state at {h}: {e}")
        self._chunks.close()          # spool freed; lazily recreated
        self.log.info("snapshot restored", height=h)
        return state, commit

    async def _obtain_manifest(self, pending: _PendingSnapshot
                               ) -> list[bytes] | None:
        """Negotiate the chunk manifest for this snapshot.  The root is
        taken from the LARGEST agreeing set of offering peers
        (deterministic tie-break on the digest); the hash list is then
        fetched from those peers and verified against the root.  Peers
        that advertised no root (legacy protocol) contribute nothing
        here but still serve chunks — which ARE verified when a
        manifest exists.  Returns None only when nobody advertised a
        root at all (pure-legacy restore, unverified as before)."""
        snapshot = pending.snapshot
        roots: dict[bytes, list[str]] = {}
        for p, r in pending.manifest_roots.items():
            if p in self._banned or p not in pending.peers:
                continue
            roots.setdefault(r, []).append(p)
        if not roots or self.reactor is None:
            return None
        root, holders = max(roots.items(),
                            key=lambda kv: (len(kv[1]), kv[0]))
        self._expect_root = root
        try:
            for peer in list(holders):
                if peer in self._banned or peer not in pending.peers:
                    continue
                self._manifest_box = None
                self._manifest_event.clear()
                if not self.reactor.request_manifest(
                        peer, snapshot.height, snapshot.format,
                        snapshot.hash):
                    continue
                try:
                    await clock.wait_for(self._manifest_event.wait(),
                                         self.chunk_timeout)
                except asyncio.TimeoutError:
                    self._note_slow_peer(peer)
                    continue
                if self._manifest_box is not None:
                    return self._manifest_box
                # verification failed inside add_manifest (peer banned
                # there): fall through to the next holder
            raise StatesyncError("no advertised manifest could be "
                                 "fetched and verified")
        finally:
            self._expect_root = None
            self._manifest_box = None

    async def _fetch_and_apply(self, pending) -> None:
        snapshot = pending.snapshot
        applied: set[int] = set()
        requested: dict[int, tuple[float, str]] = {}  # chunk -> (t, peer)
        retries: dict[int, int] = {}
        next_peer = 0
        timeout = self.chunk_timeout
        last_progress = clock.monotonic()
        while len(applied) < snapshot.chunks:
            if self._fatal is not None:
                raise self._fatal
            # a verification failure freed its request slot: re-request
            # immediately from another holder instead of waiting for
            # the age-out
            if self._refetch:
                for i in list(self._refetch):
                    requested.pop(i, None)
                self._refetch.clear()
            # request chunks that were never requested or whose request
            # timed out — NOT everything missing on every wakeup, which
            # would re-transfer in-flight chunks O(n^2).  Each peer holds
            # at most max_inflight_per_peer outstanding requests, so
            # restore bandwidth scales with serving peers instead of
            # flooding one.
            now = clock.monotonic()
            inflight: dict[str, int] = {}
            for i, (t, peer) in requested.items():
                # an assignment consumes its peer's budget until the
                # chunk arrives OR the chunk is re-requested elsewhere
                # (which overwrites requested[i]) — aging it out earlier
                # would let a slow-but-alive peer accumulate 2x the cap
                if i not in self._chunks and i not in applied:
                    inflight[peer] = inflight.get(peer, 0) + 1
            # slow peers drift to the back of the rotation (stable sort:
            # with no strikes this IS the plain round-robin order)
            peers = sorted(pending.peers,
                           key=lambda p: self._timeouts.get(p, 0))
            for i in range(snapshot.chunks):
                if i in self._chunks or i in applied:
                    continue
                prev = requested.get(i)
                if prev is not None and now - prev[0] < timeout / 2:
                    continue
                if prev is not None:
                    # the previous holder sat on it: strike it as slow
                    self._note_slow_peer(prev[1])
                if not pending.peers:
                    raise StatesyncError("no peers serving the snapshot")
                # next peer with spare in-flight budget (round-robin)
                peer = None
                for _ in range(len(peers)):
                    cand = peers[next_peer % len(peers)]
                    next_peer += 1
                    if inflight.get(cand, 0) < self.max_inflight_per_peer:
                        peer = cand
                        break
                if peer is None:
                    break           # every peer's pipe is full this round
                inflight[peer] = inflight.get(peer, 0) + 1
                requested[i] = (now, peer)
                if self.reactor is not None:
                    self.reactor.request_chunk(peer, snapshot.height,
                                               snapshot.format, i,
                                               snapshot.hash)
            # wake on new chunks OR periodically: an in-flight async
            # spool whose sender was banned mid-write leaves a stuck
            # `requested` entry that only the age-out re-request path
            # clears, so the loop must re-evaluate before the full
            # timeout.  The timeout itself is PROGRESS-based (any chunk
            # arrival or apply resets it).
            try:
                await clock.wait_for(self._chunk_event.wait(),
                                     timeout / 4)
                self._chunk_event.clear()
                last_progress = clock.monotonic()
            except asyncio.TimeoutError:
                if clock.monotonic() - last_progress > timeout:
                    raise StatesyncError("timed out fetching chunks")
            if self._fatal is not None:
                raise self._fatal

            # apply in STRICT index order (the ABCI restore contract —
            # reference chunks.Next() blocks for the next sequential
            # index); later chunks wait in self._chunks until their turn
            while len(applied) in self._chunks:
                i = len(applied)
                data, sender = self._chunks[i]
                resp = await self.app_conns.snapshot.apply_snapshot_chunk(
                    i, data, sender)
                if isinstance(resp, int):   # bare-status app shorthand
                    resp = abci.ApplySnapshotChunkResponse(result=resp)

                # syncer.go:438 — the app can name bad senders and ask
                # for specific chunks again regardless of the result
                for bad in resp.reject_senders:
                    self._note_sender_banned(bad)
                    if bad in pending.peers:
                        pending.peers.remove(bad)
                    # chunks.DiscardSender: everything unapplied from the
                    # rejected sender is poisoned — spooled chunks AND
                    # in-flight requests (freeing the slot re-requests
                    # from an honest peer on the next loop pass)
                    for j in self._chunks.indices_from(bad):
                        self._chunks.pop(j)
                        requested.pop(j, None)
                    for j, (_, p) in list(requested.items()):
                        if p == bad:
                            requested.pop(j, None)
                    self.log.warn("banned snapshot sender", peer=bad)

                full_reset = resp.result == abci.APPLY_CHUNK_RETRY
                for j in resp.refetch_chunks:
                    if j < len(applied):
                        # an already-applied chunk cannot be re-applied
                        # mid-stream (the restore is strictly sequential):
                        # discard all progress, like RETRY
                        full_reset = True
                    self._chunks.pop(j, None)
                    requested.pop(j, None)

                bump_retry = full_reset or i in resp.refetch_chunks
                if bump_retry:
                    retries[i] = retries.get(i, 0) + 1
                    if retries[i] > self.chunk_retries:
                        raise StatesyncError(
                            f"chunk {i} refused {retries[i]} times")
                if full_reset:
                    # the app discarded its accumulated restore progress
                    # (e.g. whole-snapshot hash mismatch): refetch all.
                    # With a manifest active this path should be DEAD —
                    # corrupt bytes never reach the app — so the counter
                    # doubles as a fabric-regression alarm.
                    self._m.restore_resets.inc(node=self.name)
                    self.tallies["restore_resets"] += 1
                    applied.clear()
                    self._chunks.clear()
                    requested.clear()
                    break
                if resp.result == abci.APPLY_CHUNK_ACCEPT:
                    if i in resp.refetch_chunks:
                        break   # app wants this very chunk again: not
                                # applied; the outer loop re-requests it
                    applied.add(i)
                    self._chunks.pop(i)   # applied: free its spool ref
                else:
                    raise StatesyncError(
                        f"app aborted on chunk {i} ({resp.result})")


# re-exported for callers that bind the helper from this module
__all__ = ["Syncer", "StatesyncError", "StatesyncFatalError",
           "CHUNK_TIMEOUT", "MAX_INFLIGHT_PER_PEER", "DISCOVERY_TIME",
           "DISCOVERY_ROUNDS", "manifest_root"]
