"""Mempool reactor: transaction gossip (counterpart of
``cometbft_tpu/mempool/reactor.py``; reference: ``mempool/reactor.go:22,
137,198``, the per-peer broadcastTxRoutine walking the clist).  Frames
are packed with the port's MessagePack subset (``types/_msgpack.py``)
into the JAX package's bytes.

Two wire dialects share the mempool channel:

- **full-body** (the original protocol): ``{"txs": [tx, ...]}`` frames.
  Kept as the interop fallback — and upgraded to pack MANY txs per
  msgpack frame up to a byte budget instead of one ``peer.send`` per tx.
- **content-addressed**: peers that greet with ``{"hi": 1}`` get
  announcements ``{"ann": [h, ...]}`` (32-byte tx keys), fetch missing
  bodies with ``{"req": [h, ...]}``, and receive them as ``{"txs": ...}``
  frames.  A tx the peer already holds (it announced it, sent it, or we
  saw their announce) costs 32 bytes on the wire instead of the body —
  the verified-vote dedup idea applied to tx gossip.

A reactor that never sends ``hi`` (an older peer, or
``gossip_mode="full"``) keeps receiving full bodies: an old peer's
``receive`` reads ``d.get("txs", [])`` and silently ignores the new
keys, so mixed-version nets interoperate without negotiation.

Fetch discipline: one in-flight request per tx key, tracked with a
deadline; on timeout the key is re-requested from another announcer (and
the timeout counted).  Fetched bodies that fail CheckTx score
``invalid_tx`` on the sender through the peer scorer —
announcing garbage does not become a free amplification channel.

The per-tx bookkeeping maps (``_senders``, ``_announcers``) are bounded
and pruned on every mempool update/removal via
``mempool.on_txs_removed`` — entries used to pin a set per gossiped tx
forever."""

from __future__ import annotations

import asyncio
import functools

from ..libs import aio, clock
from ..p2p.reactor import ChannelDescriptor, Reactor
from .clist_mempool import CListMempool, MempoolFullError, TxRejectedError
from ..types import _msgpack
from .mempool import TxKey

MEMPOOL_CHANNEL = 0x30
GOSSIP_SLEEP = 0.02
TX_KEY_LEN = 32
ANN_BATCH = 512                  # hashes per announce frame (16 KiB)
DEFAULT_BATCH_BYTES = 64 * 1024  # full-body / fetch-response frame budget
DEFAULT_FETCH_TIMEOUT_S = 2.0
SENT_SET_BOUND = 10000


@functools.cache
def _reactor_metrics():
    from ..libs import metrics as _m

    return (
        _m.counter(
            "mempool_gossip_full_skips_total",
            "gossiped txs dropped WITHOUT CheckTx because the mempool "
            "was full (backpressure: a full pool must not buy every "
            "flooded tx an app round-trip)"),
        _m.counter("mempool_announce_total",
                   "tx hashes announced to peers"),
        _m.counter("mempool_announce_dedup_total",
                   "announced hashes we already held (bodies NOT "
                   "re-fetched: the content-addressing win)"),
        _m.counter("mempool_fetch_requests_total",
                   "tx bodies requested from an announcer"),
        _m.counter("mempool_fetch_fulfilled_total",
                   "requested tx bodies that arrived"),
        _m.counter("mempool_fetch_timeouts_total",
                   "fetch requests that timed out (re-requested from "
                   "another announcer when one is known)"),
        _m.counter("mempool_gossip_bytes_total",
                   "mempool-channel payload bytes sent, by kind "
                   "(ann/req/body)"),
    )


class _Fetch:
    """One in-flight body fetch: who we asked, when it expires, who we
    already tried (timeout -> re-request from a fresh announcer)."""

    __slots__ = ("peer_id", "deadline", "tried")

    def __init__(self, peer_id: str, deadline: float):
        self.peer_id = peer_id
        self.deadline = deadline
        self.tried: set[str] = {peer_id}


class MempoolReactor(Reactor):
    def __init__(self, mempool: CListMempool,
                 gossip_sleep: float = GOSSIP_SLEEP,
                 gossip_mode: str = "announce",
                 fetch_timeout_s: float = DEFAULT_FETCH_TIMEOUT_S,
                 batch_bytes: int = DEFAULT_BATCH_BYTES):
        super().__init__()
        self.mempool = mempool
        self.gossip_sleep = gossip_sleep
        self.gossip_mode = gossip_mode
        self.fetch_timeout_s = max(0.05, float(fetch_timeout_s))
        self.batch_bytes = max(1024, int(batch_bytes))
        self._peer_tasks: dict[str, asyncio.Task] = {}
        # tx hash -> set of peer ids KNOWN to hold the tx (sent it to us
        # or announced it): dedup/no-echo.  Bounded; pruned on removal.
        self._senders: dict[bytes, set[str]] = {}
        # tx hash -> announcers we have NOT fetched from yet (candidates
        # for timeout re-request).  Bounded; entries die on admission.
        self._announcers: dict[bytes, set[str]] = {}
        self._requests: dict[bytes, _Fetch] = {}     # in-flight fetches
        self._capable: set[str] = set()   # peers speaking announce/fetch
        self._sweep_task: asyncio.Task | None = None
        # bookkeeping bound: ~2 pools' worth of keys, floored so tiny
        # test pools don't thrash
        self._map_bound = max(4096, 2 * getattr(mempool, "max_txs", 5000))
        (self._m_full_skips, self._m_ann, self._m_dedup, self._m_req,
         self._m_fulfilled, self._m_timeouts, bytes_c) = _reactor_metrics()
        self._b_ann = bytes_c.bind(kind="ann")
        self._b_req = bytes_c.bind(kind="req")
        self._b_body = bytes_c.bind(kind="body")
        # per-INSTANCE tallies: the metrics registry is process-global
        # (scenario verdicts must be a pure function of the run, and a
        # bench must not read a previous node's totals)
        self.tallies = {"full_skips": 0, "announced": 0, "ann_dedup": 0,
                        "fetch_requests": 0, "fetch_fulfilled": 0,
                        "fetch_timeouts": 0, "bytes_ann": 0,
                        "bytes_req": 0, "bytes_body": 0}
        mempool.on_txs_removed = self._on_txs_removed

    def get_channels(self):
        return [ChannelDescriptor(MEMPOOL_CHANNEL, priority=5,
                                  send_queue_capacity=128, name="mempool")]

    # ------------------------------------------------------------ lifecycle

    def add_peer(self, peer) -> None:
        if self.gossip_mode == "announce":
            # capability hello: an old reactor reads d.get("txs", [])
            # and ignores this; a new one marks us announce-capable
            peer.send(MEMPOOL_CHANNEL,
                      _msgpack.packb({"hi": 1}))
        self._peer_tasks[peer.id] = asyncio.create_task(
            self._broadcast_tx_routine(peer))
        if self._sweep_task is None:
            self._sweep_task = aio.spawn(self._sweep_requests())

    def remove_peer(self, peer, reason=None) -> None:
        task = self._peer_tasks.pop(peer.id, None)
        if task is not None:
            task.cancel()
        self._capable.discard(peer.id)

    async def stop(self) -> None:
        for task in self._peer_tasks.values():
            task.cancel()
        self._peer_tasks.clear()
        if self._sweep_task is not None:
            self._sweep_task.cancel()
            self._sweep_task = None

    # ------------------------------------------------------------- pruning

    def _on_txs_removed(self, keys: list[bytes]) -> None:
        """Mempool update/flush removed txs: drop their gossip
        bookkeeping (the map entries used to live forever)."""
        for key in keys:
            self._senders.pop(key, None)
            self._announcers.pop(key, None)

    def _bounded_add(self, mapping: dict[bytes, set[str]], key: bytes,
                     peer_id: str) -> None:
        s = mapping.get(key)
        if s is None:
            while len(mapping) >= self._map_bound:
                # FIFO eviction — but never a key still IN THE POOL: its
                # no-echo entry is load-bearing (without it the routine
                # re-sends the tx to the peer that delivered it, exactly
                # under a junk-announce storm).  Live keys rotate to the
                # back instead; they are pruned on removal anyway, and
                # live keys < pool size < the bound, so a non-live entry
                # always exists.
                old = next(iter(mapping))
                if self.mempool.get_tx(old) is None:
                    mapping.pop(old)
                else:
                    mapping[old] = mapping.pop(old)
            mapping[key] = s = set()
        s.add(peer_id)

    def _send_req(self, peer, keys: list[bytes]) -> bool:
        """Send fetch frames (chunked at ANN_BATCH keys so one frame can
        never breach the channel's message-size limit) and install/
        refresh the in-flight tracking + counters for every key sent —
        the ONE copy of this bookkeeping: announce, timeout-retry, and
        backlog sweep all route here."""
        any_sent = False
        for lo in range(0, len(keys), ANN_BATCH):
            part = keys[lo:lo + ANN_BATCH]
            frame = _msgpack.packb({"req": part})
            if not peer.send(MEMPOOL_CHANNEL, frame):
                break                   # queue full: the sweeper retries
            any_sent = True
            deadline = clock.monotonic() + self.fetch_timeout_s
            for h in part:
                fr = self._requests.get(h)
                if fr is None:
                    self._requests[h] = _Fetch(peer.id, deadline)
                else:
                    fr.peer_id = peer.id
                    fr.tried.add(peer.id)
                    fr.deadline = deadline
            self._m_req.inc(len(part))
            self.tallies["fetch_requests"] += len(part)
            self._b_req.inc(len(frame))
            self.tallies["bytes_req"] += len(frame)
        return any_sent

    # -------------------------------------------------------------- receive

    def receive(self, channel_id: int, peer, msg: bytes) -> None:
        d = _msgpack.unpackb(msg)
        if "hi" in d:
            self._capable.add(peer.id)
        ann = d.get("ann")
        if ann:
            self._on_announce(peer, ann)
        req = d.get("req")
        if req:
            self._on_request(peer, req)
        txs = d.get("txs", [])
        if txs:
            self._on_bodies(peer, txs)

    def _on_announce(self, peer, hashes) -> None:
        """Peer holds these txs.  Fetch the ones we miss (one in-flight
        request per key); remember every announcer for no-echo and for
        timeout re-requests."""
        self._capable.add(peer.id)
        want: list[bytes] = []
        seen: set[bytes] = set()         # dedup WITHIN the frame too: a
        # repeated hash must not inflate req bytes or the fetch counters
        full = self.mempool.is_full()    # BOTH capacity axes (bytes too)
        # intake cap (like _on_request): one fat announce frame must not
        # install tens of thousands of _Fetch entries in one call
        for h in hashes[:2 * ANN_BATCH]:
            if not isinstance(h, bytes) or len(h) != TX_KEY_LEN \
                    or h in seen:
                continue
            seen.add(h)
            self._bounded_add(self._senders, h, peer.id)
            if self.mempool.get_tx(h) is not None or self.mempool.cache.has(h):
                self._m_dedup.inc()
                self.tallies["ann_dedup"] += 1
                continue
            self._bounded_add(self._announcers, h, peer.id)
            if h in self._requests:
                continue                 # already fetching from someone
            if full:
                # overload shedding: a full pool must not buy a flooded
                # announcement a fetch round-trip it would drop anyway
                self._m_full_skips.inc(
                    node=getattr(self.mempool, "_m_node", ""))
                self.tallies["full_skips"] += 1
                continue
            want.append(h)
        if want:
            self._send_req(peer, want)

    def _on_request(self, peer, hashes) -> None:
        """Serve fetches from the pool, packing bodies up to the frame
        budget.  Deduped and capped per frame: a request repeating one
        hash of a big pooled tx must not buy len(req) copies of the
        body (amplification), only one."""
        batch: list[bytes] = []
        size = 0
        seen: set[bytes] = set()
        for h in hashes[:2 * ANN_BATCH]:
            if not isinstance(h, bytes) or h in seen:
                continue
            seen.add(h)
            tx = self.mempool.get_tx(h)
            if tx is None:
                continue                 # gone (committed/evicted): the
                #   requester's timeout re-request handles it
            if batch and size + len(tx) > self.batch_bytes:
                self._send_bodies(peer, batch)
                batch, size = [], 0
            batch.append(tx)
            size += len(tx)
        if batch:
            self._send_bodies(peer, batch)

    def _send_bodies(self, peer, txs: list[bytes]) -> bool:
        frame = _msgpack.packb({"txs": txs})
        ok = peer.send(MEMPOOL_CHANNEL, frame)
        if ok:
            self._b_body.inc(len(frame))
            self.tallies["bytes_body"] += len(frame)
        return ok

    def _on_bodies(self, peer, txs) -> None:
        if self.mempool.is_full():
            # overload shedding: a full mempool drops gossiped txs at
            # the door instead of spawning a CheckTx app round-trip per
            # tx just to learn "mempool is full" (RPC submitters still
            # get the explicit rejection)
            self._m_full_skips.inc(len(txs),
                                   node=getattr(self.mempool, "_m_node", ""))
            self.tallies["full_skips"] += len(txs)
            for tx in txs:
                self._requests.pop(TxKey(tx), None)
            return
        for tx in txs:
            key = TxKey(tx)
            self._bounded_add(self._senders, key, peer.id)
            fr = self._requests.pop(key, None)
            if fr is not None:
                self._m_fulfilled.inc()
                self.tallies["fetch_fulfilled"] += 1
            self._announcers.pop(key, None)
            aio.spawn(self._check_tx(tx, peer.id))

    async def _check_tx(self, tx: bytes, peer_id: str = "") -> None:
        try:
            await self.mempool.check_tx(tx)
        except MempoolFullError:
            pass        # our capacity problem, not the sender's
        except TxRejectedError as e:
            # app-rejected gossip is (feather-weight) peer misbehavior —
            # this covers FETCHED bodies too: announcing garbage and
            # serving it on request scores exactly like pushing it
            if peer_id and self.switch is not None and \
                    hasattr(self.switch, "report_peer"):
                self.switch.report_peer(peer_id, "invalid_tx",
                                        detail=e.log[:80])
        except Exception:
            pass

    # ---------------------------------------------------------- fetch sweep

    async def _sweep_requests(self) -> None:
        """One reactor-wide timer: expire overdue fetches and re-request
        from another announcer (a peer that announced but never served
        must not be able to black-hole a tx)."""
        interval = max(0.05, self.fetch_timeout_s / 4)
        while True:
            await clock.sleep(interval)
            # per-TICK error containment: one bad peer.send (half-closed
            # transport, etc.) must not kill the reactor-wide sweeper —
            # with it dead, stale _requests entries block re-fetch of
            # their keys forever (receive skips hashes in _requests)
            try:
                self._sweep_backlog()
                if not self._requests:
                    continue
                now = clock.monotonic()
                expired = [(h, fr) for h, fr in self._requests.items()
                           if fr.deadline <= now]
                for h, fr in expired:
                    self._m_timeouts.inc()
                    self.tallies["fetch_timeouts"] += 1
                    retry = None
                    # sorted: announcer choice must not ride on set hash
                    # order (scenario replay is cross-process too)
                    for pid in sorted(self._announcers.get(h, ())):
                        if pid not in fr.tried and \
                                pid in self._peer_tasks:
                            retry = pid
                            break
                    if retry is None:
                        del self._requests[h]    # re-announce re-arms it
                        self._announcers.pop(h, None)
                        continue
                    peer = self._get_peer(retry)
                    if peer is None or not self._send_req(peer, [h]):
                        del self._requests[h]
            except asyncio.CancelledError:
                raise
            except Exception:
                continue

    def _sweep_backlog(self, cap: int = 256) -> None:
        """Announced keys with NO in-flight request (initial request
        send failed, or the pool was full when the announce arrived):
        fetch them now that there is room.  Bounded per sweep."""
        if not self._announcers or self.mempool.is_full():
            return
        want: list[bytes] = []
        for h in self._announcers:
            if h in self._requests:
                continue
            if self.mempool.get_tx(h) is not None or self.mempool.cache.has(h):
                continue
            want.append(h)
            if len(want) >= cap:
                break
        by_peer: dict[str, tuple[object, list[bytes]]] = {}
        for h in want:
            peer = None
            for pid in sorted(self._announcers.get(h, ())):
                if pid in self._peer_tasks:
                    peer = self._get_peer(pid)
                    if peer is not None:
                        break
            if peer is None:
                self._announcers.pop(h, None)    # no live announcer left
                continue
            by_peer.setdefault(peer.id, (peer, []))[1].append(h)
        for peer, keys in by_peer.values():      # one frame per peer,
            self._send_req(peer, keys)           # not one per key

    def _get_peer(self, peer_id: str):
        sw = self.switch
        if sw is None:
            return None
        return getattr(sw, "peers", {}).get(peer_id)

    # ------------------------------------------------------------ broadcast

    async def _broadcast_tx_routine(self, peer) -> None:
        """Walk the mempool forever (broadcastTxRoutine reactor.go:198).
        To an announce-capable peer: batched hash announcements.  To an
        old-protocol peer: full bodies, MANY per frame up to the byte
        budget (it used to be one tx per ``peer.send``)."""
        sent: set[bytes] = set()
        try:
            if self.gossip_mode == "announce":
                # capability grace: our hello and the peer's cross on
                # the wire, and the first walk racing the peer's "hi"
                # would ship the whole pool as full bodies — the exact
                # re-flood announcing exists to avoid.  A new-protocol
                # peer identifies itself within a round trip; an old
                # one just gets its first bodies a beat later.
                grace = clock.monotonic() + max(0.1, 4 * self.gossip_sleep)
                while peer.id not in self._capable and \
                        clock.monotonic() < grace:
                    await clock.sleep(self.gossip_sleep)
            while True:
                progressed = False
                announce = (self.gossip_mode == "announce"
                            and peer.id in self._capable)
                ann_batch: list[bytes] = []
                body_batch: list[bytes] = []
                body_keys: list[bytes] = []
                body_size = 0
                blocked = False
                for key, tx in self.mempool.items():
                    if key in sent:
                        continue
                    if peer.id in self._senders.get(key, ()):
                        sent.add(key)       # peer already has it
                        continue
                    if announce:
                        ann_batch.append(key)
                        if len(ann_batch) >= ANN_BATCH:
                            if self._send_ann(peer, ann_batch, sent):
                                progressed = True
                            else:
                                blocked = True
                                break
                            ann_batch = []
                    else:
                        if body_batch and \
                                body_size + len(tx) > self.batch_bytes:
                            if self._send_full(peer, body_batch,
                                               body_keys, sent):
                                progressed = True
                            else:
                                blocked = True
                                break
                            body_batch, body_keys, body_size = [], [], 0
                        body_batch.append(tx)
                        body_keys.append(key)
                        body_size += len(tx)
                if not blocked:
                    if ann_batch and self._send_ann(peer, ann_batch, sent):
                        progressed = True
                    if body_batch and self._send_full(peer, body_batch,
                                                      body_keys, sent):
                        progressed = True
                if not progressed:
                    await clock.sleep(self.gossip_sleep)
                # bound the sent-set: drop keys no longer in the mempool
                if len(sent) > SENT_SET_BOUND:
                    live = {k for k, _ in self.mempool.items()}
                    sent &= live
        except asyncio.CancelledError:
            raise
        except Exception:
            pass

    def _send_ann(self, peer, keys: list[bytes], sent: set[bytes]) -> bool:
        frame = _msgpack.packb({"ann": keys})
        if not peer.send(MEMPOOL_CHANNEL, frame):
            return False
        sent.update(keys)
        self._m_ann.inc(len(keys))
        self.tallies["announced"] += len(keys)
        self._b_ann.inc(len(frame))
        self.tallies["bytes_ann"] += len(frame)
        return True

    def _send_full(self, peer, txs: list[bytes], keys: list[bytes],
                   sent: set[bytes]) -> bool:
        if not self._send_bodies(peer, txs):
            return False
        sent.update(keys)
        return True
