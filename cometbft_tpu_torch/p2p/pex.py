"""Peer exchange (PEX) + seed crawling (counterpart of
``cometbft_tpu/p2p/pex.py``; reference: ``p2p/pex/pex_reactor.go``;
channel 0x00 from ``pex_reactor.go:22``).

The address book lives in ``p2p/addrbook.py``: a bucketed
old/new design with hashed placement that bounds how much of the book an
address-flooding peer can touch.  The reactor asks peers for addresses
when connectivity is low and dials newly learned peers, so a node
bootstraps the full mesh from one seed; successful connections promote
entries to the vetted tier (``mark_good``), failed dials count attempts.

Seed crawling (``pex_reactor.go crawlPeersRoutine``): a node in
``seed_mode`` continuously dials book addresses, handshakes, exchanges
address books, and hangs up — it exists to harvest and serve addresses,
not to hold connections.

The messages are the JAX package's MessagePack bytes (``{"@":
"pex_req"}``, ``{"@": "pex_res", "addrs": [{"id", "addr"}, ...]}``),
packed with the port's ``types/_msgpack.py``.  The reactor's jitter and
its choice of a peer to ask come from ``rng`` (a ``random.Random``; a
fresh one by default), where the JAX reactor uses the module ``random``.
"""

from __future__ import annotations

import asyncio
import random

from ..libs import aio, clock
from ..libs import log as tmlog
from ..types import _msgpack
from .addrbook import AddrBook
from .reactor import ChannelDescriptor, Reactor

__all__ = ["AddrBook", "PexReactor", "PEX_CHANNEL"]

PEX_CHANNEL = 0x00
REQUEST_INTERVAL = 30.0          # ensurePeersPeriod (pex_reactor.go)
MAX_ADDRS_PER_RESPONSE = 32
CRAWL_LINGER = 3.0               # seed mode: seconds before hanging up


class PexReactor(Reactor):
    def __init__(self, book: AddrBook, own_id: str,
                 max_outbound: int = 10,
                 request_interval: float = REQUEST_INTERVAL,
                 seed_mode: bool = False,
                 rng: random.Random | None = None):
        super().__init__()
        self.rng = rng if rng is not None else random.Random()
        self.book = book
        self.own_id = own_id
        self.max_outbound = max_outbound
        self.request_interval = request_interval
        self.seed_mode = seed_mode
        self.log = tmlog.logger("pex", node=own_id[:8])
        self._task: asyncio.Task | None = None
        self._dialing: set[str] = set()
        self._requested: set[str] = set()    # peers we asked for addrs
        # strong refs: the loop only weakly references tasks, so hangup
        # timers and dial attempts could be GC'd mid-flight otherwise
        self._bg_tasks: set[asyncio.Task] = set()

    def get_channels(self):
        return [ChannelDescriptor(PEX_CHANNEL, priority=1,
                                  send_queue_capacity=10, name="pex")]

    async def start(self) -> None:
        routine = self._crawl_routine if self.seed_mode \
            else self._ensure_peers_routine
        self._task = asyncio.create_task(routine())

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
        for t in self._bg_tasks:
            t.cancel()
        self.book.save()

    def _spawn(self, coro) -> None:
        aio.spawn(coro, self._bg_tasks)

    def add_peer(self, peer) -> None:
        if peer.outbound:
            # the address WE successfully dialed is proven: record and
            # vet exactly that one (addrbook MarkGood), replacing any
            # stale vetted address (the peer moved)
            addr = peer.dial_addr or peer.node_info.listen_addr
            if addr:
                self.book.add(peer.id, addr, persist=False,
                              source=peer.remote_addr, proven=True)
            self.book.mark_good(peer.id)
        else:
            # an inbound handshake proves nothing about the listen_addr
            # it advertises — hearsay into the new tier only, attributed
            # to the proven socket address; promoting it would let an
            # attacker fill the protected old tier with invented
            # addresses
            addr = peer.node_info.listen_addr
            if addr:
                self.book.add(peer.id, addr, persist=False,
                              source=peer.remote_addr)
        if self.seed_mode:
            # harvest the newcomer's book, then hang up shortly: a seed
            # serves addresses, it doesn't hold connections
            self._request_addrs(peer)
            self._schedule_hangup(peer)
        elif self._wants_peers():
            # under-connected: ask the newcomer for addresses NOW rather
            # than on the next ensure-peers tick — a crawling seed hangs
            # up within CRAWL_LINGER, long before a 30s interval fires
            # (pex_reactor.go sends the first request on peer add too)
            self._request_addrs(peer)

    def _request_addrs(self, peer) -> None:
        """Send pex_req AND register the solicitation — receive() drops
        any pex_res we didn't register (the anti-poisoning gate), so the
        two must never be separated."""
        self._requested.add(peer.id)
        peer.send(PEX_CHANNEL, _msgpack.packb({"@": "pex_req"}))

    def _wants_peers(self) -> bool:
        sw = self.switch
        if sw is None:
            return False
        outbound = sum(1 for p in sw.peers.values() if p.outbound)
        return outbound < self.max_outbound

    def _schedule_hangup(self, peer) -> None:
        # one timer per peer OBJECT (add_peer fires once per connection);
        # the identity check means a stale timer from a dropped
        # connection can never evict a reconnect, and the reconnect's
        # own timer still hangs it up
        async def hangup():
            await clock.sleep(CRAWL_LINGER)
            if self.switch is not None and \
                    getattr(self.switch, "peers", {}).get(
                        peer.id) is peer:
                await self.switch.stop_peer_gracefully(peer)

        self._spawn(hangup())

    def remove_peer(self, peer, reason) -> None:
        # a disconnect revokes any outstanding address-request
        # authorization (otherwise _requested grows forever on a
        # long-lived seed and a reconnecting peer could answer a
        # request it was never re-sent)
        self._requested.discard(peer.id)

    def receive(self, channel_id: int, peer, msg: bytes) -> None:
        d = _msgpack.unpackb(msg)
        tag = d.get("@")
        if tag == "pex_req":
            peer.send(PEX_CHANNEL, _msgpack.packb(
                {"@": "pex_res",
                 "addrs": [{"id": i, "addr": a}
                           for i, a in self.book.sample(
                               MAX_ADDRS_PER_RESPONSE)]}))
        elif tag == "pex_res":
            # only accept what we asked for: unsolicited responses are the
            # address-poisoning vector (pex_reactor.go requestsSent)
            if peer.id not in self._requested:
                self.log.debug("unsolicited pex_res dropped",
                               peer=peer.id[:8])
                return
            self._requested.discard(peer.id)
            # the advertiser's PROVEN socket address scopes bucket
            # placement: one source can only thrash the buckets its
            # group hashes to.  (Never the self-advertised listen_addr,
            # and never empty — an un-attributable response would let
            # each invented address become its own source group.)
            source = peer.remote_addr
            if not source:
                self.log.debug("pex_res without proven source dropped",
                               peer=peer.id[:8])
                return
            changed = False
            for entry in d.get("addrs", [])[:MAX_ADDRS_PER_RESPONSE]:
                nid, addr = entry.get("id", ""), entry.get("addr", "")
                if nid and nid != self.own_id:
                    changed |= self.book.add(nid, addr, persist=False,
                                             source=source)
            if changed:
                self.book.save_debounced()   # throttled full-book dump

    # ------------------------------------------------------- ensure peers

    async def _ensure_peers_routine(self) -> None:
        """pex_reactor.go ensurePeersRoutine: keep outbound connectivity
        up by asking for and dialing new addresses."""
        while True:
            await clock.sleep(self.request_interval
                              * (0.75 + 0.5 * self.rng.random()))
            try:
                self._ensure_peers()
            except Exception as e:
                self.log.warn("ensure peers failed", err=repr(e))

    def _ensure_peers(self) -> None:
        sw = self.switch
        if sw is None:
            return
        connected = set(sw.peers)
        if not self._wants_peers():
            return
        outbound = sum(1 for p in sw.peers.values() if p.outbound)
        # ask a random connected peer for more addresses
        if sw.peers:
            self._request_addrs(self.rng.choice(list(sw.peers.values())))
        # dial someone new
        for nid, addr in self.book.pick(connected | self._dialing
                                        | {self.own_id},
                                        n=self.max_outbound - outbound):
            self._dialing.add(nid)
            self._spawn(self._dial(nid, addr))

    # ------------------------------------------------------------ crawling

    async def _crawl_routine(self) -> None:
        """Seed-node loop (pex_reactor.go crawlPeersRoutine): dial book
        entries round after round — connections harvest addresses via
        ``add_peer`` and hang up after CRAWL_LINGER — so the book stays
        fresh and every inbound node gets a broad sample."""
        while True:
            try:
                self._crawl()
            except Exception as e:
                self.log.warn("crawl failed", err=repr(e))
            await clock.sleep(self.request_interval
                              * (0.75 + 0.5 * self.rng.random()))

    def _crawl(self) -> None:
        sw = self.switch
        if sw is None:
            return
        exclude = set(sw.peers) | self._dialing | {self.own_id}
        for nid, addr in self.book.pick(exclude, n=4):
            self._dialing.add(nid)
            self._spawn(self._dial(nid, addr))

    async def _dial(self, nid: str, addr: str) -> None:
        try:
            await self.switch.dial_peer(addr)
            self.log.debug("pex dialed", peer=nid[:8], addr=addr)
        except Exception as e:
            if "duplicate peer" not in str(e):
                self.book.mark_attempt(nid)
                self.log.debug("pex dial failed", addr=addr, err=repr(e))
        finally:
            self._dialing.discard(nid)
