"""Switch: reactor registry and peer lifecycle (counterpart of
``cometbft_tpu/p2p/switch.py``; reference: ``p2p/switch.go:72,110,163,269``).

Owns the Transport, accepts/dials peers, builds each peer's MConnection
from the union of reactor channel descriptors, dispatches received messages
to the owning reactor, fans out broadcasts, scores misbehavior through one
:class:`PeerScorer`, and reconnects persistent peers with exponential
backoff after errors (switch.go reconnectToPeer).  A telemetry routine
flushes each peer's plain MConnection counters into the peer-labelled
Prometheus series every ``telemetry_interval`` seconds (0: never), and
drops a departed peer's gauges.  Every MConnection carries the switch's
``name`` as its fault-plane scope (``node=<name>`` rules)."""

from __future__ import annotations

import asyncio
import random

from ..libs import aio, clock

from ..libs import log as tmlog
from .conn import (DEFAULT_PING_INTERVAL, DEFAULT_PONG_TIMEOUT,
                   ConnectionLostError, MConnection, MConnectionError,
                   PongTimeoutError)
from .metrics import p2p_metrics, peer_label
from .node_info import NodeInfo
from .peer import Peer
from .quality import PeerMisbehaviorError, PeerScorer
from .reactor import ChannelDescriptor, Reactor
from .transport import Transport

RECONNECT_BASE_DELAY = 0.5
RECONNECT_MAX_DELAY = 30.0
RECONNECT_MAX_ATTEMPTS = 20
# per-peer telemetry flush cadence (Prometheus series are written here,
# never from the packet path)
TELEMETRY_FLUSH_INTERVAL = 2.0


class SwitchError(Exception):
    pass


class Switch:
    def __init__(self, transport: Transport,
                 emulated_latency: float = 0.0,
                 scorer: PeerScorer | None = None,
                 name: str = "",
                 telemetry_interval: float = TELEMETRY_FLUSH_INTERVAL,
                 ping_interval: float = DEFAULT_PING_INTERVAL,
                 pong_timeout: float = DEFAULT_PONG_TIMEOUT,
                 reconnect_base_delay: float = RECONNECT_BASE_DELAY,
                 reconnect_max_delay: float = RECONNECT_MAX_DELAY):
        self.transport = transport
        # fault-plane scope stamped on every MConnection
        self.chaos_scope = name
        self.telemetry_interval = telemetry_interval
        self.emulated_latency = emulated_latency
        self.ping_interval = ping_interval
        self.pong_timeout = pong_timeout
        # reconnect pacing: a real node keeps the module defaults; the
        # scenario lab shrinks them so that a healed partition re-knits in
        # virtual seconds
        self.reconnect_base_delay = reconnect_base_delay
        self.reconnect_max_delay = reconnect_max_delay
        # node-wide peer reputation: every layer's misbehavior reports
        # funnel through report_peer into this one scorer, which orders
        # disconnects and timed bans (p2p/quality.py)
        self.scorer = scorer if scorer is not None else PeerScorer()
        self.reactors: dict[str, Reactor] = {}
        self._chan_to_reactor: dict[int, Reactor] = {}
        self._descriptors: list[ChannelDescriptor] = []
        self.peers: dict[str, Peer] = {}
        # node ids we have EVER dialed persistently: the ban exemption
        # must hold while the peer is between connections (late async
        # misbehavior reports land after removal) and for its inbound
        # reconnects (which never carry persistent=True themselves)
        self._persistent_ids: set[str] = set()
        self._running = False
        self._reconnect_tasks: dict[str, asyncio.Task] = {}
        # error teardowns in flight (stop() awaits them)
        self._teardowns: set[asyncio.Task] = set()
        self._telemetry_task: asyncio.Task | None = None
        # last flushed (bytes..., drops) per (peer_label, chan_name), so
        # the flush increments counters by the delta
        self._flushed: dict[tuple[str, str], tuple] = {}
        transport.on_accept = self._on_accepted

        # labeled per node id: multi-node in-process ensembles share the
        # process-wide registry
        self._m_node = transport.node_key.id[:8]
        self.log = tmlog.logger("p2p", node=name or self._m_node)
        self._m = p2p_metrics()
        self._m_peers_out = self._m.peers.bind(node=self._m_node,
                                               direction="outbound")
        self._m_peers_in = self._m.peers.bind(node=self._m_node,
                                              direction="inbound")
        self._m_rtt = self._m.ping_rtt_seconds.bind(node=self._m_node)
        # per-channel dispatch counters, pre-bound at add_reactor time so
        # the receive hot path pays one dict lookup + one bound inc
        self._m_reactor_msgs: dict[int, object] = {}

    # ----------------------------------------------------------- reactors

    def add_reactor(self, name: str, reactor: Reactor) -> None:
        for desc in reactor.get_channels():
            if desc.channel_id in self._chan_to_reactor:
                raise SwitchError(
                    f"channel {desc.channel_id:#x} already claimed")
            self._chan_to_reactor[desc.channel_id] = reactor
            self._descriptors.append(desc)
            self._m_reactor_msgs[desc.channel_id] = \
                self._m.reactor_msgs.bind(reactor=name, node=self._m_node)
        self.reactors[name] = reactor
        reactor.set_switch(self)

    @property
    def channel_ids(self) -> bytes:
        return bytes(sorted(d.channel_id for d in self._descriptors))

    # ---------------------------------------------------------- lifecycle

    async def start(self) -> None:
        self._running = True
        for reactor in self.reactors.values():
            await reactor.start()
        if self.telemetry_interval > 0:
            self._telemetry_task = asyncio.create_task(
                self._telemetry_routine())

    async def stop(self) -> None:
        self._running = False
        # cancel everything BEFORE the first await: a yield here would
        # let an in-flight reconnect dial land a peer after the removal
        # snapshot below, leaking its MConnection tasks
        tasks = list(self._reconnect_tasks.values())
        if self._telemetry_task is not None:
            tasks.append(self._telemetry_task)
            self._telemetry_task = None
        for task in tasks:
            task.cancel()
        self._reconnect_tasks.clear()
        for peer in list(self.peers.values()):
            await self._remove_peer(peer, "switch stopping")
        for reactor in self.reactors.values():
            await reactor.stop()
        await self.transport.close()
        for task in tasks + list(self._teardowns):
            try:
                await task
            except (asyncio.CancelledError, Exception):
                pass

    # -------------------------------------------------------------- peers

    async def _on_accepted(self, conn, node_info: NodeInfo) -> None:
        try:
            await self._add_peer(conn, node_info, outbound=False)
        except SwitchError as e:
            # refusing an inbound (banned / duplicate / stopping) is a
            # normal outcome, not an unretrieved task exception
            self.log.debug("inbound peer refused", err=str(e))

    async def dial_peer(self, addr: str, persistent: bool = False) -> Peer:
        try:
            conn, node_info = await self.transport.dial(addr)
        except asyncio.CancelledError:
            raise
        except Exception:
            self._m.dial_failures.inc(node=self._m_node)
            raise
        return await self._add_peer(conn, node_info, outbound=True,
                                    persistent=persistent, dial_addr=addr)

    async def _add_peer(self, conn, node_info: NodeInfo, outbound: bool,
                        persistent: bool = False,
                        dial_addr: str | None = None) -> Peer:
        if not self._running:
            # an accept (or concurrent dial) whose handshake finishes
            # while stop() runs must not land a peer after the removal
            # snapshot — its MConnection tasks would never be cancelled
            # and the peer gauges would report a phantom forever
            conn.close()
            raise SwitchError("switch is not running")
        own_id = self.transport.node_key.id
        if node_info.node_id == own_id:
            conn.close()
            raise SwitchError("refusing to connect to self")
        if node_info.node_id in self.peers:
            conn.close()
            raise SwitchError(f"duplicate peer {node_info.node_id[:12]}")
        if persistent:
            self._persistent_ids.add(node_info.node_id)
        if not persistent and \
                node_info.node_id not in self._persistent_ids and \
                self.scorer.is_banned(node_info.node_id):
            # admission control: a timed ban refuses the connection at
            # the door (inbound and plain outbound alike).  Persistent
            # peers are operator-pinned and exempt from bans — including
            # their INBOUND reconnects, which don't carry the flag.
            conn.close()
            raise SwitchError(f"peer {node_info.node_id[:12]} is banned")

        peer_box: list[Peer] = []
        reactor_msgs = self._m_reactor_msgs

        def on_receive(chan_id: int, msg: bytes) -> None:
            reactor = self._chan_to_reactor.get(chan_id)
            if reactor is not None and peer_box:
                bound = reactor_msgs.get(chan_id)
                if bound is not None:
                    bound.inc()
                reactor.receive(chan_id, peer_box[0], msg)

        def on_error(exc: Exception) -> None:
            if peer_box:
                aio.spawn(self.stop_peer_for_error(peer_box[0], exc),
                          self._teardowns)

        mconn = MConnection(conn, self._descriptors, on_receive, on_error,
                            ping_interval=self.ping_interval,
                            pong_timeout=self.pong_timeout,
                            emulated_latency=self.emulated_latency)
        mconn.on_rtt = self._m_rtt.observe
        mconn.chaos_scope = self.chaos_scope
        peer = Peer(node_info, mconn, outbound, persistent, dial_addr)
        peer_box.append(peer)
        self.peers[peer.id] = peer
        self._set_peer_gauges()
        mconn.start()
        for reactor in self.reactors.values():
            reactor.add_peer(peer)
        return peer

    def _set_peer_gauges(self) -> None:
        n_out = sum(1 for p in self.peers.values() if p.outbound)
        self._m_peers_out.set(n_out)
        self._m_peers_in.set(len(self.peers) - n_out)

    # ------------------------------------------------------- peer quality

    @staticmethod
    def _classify_error(err) -> str | None:
        """Map a connection-teardown cause to a misbehavior event, or
        None when it isn't the peer's fault (plain network failures) or
        was already scored (PeerMisbehaviorError)."""
        if not isinstance(err, Exception):
            return None                      # string reason / None
        if isinstance(err, (PeerMisbehaviorError, ConnectionLostError,
                            asyncio.CancelledError)):
            return None
        if isinstance(err, PongTimeoutError):
            return "pong_timeout"
        if isinstance(err, MConnectionError):
            return "malformed_frame"         # post-AEAD decode/framing
        if isinstance(err, (ConnectionError, OSError)):
            return None
        return "protocol_error"              # reactor raised on input

    def _score(self, peer_id: str, event: str, *, persistent: bool,
               detail: str = "", weight: float | None = None) -> str | None:
        """Record one event with the scorer + metrics; returns the
        ordered action without executing it."""
        action = self.scorer.report(peer_id, event, weight=weight,
                                    persistent=persistent, detail=detail)
        self._m.misbehavior.inc(node=self._m_node, event=event)
        if action == "ban":
            self._m.peer_bans.inc(node=self._m_node, reason=event)
            self.log.warn("peer banned", peer=peer_id[:12], reason=event,
                          detail=detail[:80])
        return action

    def report_peer(self, peer_id: str, event: str, detail: str = "",
                    weight: float | None = None,
                    disconnect: bool = False) -> str | None:
        """Reactor-facing misbehavior report.  Scores the event; when
        the scorer orders a disconnect/ban — or the caller already
        decided the peer must go (``disconnect=True``, e.g. blocksync
        dropping a bad block server) — the peer is stopped.  Persistent
        peers are re-dialed by stop_peer_for_error as usual."""
        peer = self.peers.get(peer_id)
        # a late report for a disconnected peer must still honor the
        # persistent-peer ban exemption
        persistent = (peer.persistent if peer is not None else False) \
            or peer_id in self._persistent_ids
        action = self._score(peer_id, event, persistent=persistent,
                             detail=detail, weight=weight)
        if peer is not None and (action is not None or disconnect):
            aio.spawn(self.stop_peer_for_error(
                peer, PeerMisbehaviorError(event, detail)), self._teardowns)
        return action

    async def stop_peer_for_error(self, peer: Peer, err) -> None:
        """switch.go StopPeerForError + persistent reconnect."""
        if peer.id not in self.peers:
            return
        if isinstance(err, PongTimeoutError):
            self._m.pong_timeouts.inc(node=self._m_node)
        event = self._classify_error(err)
        if event is not None:
            # connection-level misbehavior (garbage frames, reactor
            # blow-ups, silent death) feeds the same ledger as the
            # in-band reports, so a reconnect-and-misbehave loop
            # escalates to a timed ban
            self._score(peer.id, event,
                        persistent=(peer.persistent
                                    or peer.id in self._persistent_ids),
                        detail=repr(err)[:160])
        await self._remove_peer(peer, err)
        if self._running and peer.persistent and peer.dial_addr:
            self._schedule_reconnect(peer.dial_addr)

    async def stop_peer_gracefully(self, peer: Peer) -> None:
        await self._remove_peer(peer, None)

    async def _remove_peer(self, peer: Peer, reason) -> None:
        self.peers.pop(peer.id, None)
        self._set_peer_gauges()
        self._drop_peer_series(peer)
        for reactor in self.reactors.values():
            try:
                reactor.remove_peer(peer, reason)
            except Exception:
                pass
        await peer.stop()

    def _schedule_reconnect(self, addr: str) -> None:
        if addr in self._reconnect_tasks:
            return

        async def _reconnect():
            delay = self.reconnect_base_delay
            attempts = 0
            while True:
                await clock.sleep(delay * (1 + 0.2 * random.random()))
                if not self._running:
                    return
                if any(p.dial_addr == addr for p in self.peers.values()):
                    return      # already re-dialed (a racing loop won)
                try:
                    await self.dial_peer(addr, persistent=True)
                    return
                except asyncio.CancelledError:
                    raise
                except Exception as e:
                    if isinstance(e, SwitchError) and \
                            "duplicate peer" in str(e):
                        # the peer reconnected INBOUND while we backed
                        # off: mission accomplished — without this the
                        # now-unbounded loop would re-handshake against
                        # a connected peer every max-delay forever
                        return
                    attempts += 1
                    if attempts == RECONNECT_MAX_ATTEMPTS:
                        # the reference gives up here — silently losing
                        # an operator-pinned peer forever.  Log + count
                        # the backoff exhaustion, then keep retrying at
                        # the max delay (with jitter) indefinitely: a
                        # persistent peer is persistent.
                        self._m.reconnect_giveups.inc(node=self._m_node)
                        self.log.warn(
                            "persistent-peer reconnect exhausted backoff; "
                            "continuing at max delay", addr=addr,
                            attempts=attempts, err=repr(e)[:80])
                    delay = min(delay * 2, self.reconnect_max_delay)

        task = asyncio.create_task(_reconnect())
        task.add_done_callback(
            lambda _t: self._reconnect_tasks.pop(addr, None))
        self._reconnect_tasks[addr] = task

    # ---------------------------------------------------------- telemetry

    async def _telemetry_routine(self) -> None:
        """Flush the per-peer plain counters into the peer-labelled
        series every ``telemetry_interval`` (counters by their delta,
        gauges set), off the packet path."""
        while True:
            await clock.sleep(self.telemetry_interval)
            try:
                self.flush_peer_telemetry()
            except Exception:
                pass          # a metrics fault never stops p2p

    def flush_peer_telemetry(self) -> None:
        for peer in list(self.peers.values()):
            self._flush_one_peer(peer)

    def _flush_one_peer(self, peer: Peer) -> None:
        mets, node = self._m, self._m_node
        pl = peer_label(peer.id)
        mconn = peer.mconn
        for ch in mconn.channels.values():
            cname = ch.display_name
            key = (pl, cname)
            cur = (ch.sent_bytes, ch.recv_bytes, ch.sent_msgs,
                   ch.recv_msgs, ch.queue_full_drops)
            last = self._flushed.get(key, (0, 0, 0, 0, 0))
            if cur[0] > last[0]:
                mets.peer_send_bytes.inc(cur[0] - last[0], node=node,
                                         peer=pl, channel=cname)
            if cur[1] > last[1]:
                mets.peer_recv_bytes.inc(cur[1] - last[1], node=node,
                                         peer=pl, channel=cname)
            if cur[2] > last[2]:
                mets.peer_send_msgs.inc(cur[2] - last[2], node=node,
                                        peer=pl, channel=cname)
            if cur[3] > last[3]:
                mets.peer_recv_msgs.inc(cur[3] - last[3], node=node,
                                        peer=pl, channel=cname)
            if cur[4] > last[4]:
                mets.peer_queue_drops.inc(cur[4] - last[4], node=node,
                                          peer=pl, channel=cname)
                mets.queue_full_drops.inc(cur[4] - last[4], node=node,
                                          channel=cname)
            self._flushed[key] = cur
            mets.peer_queue_depth.set(ch.queue.qsize(), node=node,
                                      peer=pl, channel=cname)
        mets.peer_send_rate.set(mconn.send_monitor.rate, node=node,
                                peer=pl)
        mets.peer_recv_rate.set(mconn.recv_monitor.rate, node=node,
                                peer=pl)
        mets.peer_score.set(self.scorer.score(peer.id), node=node,
                            peer=pl)
        if mconn.last_rtt_s is not None:
            mets.peer_rtt.set(mconn.last_rtt_s, node=node, peer=pl)

    def _drop_peer_series(self, peer: Peer) -> None:
        """A departed peer's last counter deltas, then its gauges dropped
        (counters stay: Prometheus counters only grow)."""
        try:
            self._flush_one_peer(peer)
        except Exception:
            pass                  # metrics never block a removal
        pl = peer_label(peer.id)
        mets, node = self._m, self._m_node
        for key in [k for k in self._flushed if k[0] == pl]:
            self._flushed.pop(key, None)
            mets.peer_queue_depth.remove(node=node, peer=pl,
                                         channel=key[1])
        mets.peer_send_rate.remove(node=node, peer=pl)
        mets.peer_recv_rate.remove(node=node, peer=pl)
        mets.peer_rtt.remove(node=node, peer=pl)
        mets.peer_score.remove(node=node, peer=pl)

    # ---------------------------------------------------------- broadcast

    def broadcast(self, channel_id: int, msg: bytes,
                  except_peer: Peer | None = None) -> None:
        """Fan a message to every connected peer (switch.go:269)."""
        for peer in self.peers.values():
            if except_peer is not None and peer.id == except_peer.id:
                continue
            peer.send(channel_id, msg)

    def quietest_peer_recv_age_s(self) -> float | None:
        """Seconds since the most recently heard-from peer last produced
        a complete packet: the liveness watchdog's "all peers went
        quiet" input (None with no peers)."""
        if not self.peers:
            return None
        now = clock.monotonic()
        return min(now - p.mconn.last_recv_mono
                   for p in self.peers.values())

    def peer_snapshot(self) -> list[dict]:
        """Each peer's telemetry with its scorer quality block, for
        ``/net_info``."""
        out = []
        for p in self.peers.values():
            d = p.telemetry()
            d["quality"] = self.scorer.peer_info(p.id)
            out.append(d)
        return out

    def n_peers(self) -> int:
        return len(self.peers)
