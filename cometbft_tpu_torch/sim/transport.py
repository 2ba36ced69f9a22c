"""In-memory transport behind the ``Switch``/``MConnection`` interfaces
(counterpart of ``cometbft_tpu/sim/transport.py``).

A :class:`MemNetwork` is the wire: every node's :class:`MemTransport`
registers a listen address (``mem://<name>``), dials resolve through the
registry, and each established connection is a pair of :class:`MemConn`
byte streams with the surface the Switch and MConnection consume from
``SecretConnection`` (``read``/``write``/``read_msg``/``write_msg``/
``close``/``remote_pub_key``), so the packet protocol, channel
multiplexing, ping/pong liveness and every ``p2p.send.*``/``p2p.recv.*``
fault site run as they do over TCP.  The handshake keeps the real
upgrade's shape: NodeInfo is exchanged over the wire under the handshake
timeout and validated (declared id against the registry's key,
``compatible_with``); the registry proves identity instead of an STS
exchange, so no link runs the AEAD or a challenge check.

The link model is directional: each ordered pair of node names resolves
to a :class:`LinkPolicy` (most specific wins: the exact pair, then
``(src, *)``, ``(*, dst)``, then the default):

- ``latency_s``: one-way delivery delay (equal delays keep order);
- ``bandwidth_bps``: serialization delay, a per-direction busy-until
  cursor so back-to-back writes queue behind each other;
- ``cut``: a partition.  A write onto a cut link raises
  ``ConnectionResetError`` (in-flight deliveries still land) and new
  dials fail after a virtual connect delay.  The write must error, not
  vanish: gossip marks votes and parts as held by the peer once queued,
  which TCP honours by delivering or dying.  Silent loss belongs to the
  fault plane's bounded ``p2p.send.drop`` rules.  Cuts are one-way;
  ``MemNetwork.partition`` applies them pairwise (both ways, or one way
  for the asymmetric cut).

Scenario programs drive this through ``MemNetwork.apply_spec`` in the
``libs/failures`` grammar (``link:node=a:peer=b:delay=0.05``, ``cut=fwd``
for one direction).
"""

from __future__ import annotations

import asyncio
import struct
from collections import deque

from ..libs import aio, clock
from ..libs.failures import FaultSpecError, parse_fault_spec
from ..p2p.key import NodeKey, node_id
from ..p2p.node_info import NodeInfo, NodeInfoError
from ..p2p.transport import TransportError

__all__ = ["LinkPolicy", "MemConn", "MemNetwork", "MemTransport",
           "HANDSHAKE_TIMEOUT", "CONNECT_FAIL_DELAY_S", "DEFAULT_LATENCY_S"]

HANDSHAKE_TIMEOUT = 8.0
CONNECT_FAIL_DELAY_S = 1.0      # virtual delay before a cut dial errors
DEFAULT_LATENCY_S = 0.01


class LinkPolicy:
    __slots__ = ("latency_s", "bandwidth_bps", "cut")

    def __init__(self, latency_s: float = DEFAULT_LATENCY_S,
                 bandwidth_bps: float = 0.0, cut: bool = False):
        self.latency_s = latency_s
        self.bandwidth_bps = bandwidth_bps       # 0 = unlimited
        self.cut = cut


class _MemStream:
    """One direction of a link: a byte buffer fed by delayed deliveries.

    The writer computes the delivery time from the *current* link policy
    (so scenario steps take effect mid-run) and schedules ``_feed`` on
    the loop; the reader blocks on an event until enough bytes (or EOF)
    arrive.  ``busy_until`` is the bandwidth cursor.

    Ordering: writes land in a FIFO ``pending`` queue and each timer
    callback delivers the *head*, not its own payload — asyncio's timer
    heap does NOT promise FIFO for equal deadlines (ties are heap
    order), and same-virtual-instant writes are the common case, so
    delivering by timer identity would reorder packets and corrupt the
    message framing.  Delivery times are clamped monotonic per stream
    for the same reason (a latency drop mid-run must not let new
    packets overtake queued ones)."""

    def __init__(self):
        self.buf = bytearray()
        self.eof = False
        self.busy_until = 0.0
        self.last_deliver_at = 0.0
        self.pending: "deque[tuple[float, bytes | None]]" = deque()
        self._timer: asyncio.TimerHandle | None = None
        self._wakeup = asyncio.Event()

    def push(self, item: "bytes | None", deliver_at: float) -> float:
        """Queue one delivery (``None`` = EOF) for ``deliver_at``;
        returns the (monotonically clamped) actual delivery time.  One
        timer serves the whole queue head — a gossip burst lands as one
        heap entry, not one per packet (the timer heap was a dominant
        cost at 100-node scale)."""
        deliver_at = max(deliver_at, self.last_deliver_at)
        self.last_deliver_at = deliver_at
        self.pending.append((deliver_at, item))
        if self._timer is None:
            self._arm()
        return deliver_at

    def _arm(self) -> None:
        if not self.pending or self.eof:
            return
        loop = asyncio.get_running_loop()
        delay = self.pending[0][0] - loop.time()
        if delay <= 0:
            self._drain()
        else:
            self._timer = loop.call_later(delay, self._drain)

    def _drain(self) -> None:
        self._timer = None
        if self.eof:
            self.pending.clear()
            return
        now = asyncio.get_running_loop().time()
        fed = False
        while self.pending and self.pending[0][0] <= now + 1e-9:
            _, item = self.pending.popleft()
            if item is None:
                self.eof = True
                self.pending.clear()
                fed = True
                break
            self.buf.extend(item)
            fed = True
        if fed:
            self._wakeup.set()
        self._arm()

    def _feed_eof(self) -> None:
        """Immediate EOF (our own side closing): jumps the queue — the
        reader must unblock now, whatever is still in flight."""
        self.eof = True
        self._wakeup.set()

    async def read(self, n: int) -> bytes:
        while len(self.buf) < n:
            if self.eof:
                raise asyncio.IncompleteReadError(bytes(self.buf), n)
            self._wakeup.clear()
            await self._wakeup.wait()
        out = bytes(self.buf[:n])
        del self.buf[:n]
        return out


class MemConn:
    """One endpoint of an in-memory link — the sim's SecretConnection."""

    def __init__(self, network: "MemNetwork", src: str, dst: str,
                 rx: _MemStream, tx: _MemStream, remote_pub_key):
        self._network = network
        self.src = src                   # our node name
        self.dst = dst                   # peer node name
        self._rx = rx
        self._tx = tx
        self.remote_pub_key = remote_pub_key
        self.remote_addr = f"mem://{dst}"
        self._closed = False

    # ------------------------------------------------------- byte stream

    async def write(self, data: bytes) -> None:
        if self._closed or self._tx.eof:
            raise ConnectionResetError("mem connection closed")
        pol = self._network.policy(self.src, self.dst)
        if pol.cut:
            # partitioned: the flow dies NOW (see module docstring on
            # why a cut must error rather than blackhole)
            raise ConnectionResetError(
                f"link {self.src}->{self.dst} is cut")
        now = asyncio.get_running_loop().time()
        start = max(now, self._tx.busy_until)
        if pol.bandwidth_bps > 0:
            start += len(data) / pol.bandwidth_bps
        self._tx.busy_until = start
        self._tx.push(data, start + pol.latency_s)

    async def read(self, n: int) -> bytes:
        return await self._rx.read(n)

    # ------------------------------------------------------- msg framing

    async def write_msg(self, msg: bytes) -> None:
        await self.write(struct.pack("<I", len(msg)) + msg)

    async def read_msg(self, max_size: int = 1 << 22) -> bytes:
        (n,) = struct.unpack("<I", await self.read(4))
        if n > max_size:
            raise TransportError(f"message too large: {n}")
        return await self.read(n)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        # the peer sees EOF after the link's latency, like a FIN would
        # arrive; our own reader unblocks immediately
        self._rx._feed_eof()
        pol = self._network.policy(self.src, self.dst)
        if pol.cut:
            return                       # FIN is blackholed too
        self._tx.push(None, asyncio.get_running_loop().time()
                      + pol.latency_s)


class MemNetwork:
    """The registry + link-policy table one scenario run shares."""

    def __init__(self, default_latency_s: float = DEFAULT_LATENCY_S):
        self._transports: dict[str, MemTransport] = {}
        self.default = LinkPolicy(latency_s=default_latency_s)
        # ordered-pair policies; lookup: (src,dst) > (src,"*") > ("*",dst)
        self._links: dict[tuple[str, str], LinkPolicy] = {}

    # --------------------------------------------------------- registry

    def register(self, transport: "MemTransport") -> str:
        name = transport.name
        if name in self._transports:
            raise TransportError(f"duplicate mem transport {name!r}")
        self._transports[name] = transport
        return f"mem://{name}"

    def unregister(self, name: str) -> None:
        self._transports.pop(name, None)

    def resolve(self, addr: str) -> "MemTransport | None":
        return self._transports.get(addr.removeprefix("mem://"))

    # ------------------------------------------------------ link policy

    def policy(self, src: str, dst: str) -> LinkPolicy:
        links = self._links
        pol = links.get((src, dst))
        if pol is not None:
            return pol
        pol = links.get((src, "*"))
        if pol is not None:
            return pol
        pol = links.get(("*", dst))
        if pol is not None:
            return pol
        return self.default

    def _edit(self, src: str, dst: str) -> LinkPolicy:
        pol = self._links.get((src, dst))
        if pol is None:
            base = self.policy(src, dst)
            pol = self._links[(src, dst)] = LinkPolicy(
                base.latency_s, base.bandwidth_bps, base.cut)
        return pol

    def set_link(self, src: str = "*", dst: str = "*", *,
                 latency_s: float | None = None,
                 bandwidth_bps: float | None = None,
                 cut: bool | None = None) -> None:
        """Set one direction's policy (``*`` wildcards one side)."""
        targets = [self.default] if (src, dst) == ("*", "*") \
            else [self._edit(src, dst)]
        for pol in targets:
            if latency_s is not None:
                pol.latency_s = latency_s
            if bandwidth_bps is not None:
                pol.bandwidth_bps = bandwidth_bps
            if cut is not None:
                pol.cut = cut

    def cut(self, a: str, b: str, *, one_way: bool = False) -> None:
        self.set_link(a, b, cut=True)
        if not one_way:
            self.set_link(b, a, cut=True)

    def partition(self, *groups: list, one_way: bool = False) -> None:
        """Cut every cross-group pair.  ``one_way=True`` cuts only the
        earlier-group -> later-group direction (the asymmetric gray
        partition: replies flow, requests vanish)."""
        for i, ga in enumerate(groups):
            for gb in groups[i + 1:]:
                for a in ga:
                    for b in gb:
                        self.set_link(a, b, cut=True)
                        if not one_way:
                            self.set_link(b, a, cut=True)

    def heal(self) -> None:
        """Clear every cut (latency/bandwidth shaping is kept)."""
        self.default.cut = False
        for pol in self._links.values():
            pol.cut = False

    def apply_spec(self, spec: str) -> None:
        """``libs/failures`` grammar for transport faults:
        ``link:node=<src>:peer=<dst>:delay=<s>:bw=<bps>:cut=<dir>``.
        ``cut`` is ``both``, a direction (``fwd``/``rev``), or ``off``;
        omitted sides default to ``*``."""
        rule = parse_fault_spec(spec)
        if rule.site != "link":
            raise FaultSpecError(f"transport spec must target site "
                                 f"'link': {spec!r}")
        p = rule.params
        src = str(p.get("node", "*"))
        dst = str(p.get("peer", "*"))
        lat = float(p["delay"]) if "delay" in p else None
        bw = float(p["bw"]) if "bw" in p else None
        cut_param = p.get("cut")
        if cut_param in (None, ""):
            self.set_link(src, dst, latency_s=lat, bandwidth_bps=bw)
            return
        mode = str(cut_param)
        if mode == "off":
            self.set_link(src, dst, latency_s=lat, bandwidth_bps=bw,
                          cut=False)
            self.set_link(dst, src, cut=False)
        elif mode == "fwd":
            self.set_link(src, dst, latency_s=lat, bandwidth_bps=bw,
                          cut=True)
        elif mode == "rev":
            self.set_link(dst, src, cut=True)
            if lat is not None or bw is not None:
                self.set_link(src, dst, latency_s=lat, bandwidth_bps=bw)
        elif mode == "both":
            self.set_link(src, dst, latency_s=lat, bandwidth_bps=bw,
                          cut=True)
            self.set_link(dst, src, cut=True)
        else:
            raise FaultSpecError(f"bad cut mode {mode!r} in {spec!r}")


class MemTransport:
    """Drop-in for ``p2p.transport.Transport`` over a MemNetwork."""

    def __init__(self, node_key: NodeKey, node_info_fn,
                 network: MemNetwork, name: str,
                 handshake_timeout: float = HANDSHAKE_TIMEOUT):
        self.node_key = node_key
        self.node_info_fn = node_info_fn
        self.network = network
        self.name = name
        self.handshake_timeout = handshake_timeout
        self.listen_addr: str | None = None
        self.on_accept = None    # async (MemConn, NodeInfo) -> None
        self._listening = False
        self._accept_tasks: set = set()

    # ------------------------------------------------------------- listen

    async def listen(self, host: str = "", port: int = 0) -> str:
        self.listen_addr = self.network.register(self)
        self._listening = True
        return self.listen_addr

    async def close(self) -> None:
        self._listening = False
        self.network.unregister(self.name)
        for t in list(self._accept_tasks):
            t.cancel()

    # --------------------------------------------------------------- dial

    async def dial(self, addr: str) -> tuple[MemConn, NodeInfo]:
        target = self.network.resolve(addr)
        if target is None or not target._listening:
            raise ConnectionRefusedError(f"no mem listener at {addr}")
        # a cut in either direction means the TCP handshake could not
        # complete: fail after a virtual connect delay, like a SYN
        # timing out, so reconnect backoff sees a realistic cadence
        if self.network.policy(self.name, target.name).cut or \
                self.network.policy(target.name, self.name).cut:
            await clock.sleep(CONNECT_FAIL_DELAY_S)
            raise ConnectionRefusedError(f"{addr} unreachable (cut)")
        a2b, b2a = _MemStream(), _MemStream()
        conn_out = MemConn(self.network, self.name, target.name,
                           rx=b2a, tx=a2b,
                           remote_pub_key=target.node_key.pub_key)
        conn_in = MemConn(self.network, target.name, self.name,
                          rx=a2b, tx=b2a,
                          remote_pub_key=self.node_key.pub_key)
        # acceptor side runs concurrently, like _handle_accept on a real
        # listener; its task is tracked so close() can cancel stragglers
        t = aio.spawn(target._accept(conn_in), store=target._accept_tasks)
        del t
        try:
            ni = await clock.wait_for(self._upgrade(conn_out),
                                      self.handshake_timeout)
        except Exception:
            conn_out.close()
            raise
        return conn_out, ni

    # ------------------------------------------------------------ upgrade

    async def _accept(self, conn: MemConn) -> None:
        try:
            ni = await clock.wait_for(self._upgrade(conn),
                                      self.handshake_timeout)
        except asyncio.CancelledError:
            raise
        except Exception:
            conn.close()
            return
        if self.on_accept is not None and self._listening:
            await self.on_accept(conn, ni)

    async def _upgrade(self, conn: MemConn) -> NodeInfo:
        """Same exchange + validation as the TCP upgrade, minus the STS
        crypto (the registry already proved the remote key)."""
        await conn.write_msg(self.node_info_fn().encode())
        their_info = NodeInfo.decode(await conn.read_msg(max_size=10240))
        their_info.validate_basic()
        proven_id = node_id(conn.remote_pub_key)
        if their_info.node_id != proven_id:
            raise TransportError(
                f"peer declared id {their_info.node_id} but proved "
                f"{proven_id}")
        try:
            self.node_info_fn().compatible_with(their_info)
        except NodeInfoError as e:
            raise TransportError(f"incompatible peer: {e}")
        return their_info
