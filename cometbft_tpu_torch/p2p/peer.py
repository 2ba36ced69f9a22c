"""Peer: a connected, handshaked remote node (counterpart of
``cometbft_tpu/p2p/peer.py``; reference: ``p2p/peer.go``).

Binds an MConnection's channels to the Switch's reactor dispatch and keeps
per-peer metadata (NodeInfo, outbound/persistent flags, an arbitrary
key-value store used by reactors for per-peer state — PeerState lives
there, like the reference's ``Peer.Set``/``Get``)."""

from __future__ import annotations

from .conn import MConnection
from .node_info import NodeInfo


class GossipStats:
    """Per-peer gossip efficiency tallies, incremented by the consensus
    reactor (plain ints — the Prometheus children are bound separately).
    ``useful`` = votes we did not already hold; ``duplicate`` = re-gossip
    dropped at the reactor."""

    __slots__ = ("useful", "duplicate")

    def __init__(self):
        self.useful = 0
        self.duplicate = 0


class Peer:
    def __init__(self, node_info: NodeInfo, mconn: MConnection,
                 outbound: bool, persistent: bool = False,
                 dial_addr: str | None = None):
        self.node_info = node_info
        self.mconn = mconn
        self.outbound = outbound
        self.persistent = persistent
        self.dial_addr = dial_addr          # for persistent reconnect
        self.gossip = GossipStats()
        self._data: dict = {}               # reactor-attached state

    @property
    def id(self) -> str:
        return self.node_info.node_id

    @property
    def remote_addr(self) -> str:
        """The peer's proven socket address (empty if unknown)."""
        conn = getattr(self.mconn, "conn", None)
        return getattr(conn, "remote_addr", "") or ""

    def has_channel(self, channel_id: int) -> bool:
        """Whether the REMOTE advertised this channel in its handshake
        NodeInfo (reference peer.go hasChannel).  An empty advertisement
        means a pre-channels peer: allow, for wire compat."""
        chans = self.node_info.channels
        return not chans or channel_id in chans

    def send(self, channel_id: int, msg: bytes) -> bool:
        # sending on a channel the remote lacks would be a protocol
        # error THERE (unknown-channel frame kills the connection):
        # heterogeneous peers — e.g. statesync-only bootstrappers —
        # simply don't receive gossip they can't parse
        if not self.has_channel(channel_id):
            return False
        return self.mconn.send(channel_id, msg)

    def get(self, key: str):
        return self._data.get(key)

    def telemetry(self) -> dict:
        """The per-peer snapshot ``/net_info`` serves: identity,
        direction, the MConnection's counters and gossip efficiency."""
        return {
            "node_id": self.id,
            "moniker": self.node_info.moniker,
            "remote_addr": self.dial_addr or "",
            "outbound": self.outbound,
            "persistent": self.persistent,
            "connection_status": self.mconn.telemetry(),
            "gossip": {"useful": self.gossip.useful,
                       "duplicate": self.gossip.duplicate},
        }

    def set(self, key: str, value) -> None:
        self._data[key] = value

    async def stop(self) -> None:
        await self.mconn.stop()

    def __repr__(self):
        arrow = "->" if self.outbound else "<-"
        return f"Peer{{{arrow}{self.id[:12]}}}"
