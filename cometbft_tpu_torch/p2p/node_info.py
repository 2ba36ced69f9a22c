"""NodeInfo: the identity and compatibility exchange after the handshake
(counterpart of ``cometbft_tpu/p2p/node_info.py``; reference:
``p2p/node_info.go`` DefaultNodeInfo and CompatibleWith).  Encoded with
the port's MessagePack subset (``types/_msgpack.py``) into the JAX
package's bytes, so port and JAX nodes read each other's."""

from __future__ import annotations

from dataclasses import dataclass

from ..types import _msgpack

P2P_PROTOCOL_VERSION = 1
MAX_NODE_INFO_SIZE = 10240


class NodeInfoError(Exception):
    pass


@dataclass
class NodeInfo:
    node_id: str = ""
    listen_addr: str = ""           # "host:port" we accept connections on
    network: str = ""               # chain id
    version: str = "tpu-bft/0.2"
    channels: bytes = b""           # supported channel ids
    moniker: str = ""
    protocol_version: int = P2P_PROTOCOL_VERSION

    def validate_basic(self) -> None:
        if not self.node_id:
            raise NodeInfoError("empty node id")
        if len(self.channels) > 64:
            raise NodeInfoError("too many channels")
        if len(set(self.channels)) != len(self.channels):
            raise NodeInfoError("duplicate channel ids")

    def compatible_with(self, other: "NodeInfo") -> None:
        """Raises NodeInfoError unless the peers can talk
        (node_info.go CompatibleWith: same block version/network, >=1
        common channel)."""
        if self.protocol_version != other.protocol_version:
            raise NodeInfoError(
                f"protocol version mismatch: {self.protocol_version} "
                f"!= {other.protocol_version}")
        if self.network != other.network:
            raise NodeInfoError(
                f"network mismatch: {self.network!r} != {other.network!r}")
        if self.channels and other.channels and \
                not set(self.channels) & set(other.channels):
            raise NodeInfoError("no common channels")

    # ------------------------------------------------------------- codec

    def encode(self) -> bytes:
        return _msgpack.packb({
            "id": self.node_id, "addr": self.listen_addr,
            "net": self.network, "ver": self.version,
            "ch": self.channels, "mon": self.moniker,
            "pv": self.protocol_version})

    @classmethod
    def decode(cls, raw: bytes) -> "NodeInfo":
        if len(raw) > MAX_NODE_INFO_SIZE:
            raise NodeInfoError("node info too large")
        try:
            d = _msgpack.unpackb(raw)
        except ValueError as e:
            raise NodeInfoError(f"malformed node info: {e}") from None
        return cls(node_id=d["id"], listen_addr=d["addr"], network=d["net"],
                   version=d["ver"], channels=d["ch"], moniker=d["mon"],
                   protocol_version=d["pv"])
