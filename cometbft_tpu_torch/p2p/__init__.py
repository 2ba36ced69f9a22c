"""Peer-to-peer layer (counterpart of ``cometbft_tpu/p2p``): the secret
connection, MConnection, transport with its connection fuzzer, switch,
peer scorer, the reactor interface, peer exchange and the address book,
over asyncio TCP."""

from .addrbook import AddrBook
from .key import NodeKey
from .node_info import NodeInfo
from .peer import Peer
from .pex import PexReactor
from .quality import PeerScorer
from .reactor import ChannelDescriptor, Reactor
from .switch import Switch
from .transport import Transport

__all__ = ["NodeKey", "NodeInfo", "Peer", "ChannelDescriptor", "Reactor",
           "Switch", "Transport", "AddrBook", "PexReactor", "PeerScorer"]
