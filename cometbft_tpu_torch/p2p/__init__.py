"""Peer-to-peer layer (counterpart of ``cometbft_tpu/p2p``): the secret
connection, MConnection, transport, switch, peer scorer and the reactor
interface, over asyncio TCP.  Peer exchange and the address book come
with ``p2p/pex.py`` and ``p2p/addrbook.py``."""

from .key import NodeKey
from .node_info import NodeInfo
from .peer import Peer
from .quality import PeerScorer
from .reactor import ChannelDescriptor, Reactor
from .switch import Switch
from .transport import Transport

__all__ = ["NodeKey", "NodeInfo", "Peer", "ChannelDescriptor", "Reactor",
           "Switch", "Transport", "PeerScorer"]
