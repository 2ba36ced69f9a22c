"""Peer-to-peer layer (counterpart of ``cometbft_tpu/p2p``): the reactor
interface."""

from .reactor import ChannelDescriptor, Reactor

__all__ = ["ChannelDescriptor", "Reactor"]
