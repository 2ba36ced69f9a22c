"""Reactor interface and channel descriptors (reference:
``p2p/base_reactor.go:15-31``; counterpart of
``cometbft_tpu/p2p/reactor.py``).  The switch and its transport come
with the node slice of the port."""

from __future__ import annotations

from dataclasses import dataclass

__all__ = ["ChannelDescriptor", "Reactor"]


@dataclass(frozen=True)
class ChannelDescriptor:
    channel_id: int
    priority: int = 1
    send_queue_capacity: int = 64
    max_msg_size: int = 1 << 20
    name: str = ""


class Reactor:
    """Registered on a switch; every callback runs on the event loop."""

    def __init__(self):
        self.switch = None

    def get_channels(self) -> list[ChannelDescriptor]:
        return []

    def set_switch(self, switch) -> None:
        self.switch = switch

    async def start(self) -> None:
        pass

    async def stop(self) -> None:
        pass

    def add_peer(self, peer) -> None:
        """A peer connected and exchanged its node info."""

    def remove_peer(self, peer, reason: object = None) -> None:
        """A peer disconnected or failed."""

    def receive(self, channel_id: int, peer, msg: bytes) -> None:
        """A whole message arrived on one of our channels."""
