"""Async pub/sub event bus (reference: ``libs/pubsub/pubsub.go`` and
``types/event_bus.go``).

Counterpart of ``cometbft_tpu/libs/pubsub.py`` for equality
subscriptions: a query is a dict ``{attr: value}`` (``"tm.event"``
matches the event type).  The query language of ``libs/query`` (a
string or a ``Query``) comes with the RPC slice of the port; until then
:meth:`EventBus.subscribe` refuses it with TypeError."""

from __future__ import annotations

import asyncio
from dataclasses import dataclass, field

__all__ = ["Message", "Subscription", "EventBus"]


@dataclass
class Message:
    event_type: str
    data: object
    attrs: dict[str, str] = field(default_factory=dict)

    def event_map(self) -> dict[str, list[str]]:
        """The composite-key -> values map a query evaluates over."""
        m = {k: [v] for k, v in self.attrs.items()}
        m["tm.event"] = [self.event_type]
        return m


@dataclass
class Subscription:
    query: dict
    queue: asyncio.Queue = field(default_factory=lambda: asyncio.Queue(256))
    unbuffered: bool = False             # guaranteed delivery

    def matches(self, msg: Message) -> bool:
        for k, want in self.query.items():
            if k == "tm.event":
                if msg.event_type != want:
                    return False
            elif msg.attrs.get(k) != want:
                return False
        return True


class EventBus:
    """Fire-and-forget publisher; a slow subscriber's oldest message is
    dropped to make room."""

    def __init__(self):
        self._subs: dict[str, Subscription] = {}

    def subscribe(self, subscriber: str, query: dict,
                  unbuffered: bool = False) -> Subscription:
        """``query`` is an equality dict; ``unbuffered=True`` gives an
        unbounded queue with no drop."""
        if not isinstance(query, dict):
            raise TypeError(
                f"pubsub: a {type(query).__name__} query needs libs/query, "
                "which is not in the port yet; pass an equality dict")
        sub = Subscription(dict(query), unbuffered=unbuffered)
        if unbuffered:
            sub.queue = asyncio.Queue()
        self._subs[subscriber] = sub
        return sub

    def unsubscribe(self, subscriber: str) -> None:
        self._subs.pop(subscriber, None)

    def publish(self, event_type: str, data: object,
                attrs: dict[str, str] | None = None) -> None:
        msg = Message(event_type, data, attrs or {})
        for sub in self._subs.values():
            if sub.matches(msg):
                if not sub.unbuffered and sub.queue.full():
                    try:
                        sub.queue.get_nowait()
                    except asyncio.QueueEmpty:
                        pass
                sub.queue.put_nowait(msg)

    def num_subscribers(self) -> int:
        return len(self._subs)
