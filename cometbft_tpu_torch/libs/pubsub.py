"""Async pub/sub event bus (reference: ``libs/pubsub/pubsub.go`` and
``types/event_bus.go``).

Counterpart of ``cometbft_tpu/libs/pubsub.py``: a subscription matches
with the full query language of ``libs/query`` (a string, compiled at
subscribe, or a ``Query``: ``tm.event='Tx' AND tx.height > 5``), or with
an equality dict ``{attr: value}`` (``"tm.event"`` matches the event
type), the form the reactors and the indexer use."""

from __future__ import annotations

import asyncio
from dataclasses import dataclass, field

from .query import Query

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
    query: object                        # Query | dict[str, str]
    queue: asyncio.Queue = field(default_factory=lambda: asyncio.Queue(256))
    unbuffered: bool = False             # guaranteed delivery

    def matches(self, msg: Message) -> bool:
        if isinstance(self.query, Query):
            return self.query.matches(msg.event_map())
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

    def subscribe(self, subscriber: str, query,
                  unbuffered: bool = False) -> Subscription:
        """``query`` is a :class:`Query`, a query string (compiled here,
        raising ``QuerySyntaxError``) or an equality dict;
        ``unbuffered=True`` gives an unbounded queue with no drop."""
        if isinstance(query, str):
            query = Query.parse(query)
        elif isinstance(query, dict):
            query = dict(query)
        elif not isinstance(query, Query):
            raise TypeError(f"pubsub: a query is a Query, a string or a "
                            f"dict, not {type(query).__name__}")
        sub = Subscription(query, unbuffered=unbuffered)
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
