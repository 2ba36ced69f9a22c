"""Keep-alive task spawning (counterpart of ``cometbft_tpu/libs/aio.py``).

The event loop holds only weak references to tasks, so a task whose
handle is dropped can be collected mid-flight.  :func:`spawn` parks a
strong reference until the task finishes."""

from __future__ import annotations

import asyncio

__all__ = ["spawn"]

_BG: set[asyncio.Task] = set()       # the default keep-alive set


def spawn(coro, store: set | None = None) -> asyncio.Task:
    """``ensure_future`` with a strong reference held until done;
    ``store`` lets an owner track (and cancel on stop) its own tasks."""
    t = asyncio.ensure_future(coro)
    s = _BG if store is None else store
    s.add(t)
    t.add_done_callback(s.discard)
    return t
