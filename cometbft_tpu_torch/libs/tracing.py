"""Node-wide flight recorder (counterpart of
``cometbft_tpu/libs/tracing.py``): spans and events in a bounded
in-memory ring buffer.

Every subsystem on the commit path emits spans (an interval: a consensus
step, a scheduler dispatch) and events (a point: a WAL fsync, a
micro-batch flush) into one process-wide ring; :func:`dump` returns it
as JSON-able dicts, filtered by subsystem or height, and
:func:`snapshot` as raw tuples for ``libs/timeline``.

- **Disabled means free.**  Tracing is off until :func:`configure`
  turns it on.  ``event()`` returns on its first instruction;
  ``begin()`` returns None and ``finish(None)`` is a no-op.  Hot paths
  may guard with :func:`is_enabled` to skip building attrs at all.
- **Thread and asyncio safe without locks on the emit path.**  Records
  are single ``deque.append`` calls of fully built tuples, and ids come
  from ``itertools.count``: writers on the event loop, the scheduler's
  worker and the device-owner thread never tear a record.
- **Bounded memory.**  The ring is a ``deque(maxlen=N)``.

Records carry a ``sub`` (``consensus``, ``crypto.sched``, ``wal``,
``mempool``), a ``name`` (``step``, ``dispatch``, ``fsync`` ...) and
free-form ``attrs``.  Spans (:func:`begin`/:func:`finish`, which may
cross handler boundaries, as consensus steps do) record the
``ContextVar`` span id current at their start as ``parent``.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from contextvars import ContextVar

from . import clock as _clock

_ENABLED = False
_MAXLEN = 8192
_RING: deque = deque(maxlen=_MAXLEN)
_SEQ = itertools.count(1)
_CUR: ContextVar[int] = ContextVar("tracing_cur_span", default=0)
_CONF_LOCK = threading.Lock()

# record tuples: (kind, id, parent, sub, name, wall_ns, start_ns, end_ns,
# attrs) — built whole, appended once (no partially-visible records)


def is_enabled() -> bool:
    """Fast gate for call sites that would otherwise build attrs dicts
    or format values just to have ``event()`` drop them."""
    return _ENABLED


def configure(enabled: bool | None = None,
              ring_size: int | None = None) -> None:
    """Install the node config: flip tracing on/off and/or resize the
    ring (existing records are kept up to the new bound).  Process-wide —
    in-proc ensembles share one flight recorder, records carry a
    ``node`` attr where it matters."""
    global _ENABLED, _RING, _MAXLEN
    with _CONF_LOCK:
        if ring_size is not None:
            size = max(16, int(ring_size))
            if size != _MAXLEN:
                _MAXLEN = size
                _RING = deque(_RING, maxlen=size)
        if enabled is not None:
            _ENABLED = bool(enabled)


def clear() -> None:
    _RING.clear()


# ------------------------------------------------------------------ emit


class _Open:
    """An in-flight span: handed out by :func:`begin`, turned into a ring
    record by :func:`finish`.  Nothing is visible in the ring until the
    span closes (a mid-span :func:`dump` shows completed work only)."""

    __slots__ = ("id", "parent", "sub", "name", "attrs", "t0", "wall0")


def begin(sub: str, name: str, **attrs) -> "_Open | None":
    """Open a span that outlives the current stack frame (consensus
    steps span many handler invocations).  Returns None when disabled —
    :func:`finish` accepts it."""
    if not _ENABLED:
        return None
    o = _Open.__new__(_Open)
    o.id = next(_SEQ)
    o.parent = _CUR.get()
    o.sub = sub
    o.name = name
    o.attrs = attrs
    # stamps ride the clock seam: under the sim's virtual clock the
    # ring orders by VIRTUAL time, which is what makes the scenario
    # lab's timeline verdicts a pure function of the seed.  With no
    # clock installed these are the exact raw calls they replace.
    if _clock._CLOCK is None:
        o.wall0 = time.time_ns()
        o.t0 = time.monotonic_ns()
    else:
        o.wall0 = _clock.walltime_ns()
        o.t0 = _clock.monotonic_ns()
    return o


def finish(open_: "_Open | None", **extra) -> None:
    """Close a span from :func:`begin`; ``extra`` attrs merge in (e.g.
    the verdict that was only known at the end)."""
    if open_ is None:
        return
    end = time.monotonic_ns() if _clock._CLOCK is None \
        else _clock.monotonic_ns()
    if extra:
        open_.attrs.update(extra)
    _RING.append(("span", open_.id, open_.parent, open_.sub, open_.name,
                  open_.wall0, open_.t0, end, open_.attrs))


def event(sub: str, name: str, **attrs) -> None:
    """Fire-and-forget point event."""
    if not _ENABLED:
        return
    if _clock._CLOCK is None:
        wall, t = time.time_ns(), time.monotonic_ns()
    else:
        wall, t = _clock.walltime_ns(), _clock.monotonic_ns()
    _RING.append(("event", next(_SEQ), _CUR.get(), sub, name,
                  wall, t, t, attrs))


class _SpanCM:
    """Context-manager span: sets itself as the current parent for the
    duration so nested ``span()``/``event()`` calls record ``parent``."""

    __slots__ = ("_sub", "_name", "_attrs", "_open", "_tok")

    def __init__(self, sub, name, attrs):
        self._sub = sub
        self._name = name
        self._attrs = attrs
        self._open = None
        self._tok = None

    def __enter__(self):
        self._open = begin(self._sub, self._name, **self._attrs)
        if self._open is not None:
            self._tok = _CUR.set(self._open.id)
        return self._open

    def __exit__(self, *exc):
        if self._open is not None:
            _CUR.reset(self._tok)
            finish(self._open)
        return False


class _NoopSpan:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NOOP = _NoopSpan()


def span(sub: str, name: str, **attrs):
    """Context manager measuring one lexical scope.  Disabled tracing
    returns a shared no-op instance: no per-call allocation."""
    if not _ENABLED:
        return _NOOP
    return _SpanCM(sub, name, attrs)


# ------------------------------------------------------------------ dump


def _jsonable(v):
    if isinstance(v, (bytes, bytearray)):
        return v.hex()
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return repr(v)


def _to_dict(rec) -> dict:
    kind, rid, parent, sub, name, wall0, t0, t1, attrs = rec
    return {
        "kind": kind, "id": rid, "parent": parent,
        "sub": sub, "name": name,
        "wall_ns": wall0,            # wall clock at start (cross-node)
        "start_ns": t0,              # monotonic: orders records
        "end_ns": t1,
        "dur_us": (t1 - t0) // 1000,
        "attrs": {k: _jsonable(v) for k, v in attrs.items()},
    }


def _rec_matches_height(attrs: dict, height: int) -> bool:
    """A record belongs to ``height`` when it stamps ``height`` exactly
    or its ``h_lo``..``h_hi`` window (batched emitters: a scheduler
    dispatch mixing heights) covers it."""
    h = attrs.get("height")
    if h is not None:
        return h == height
    lo, hi = attrs.get("h_lo"), attrs.get("h_hi")
    if lo is not None and hi is not None:
        return lo <= height <= hi
    return False


def snapshot() -> list[tuple]:
    """The raw ring as a list (newest last): the input of
    ``libs/timeline``; each element is the record tuple above."""
    return list(_RING)


def dump(limit: int = 1000, sub: str | None = None,
         height: int | None = None) -> list[dict]:
    """The newest ``limit`` COMPLETED records (``limit <= 0``: the whole
    ring) as JSON-able dicts, in completion order — sort by ``start_ns``
    to reconstruct the timeline, since spans append at finish.  ``sub``
    keeps one subsystem's records; ``height`` keeps records stamped with
    that height (exactly, or inside their ``h_lo``..``h_hi`` window).
    Filters apply BEFORE the limit, so ``limit=100&height=H`` is the
    newest 100 records OF that height."""
    recs = list(_RING)               # snapshot: writers keep appending
    if sub is not None:
        recs = [r for r in recs if r[3] == sub]
    if height is not None:
        h = int(height)
        recs = [r for r in recs if _rec_matches_height(r[8], h)]
    if limit and int(limit) > 0:
        recs = recs[-int(limit):]
    return [_to_dict(r) for r in recs]


def stats() -> dict:
    """The recorder's state, for ``/dump_trace``."""
    return {"enabled": _ENABLED, "ring_size": _MAXLEN,
            "buffered": len(_RING)}
