"""Peer quality scoring (counterpart of ``cometbft_tpu/p2p/quality.py``):
one node-wide reputation ledger fed by every layer that detects
misbehavior (reference: the *idea* of
``p2p/peer_set`` bans + reactor ``StopPeerForError`` calls, unified —
the Go reference scatters punishment across reactors and bans forever;
here every detection funnels through :class:`PeerScorer` so responses
are proportional, decaying, and timed).

Design:

- **Typed events.**  Each misbehavior class carries a severity weight
  (:data:`EVENT_WEIGHTS`): a blocksync block that fails commit
  verification is near-certain malice (heavy), one rejected gossiped tx
  is routine app-level noise (feather-weight).  Unknown event names get
  :data:`DEFAULT_WEIGHT` so a new call site can never crash scoring.
- **Decaying score.**  A peer's score is the sum of its event weights
  decayed exponentially with half-life ``half_life_s``: an old offense
  fades, a burst accumulates.  Scores only move on report/read — no
  background task.
- **Two thresholds.**  Crossing ``disconnect_score`` disconnects the
  peer (the Switch re-admits it on the next dial); crossing
  ``ban_score`` issues a **timed** ban — TTL ``ban_ttl_s`` doubling per
  repeat offense up to ``ban_ttl_max_s`` — recorded in the address book
  (persisted across restarts) or a local map when no book exists.
- **Persistent peers are exempt from bans** (an operator pinned them on
  purpose): they are scored and disconnected like anyone else, and the
  Switch's persistent-reconnect machinery re-dials them.

The Switch owns the one scorer instance and is the only caller of
``report`` (reactors go through ``Switch.report_peer``); everything
here is synchronous, event-loop-thread-only state.
"""

from __future__ import annotations

from ..libs import clock

# Event taxonomy: every layer that detects misbehavior reports one of
# these, severity-weighted.  The default thresholds are 5 (disconnect)
# and 10 (ban): e.g. two bad blocks ban, five invalid votes disconnect.
EVENT_WEIGHTS: dict[str, float] = {
    # blocksync (pool.remove_peer / redo_request)
    "bad_block": 5.0,          # served a block that failed verification
    "block_timeout": 1.0,      # block request timed out (slow, not evil)
    # consensus reactor / state machine handler errors
    "invalid_vote": 2.0,       # bad signature / vote-set violation
    "invalid_part": 3.0,       # block part with a bad merkle proof
    "invalid_proposal": 3.0,   # bad proposal signature / shape
    # MConnection / switch dispatch
    "malformed_frame": 2.0,    # post-AEAD garbage: decode/oversize/chan
    "pong_timeout": 0.5,       # silent death; mostly a network signal
    "protocol_error": 2.0,     # reactor receive raised on peer input
    # mempool gossip
    "invalid_tx": 0.25,        # app-rejected gossiped tx
    # evidence gossip
    "bad_evidence": 5.0,       # unverifiable gossiped evidence
    # statesync
    "bad_snapshot_chunk": 5.0,  # manifest/app rejected this sender's
    #   chunks: provably bad bytes, two strikes is a ban
    "snapshot_timeout": 0.5,    # chunk request aged out: slow, not
    #   (provably) malicious — persistent molasses still adds up
}
DEFAULT_WEIGHT = 1.0

DISCONNECT_SCORE = 5.0
BAN_SCORE = 10.0
HALF_LIFE_S = 120.0
BAN_TTL_S = 60.0
BAN_TTL_MAX_S = 3600.0
MAX_TRACKED = 1024


class PeerMisbehaviorError(Exception):
    """Marker passed to ``Switch.stop_peer_for_error`` for disconnects
    the scorer itself ordered — the error classifier maps it to "already
    scored" so one offense is never double-counted."""

    def __init__(self, event: str, detail: str = ""):
        self.event = event
        self.detail = detail
        super().__init__(f"peer misbehavior: {event}"
                         + (f" ({detail})" if detail else ""))


class _PeerQ:
    __slots__ = ("score", "last_mono", "events", "total", "ban_count",
                 "last_event", "last_detail", "last_wall")

    def __init__(self):
        self.score = 0.0
        self.last_mono = 0.0
        self.events: dict[str, int] = {}
        self.total = 0
        self.ban_count = 0
        self.last_event = ""
        self.last_detail = ""
        self.last_wall = 0.0


class PeerScorer:
    def __init__(self, addr_book=None, *, enabled: bool = True,
                 disconnect_score: float = DISCONNECT_SCORE,
                 ban_score: float = BAN_SCORE,
                 half_life_s: float = HALF_LIFE_S,
                 ban_ttl_s: float = BAN_TTL_S,
                 ban_ttl_max_s: float = BAN_TTL_MAX_S,
                 max_tracked: int = MAX_TRACKED):
        self.enabled = enabled
        self.book = addr_book
        self.disconnect_score = disconnect_score
        self.ban_score = ban_score
        self.half_life_s = max(half_life_s, 1e-3)
        self.ban_ttl_s = ban_ttl_s
        self.ban_ttl_max_s = ban_ttl_max_s
        self.max_tracked = max_tracked
        self._peers: dict[str, _PeerQ] = {}
        # ban mirror: reason + expiry for reporting; the address book
        # (when present) is the durable, admission-authoritative copy
        self._bans: dict[str, dict] = {}
        self.bans_total = 0

    # ------------------------------------------------------------ scoring

    def _decayed(self, rec: _PeerQ, now: float) -> float:
        dt = now - rec.last_mono
        if dt <= 0:
            return rec.score
        return rec.score * 0.5 ** (dt / self.half_life_s)

    def report(self, peer_id: str, event: str, *, weight: float | None = None,
               persistent: bool = False, detail: str = "") -> str | None:
        """Record one misbehavior event.  Returns the ordered action:
        ``"ban"`` (threshold crossed, timed ban recorded here),
        ``"disconnect"``, or None (tolerated for now)."""
        if not self.enabled:
            return None
        now = clock.monotonic()
        rec = self._peers.get(peer_id)
        if rec is None:
            if len(self._peers) >= self.max_tracked:
                self._prune(now)
            rec = self._peers[peer_id] = _PeerQ()
            rec.last_mono = now
        w = EVENT_WEIGHTS.get(event, DEFAULT_WEIGHT) \
            if weight is None else weight
        rec.score = self._decayed(rec, now) + w
        rec.last_mono = now
        rec.total += 1
        rec.events[event] = rec.events.get(event, 0) + 1
        rec.last_event = event
        rec.last_detail = detail[:160]
        rec.last_wall = clock.walltime()
        # relative epsilon: the score decays over the (sub-ms) gap
        # between accumulation and compare, so a sum that lands exactly
        # ON a threshold must still count as crossing it
        if rec.score >= self.ban_score * (1.0 - 1e-3) and not persistent:
            ttl = min(self.ban_ttl_s * (2 ** rec.ban_count),
                      self.ban_ttl_max_s)
            rec.ban_count += 1
            rec.score = 0.0     # readmission starts from a clean slate
            self._ban(peer_id, ttl, event)
            return "ban"
        if rec.score >= self.disconnect_score * (1.0 - 1e-3):
            return "disconnect"
        return None

    def _prune(self, now: float) -> None:
        """Drop the stalest record so an id-churning attacker can't grow
        the ledger without bound.  Banned/repeat offenders are kept in
        preference to clean-slate entries."""
        victim = min(self._peers.items(),
                     key=lambda kv: (kv[1].ban_count > 0,
                                     self._decayed(kv[1], now),
                                     kv[1].last_mono))
        self._peers.pop(victim[0], None)

    def score(self, peer_id: str) -> float:
        rec = self._peers.get(peer_id)
        if rec is None:
            return 0.0
        return self._decayed(rec, clock.monotonic())

    # --------------------------------------------------------------- bans

    def _ban(self, peer_id: str, ttl: float, reason: str) -> None:
        expiry = clock.walltime() + ttl
        self.bans_total += 1
        self._bans[peer_id] = {"reason": reason, "expiry": expiry,
                               "ttl_s": ttl}
        if self.book is not None:
            self.book.mark_bad(peer_id, ttl=ttl)

    def is_banned(self, peer_id: str) -> bool:
        if self.book is not None and self.book.is_banned(peer_id):
            return True
        ban = self._bans.get(peer_id)
        if ban is None:
            return False
        if ban["expiry"] <= clock.walltime():
            self._bans.pop(peer_id, None)
            return False
        # the mirror rules only without a book (the book may have
        # expired the ban early, and wins then)
        return self.book is None

    # ---------------------------------------------------------- reporting

    def peer_info(self, peer_id: str) -> dict:
        """Per-peer quality block: score, event counts, ban history."""
        rec = self._peers.get(peer_id)
        if rec is None:
            return {"score": 0.0, "events_total": 0}
        return {
            "score": round(self._decayed(rec, clock.monotonic()), 3),
            "events_total": rec.total,
            "events": dict(rec.events),
            "ban_count": rec.ban_count,
            "last_event": rec.last_event or None,
            "last_detail": rec.last_detail or None,
        }

    def bans_snapshot(self) -> list[dict]:
        """Active bans (expired entries are dropped as a side effect)."""
        now = clock.walltime()
        out = []
        for pid in list(self._bans):
            ban = self._bans[pid]
            if ban["expiry"] <= now:
                self._bans.pop(pid, None)
                continue
            out.append({"node_id": pid, "reason": ban["reason"],
                        "expires_in_s": round(ban["expiry"] - now, 1),
                        "ttl_s": ban["ttl_s"]})
        if self.book is not None:
            # bans loaded from a persisted book have no mirror entry
            seen = {b["node_id"] for b in out}
            for pid, expiry in self.book.banned().items():
                if pid not in seen:
                    out.append({"node_id": pid, "reason": "persisted",
                                "expires_in_s": round(expiry - now, 1),
                                "ttl_s": None})
        return out

    def snapshot(self) -> dict:
        """Whole-ledger view for incident bundles and debugging."""
        now = clock.monotonic()
        return {
            "peers": {pid: {"score": round(self._decayed(r, now), 3),
                            "events": dict(r.events),
                            "ban_count": r.ban_count,
                            "last_event": r.last_event or None}
                      for pid, r in self._peers.items()},
            "bans": self.bans_snapshot(),
            "bans_total": self.bans_total,
        }
