"""Bucketed address book with anti-poisoning placement (counterpart of
``cometbft_tpu/p2p/addrbook.py``; reference: ``p2p/pex/addrbook.go``'s
old/new bucket design).

Threat model: a malicious peer floods PEX responses with addresses to
(1) evict known-good entries and (2) fill the book with nodes it
controls.  Defenses, mirroring the reference's design:

- **Two tiers.**  *New* buckets hold unvetted addresses learned from
  PEX/seeds; *old* buckets hold addresses we have successfully connected
  to.  Old entries are NEVER evicted by new-address pressure — only a
  confirmed-good address can displace one, and only by demotion rules.
- **Hashed placement.**  An address maps to one bucket via
  ``H(salt, source-group, addr-group)`` (new) or ``H(salt, addr-group)``
  (old), where a *group* is the /16-style prefix of the IP (or the whole
  host for names).  A flood from one source can only thrash the few
  buckets its groups hash to; the per-book random salt keeps placement
  unpredictable to attackers.
- **Bounded buckets.**  Each bucket holds at most ``BUCKET_SIZE``
  entries; overflow evicts the *worst new* entry in that bucket (most
  failed attempts, oldest) — never an old-tier entry.
- **Promotion / demotion.**  ``mark_good`` (successful handshake)
  promotes new -> old.  ``mark_attempt`` counts dial failures; entries
  past ``MAX_ATTEMPTS`` are dropped on the next overflow or pick.
  ``mark_bad`` issues a timed ban (TTL-expiring; the peer-quality
  scorer escalates repeat offenders).

The public surface (add/pick/sample/size/save/mark_*) is shared with the
PEX reactor and the seed crawler.  The book's salt and its generator
(``pick``, ``sample``) are arguments: the JAX book draws its salt from
``os.urandom`` and shuffles with the module ``random``, and the defaults
here do the same, but a caller (a test, a seeded run) can pin both.  The
JSON file, its legacy flat format and the placement hashes are the JAX
package's: each package loads the other's book.
"""

from __future__ import annotations

import hashlib
import json
import os
import random

from ..libs import clock

__all__ = ["N_NEW_BUCKETS", "N_OLD_BUCKETS", "BUCKET_SIZE",
           "BUCKETS_PER_SOURCE", "MAX_ATTEMPTS", "OLD_BIAS",
           "DEFAULT_BAN_TTL_S", "AddrBook"]

N_NEW_BUCKETS = 256
N_OLD_BUCKETS = 64
BUCKET_SIZE = 64
BUCKETS_PER_SOURCE = 16     # distinct new-buckets one source can reach:
#   a flood from one subnet lands in at most 16 of the 256 buckets
#   (<= 1024 entries), so >93% of the new tier is untouchable by any
#   single source, and the old tier entirely so
MAX_ATTEMPTS = 5            # dial failures before an entry is droppable
OLD_BIAS = 0.6              # chance pick() prefers the vetted tier
DEFAULT_BAN_TTL_S = 3600.0  # mark_bad without an explicit TTL


def _group(addr: str) -> str:
    """Coarse network group of a dialable address: first two octets of
    an IPv4 (the /16), the whole host otherwise.  Bucket placement
    granularity — one subnet maps to few buckets."""
    host = addr.rsplit(":", 1)[0].strip("[]")
    parts = host.split(".")
    if len(parts) == 4 and all(p.isdigit() for p in parts):
        return f"{parts[0]}.{parts[1]}"
    return host


class _Entry:
    __slots__ = ("node_id", "addr", "src_group", "added", "attempts",
                 "last_success")

    def __init__(self, node_id: str, addr: str, src_group: str):
        self.node_id = node_id
        self.addr = addr
        self.src_group = src_group
        self.added = clock.walltime()
        self.attempts = 0
        self.last_success = 0.0

    def to_json(self):
        return {"id": self.node_id, "addr": self.addr,
                "src": self.src_group, "added": self.added,
                "attempts": self.attempts, "ok": self.last_success}

    @classmethod
    def from_json(cls, d):
        e = cls(d["id"], d["addr"], d.get("src", ""))
        e.added = d.get("added", 0.0)
        e.attempts = d.get("attempts", 0)
        e.last_success = d.get("ok", 0.0)
        return e


class AddrBook:
    """Bucketed book.  ``salt`` (16 hex digits; a fresh random one by
    default, replaced by the file's) keys the placement hashes, ``rng``
    (a ``random.Random``; a fresh one by default) draws ``pick`` and
    ``sample``."""

    def __init__(self, path: str | None = None, salt: str | None = None,
                 rng: random.Random | None = None):
        self.path = path
        self._salt = salt if salt is not None else os.urandom(8).hex()
        self.rng = rng if rng is not None else random.Random()
        self._new: list[dict[str, _Entry]] = [
            {} for _ in range(N_NEW_BUCKETS)]
        self._old: list[dict[str, _Entry]] = [
            {} for _ in range(N_OLD_BUCKETS)]
        self._where: dict[str, tuple[str, int]] = {}   # id -> (tier, idx)
        # timed bans: id -> expiry (epoch seconds).  Bans used to be a
        # forever-set; now they expire so a transient bad actor (or a
        # node that restarted out of a corrupting state) is readmitted.
        self._banned: dict[str, float] = {}
        if path and os.path.exists(path):
            self._load()

    # ------------------------------------------------------------ placement

    def _hash(self, *parts: str) -> int:
        h = hashlib.sha256("|".join((self._salt,) + parts).encode())
        return int.from_bytes(h.digest()[:8], "big")

    def _new_bucket(self, e: _Entry) -> int:
        # double hash: the address group picks one of BUCKETS_PER_SOURCE
        # slots, the (source, slot) pair picks the bucket — so one source
        # group reaches at most BUCKETS_PER_SOURCE distinct buckets no
        # matter how many addresses it invents
        slot = self._hash("spread", e.src_group,
                          _group(e.addr)) % BUCKETS_PER_SOURCE
        return self._hash("new", e.src_group, str(slot)) % N_NEW_BUCKETS

    def _old_bucket(self, e: _Entry) -> int:
        return self._hash("old", _group(e.addr)) % N_OLD_BUCKETS

    # ------------------------------------------------------------- file io

    def _load(self) -> None:
        try:
            with open(self.path) as f:
                d = json.load(f)
        except (OSError, json.JSONDecodeError):
            return
        self._salt = d.get("salt", self._salt)
        banned = d.get("banned", {})
        if isinstance(banned, dict):
            # current schema: {node_id: expiry}; expired entries drop,
            # and an uncoercible expiry (hand-edited file) counts as
            # expired rather than refusing to boot the node
            now = clock.walltime()
            self._banned = {}
            for nid, exp in banned.items():
                try:
                    exp = float(exp)
                except (TypeError, ValueError):
                    continue
                if exp > now:
                    self._banned[nid] = exp
        else:
            # legacy bare list (the forever-ban era): those bans carried
            # no expiry, so treat them as already expired on load — a
            # peer banned by an old build is readmitted, not doomed
            self._banned = {}
        for tier, key in (("new", "new"), ("old", "old")):
            for ed in d.get(key, []):
                e = _Entry.from_json(ed)
                self._place(e, tier)
        # legacy flat format ({"addrs": {id: addr}}): import as new tier
        for nid, addr in d.get("addrs", {}).items():
            if nid not in self._where and not self.is_banned(nid):
                self._place(_Entry(nid, addr, _group(addr)), "new")

    SAVE_INTERVAL_S = 10.0      # debounce for hot-path mutations: the
    #   reference dumps the book on a ticker, not per handshake

    def save(self) -> None:
        """Unconditional full dump (shutdown / explicit persistence)."""
        if not self.path:
            return
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            now = clock.walltime()
            json.dump({
                "salt": self._salt,
                "new": [e.to_json() for b in self._new for e in b.values()],
                "old": [e.to_json() for b in self._old for e in b.values()],
                "banned": {nid: exp for nid, exp in self._banned.items()
                           if exp > now},
            }, f, indent=1)
        os.replace(tmp, self.path)
        self._last_save = clock.walltime()

    def save_debounced(self) -> None:
        """Hot-path persistence (every handshake/PEX response mutates
        the book): a multi-MB JSON dump per event would block the p2p
        loop, so writes are throttled to one per SAVE_INTERVAL_S; the
        book is a cache — losing the last few seconds on crash is fine
        (PexReactor.stop() flushes via save())."""
        if clock.walltime() - getattr(self, "_last_save", 0.0) >= \
                self.SAVE_INTERVAL_S:
            self.save()

    # ------------------------------------------------------------- mutation

    def _place(self, e: _Entry, tier: str) -> bool:
        """Insert into the tier's hashed bucket, respecting capacity.
        New-tier overflow evicts the worst *new* entry of that bucket;
        old-tier overflow refuses (old entries are precious)."""
        if tier == "old":
            idx = self._old_bucket(e)
            bucket = self._old[idx]
            if e.node_id not in bucket and len(bucket) >= BUCKET_SIZE:
                return False
        else:
            idx = self._new_bucket(e)
            bucket = self._new[idx]
            if e.node_id not in bucket and len(bucket) >= BUCKET_SIZE:
                worst = max(bucket.values(),
                            key=lambda x: (x.attempts, -x.added))
                del bucket[worst.node_id]
                self._where.pop(worst.node_id, None)
        bucket[e.node_id] = e
        self._where[e.node_id] = (tier, idx)
        return True

    def _get(self, node_id: str) -> _Entry | None:
        loc = self._where.get(node_id)
        if loc is None:
            return None
        tier, idx = loc
        return (self._old if tier == "old" else self._new)[idx].get(node_id)

    def add(self, node_id: str, addr: str, persist: bool = True,
            source: str = "", proven: bool = False) -> bool:
        """Learn an address.  ``source`` is the advertising peer's own
        address (its group scopes which new-bucket the entry can land
        in).  Hearsay never displaces an old-tier entry; a PROVEN
        address (we dialed it successfully — pex outbound path) replaces
        any entry and lands directly in the vetted tier, so a peer that
        moved updates cleanly."""
        if not addr or self.is_banned(node_id):
            return False

        cur = self._get(node_id)
        if cur is not None:
            if cur.addr == addr:
                return False
            tier = self._where[node_id][0]
            if tier == "old" and not proven:
                return False           # vetted address wins over hearsay
            self._drop(node_id)
        e = _Entry(node_id, addr, _group(source or addr))
        if proven:
            e.last_success = clock.walltime()
            ok = self._place(e, "old") or self._place(e, "new")
        else:
            ok = self._place(e, "new")
        if ok and persist:
            self.save_debounced()
        return ok

    def _drop(self, node_id: str) -> None:
        loc = self._where.pop(node_id, None)
        if loc is not None:
            tier, idx = loc
            (self._old if tier == "old" else self._new)[idx].pop(
                node_id, None)

    def mark_good(self, node_id: str) -> None:
        """Successful connection/handshake: promote to the old tier
        (addrbook.go MarkGood)."""
        e = self._get(node_id)
        if e is None:
            return
        e.attempts = 0
        e.last_success = clock.walltime()
        if self._where[node_id][0] != "old":
            self._drop(node_id)
            if not self._place(e, "old"):
                self._place(e, "new")      # old bucket full: stay new
        self.save_debounced()

    def mark_attempt(self, node_id: str) -> None:
        e = self._get(node_id)
        if e is None:
            return
        e.attempts += 1
        if e.attempts > MAX_ATTEMPTS:
            if self._where[node_id][0] == "old":
                # repeated failures demote a vetted entry back to the
                # unvetted tier (attempts kept) — so a peer that moved
                # can finally have its stale address replaced by
                # hearsay, and further failures drop it entirely
                self._drop(node_id)
                e.attempts = MAX_ATTEMPTS      # one more failure drops
                self._place(e, "new")
            else:
                self._drop(node_id)

    def mark_bad(self, node_id: str,
                 ttl: float = DEFAULT_BAN_TTL_S) -> None:
        """Timed ban and forget (addrbook MarkBad, but with a TTL — the
        caller escalates repeat offenders; forever-bans are gone)."""
        self._banned[node_id] = clock.walltime() + ttl
        self._drop(node_id)
        self.save_debounced()

    def is_banned(self, node_id: str) -> bool:
        """Active-ban check; an expired ban is dropped on read so the
        peer is readmitted without any sweeper."""
        exp = self._banned.get(node_id)
        if exp is None:
            return False
        if exp <= clock.walltime():
            self._banned.pop(node_id, None)
            return False
        return True

    def banned(self) -> dict[str, float]:
        """Active bans as {node_id: expiry-epoch-seconds}."""
        now = clock.walltime()
        for nid in [n for n, exp in self._banned.items() if exp <= now]:
            self._banned.pop(nid, None)
        return dict(self._banned)

    # ------------------------------------------------------------ selection

    def _tier_items(self, tier) -> list[_Entry]:
        return [e for b in tier for e in b.values()]

    def pick(self, exclude: set[str], n: int = 1) -> list[tuple[str, str]]:
        """Dial candidates, biased toward the vetted old tier."""
        old = [e for e in self._tier_items(self._old)
               if e.node_id not in exclude]
        new = [e for e in self._tier_items(self._new)
               if e.node_id not in exclude and e.attempts <= MAX_ATTEMPTS]
        rng = self.rng
        rng.shuffle(old)
        rng.shuffle(new)
        out = []
        while len(out) < n and (old or new):
            use_old = old and (not new or rng.random() < OLD_BIAS)
            e = (old if use_old else new).pop()
            out.append((e.node_id, e.addr))
        return out

    def sample(self, n: int = 32) -> list[tuple[str, str]]:
        """Random address sample for a PEX response (both tiers)."""
        all_e = self._tier_items(self._old) + self._tier_items(self._new)
        self.rng.shuffle(all_e)
        return [(e.node_id, e.addr) for e in all_e[:n]]

    def is_good(self, node_id: str) -> bool:
        loc = self._where.get(node_id)
        return loc is not None and loc[0] == "old"

    def size(self) -> int:
        return len(self._where)

    def num_old(self) -> int:
        return sum(len(b) for b in self._old)

    def num_new(self) -> int:
        return sum(len(b) for b in self._new)
