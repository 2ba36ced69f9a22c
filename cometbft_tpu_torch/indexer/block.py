"""Block indexer (counterpart of ``cometbft_tpu/indexer/block.py``;
reference: ``state/indexer/block/kv``): postings from block-level app
events to heights, for ``block_search``."""

from __future__ import annotations

from ..libs.query import Query
from ..storage.db import KVStore, MemDB
from ..types import _msgpack

K_HEIGHT = b"bi/"          # K_HEIGHT + height8 -> msgpack events
K_ATTR = b"ba/"            # K_ATTR + key + 0 + value + 0 + height8


class BlockIndexer:
    def __init__(self, db: KVStore | None = None):
        self.db = db or MemDB()

    def index(self, height: int, events: list) -> None:
        stored = [(e.type, [(a.key, str(a.value)) for a in e.attributes])
                  for e in events]
        batch = {K_HEIGHT + height.to_bytes(8, "big"):
                 _msgpack.packb(stored)}
        postings = [("block.height", str(height))]
        for e in events:
            for a in e.attributes:
                if getattr(a, "index", True):
                    postings.append((f"{e.type}.{a.key}", str(a.value)))
        for k, v in postings:
            batch[(K_ATTR + k.encode() + b"\x00" + v.encode() + b"\x00"
                   + height.to_bytes(8, "big"))] = b""
        self.db.set_batch(batch)

    def has(self, height: int) -> bool:
        return self.db.get(K_HEIGHT + height.to_bytes(8, "big")) is not None

    def search(self, query: str, page: int = 1, per_page: int = 30,
               order_by: str = "asc") -> dict:
        """Full-grammar search; equality clauses use postings, the rest
        post-filters against stored events (see TxIndexer.search)."""
        q = Query.parse(query)
        # tm.event is implied (every record here is a block event); strip
        # those conditions so any value the client used (NewBlock /
        # NewBlockEvents) is tolerated, matching the old posting-path pop
        conds = [c for c in q.conditions if c.key != "tm.event"]
        if len(conds) != len(q.conditions):
            q = Query(conds) if conds else None
        eq = q.equality_clauses() if q else {}
        heights: set[int] | None = None
        for k, v in eq.items():
            prefix = (K_ATTR + k.encode() + b"\x00" + v.encode() + b"\x00")
            found = {int.from_bytes(key[-8:], "big")
                     for key, _ in self.db.iterate(prefix,
                                                   prefix + b"\xff" * 9)}
            heights = found if heights is None else heights & found
        if heights is None:
            heights = {int.from_bytes(k[len(K_HEIGHT):], "big")
                       for k, _ in self.db.iterate(
                           K_HEIGHT, K_HEIGHT + b"\xff" * 9)}
        kept = []
        for h in heights:
            if q is None:
                kept.append(h)
                continue
            raw = self.db.get(K_HEIGHT + h.to_bytes(8, "big"))
            m: dict[str, list[str]] = {"block.height": [str(h)]}
            if raw:
                for etype, attrs in _msgpack.unpackb(raw):
                    for k, v in attrs:
                        m.setdefault(f"{etype}.{k}", []).append(v)
                conds = q.conditions
            else:
                # legacy row (pre-events storage, value b""): equality
                # conditions were satisfied by posting narrowing and
                # block.height is decidable, but ranges/CONTAINS/EXISTS
                # on event attributes are UNDECIDABLE — treat them as
                # non-matching rather than returning false positives
                # (reindex via `reindex-event` to make them queryable)
                undecidable = [c for c in q.conditions
                               if c.key != "block.height"
                               and not (c.op == "="
                                        and eq.get(c.key) == c.arg)]
                if undecidable:
                    continue
                conds = [c for c in q.conditions if c.key == "block.height"]
            if all(c.matches(m.get(c.key)) for c in conds):
                kept.append(h)
        ordered = sorted(kept, reverse=(order_by == "desc"))
        page, per_page = max(1, int(page)), min(100, max(1, int(per_page)))
        start = (page - 1) * per_page
        return {"heights": ordered[start:start + per_page],
                "total_count": len(ordered)}
