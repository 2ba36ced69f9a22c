"""Transaction indexer (counterpart of ``cometbft_tpu/indexer/tx.py``;
reference: ``state/txindex/kv/kv.go``): a record by tx hash and a
posting for every indexed app-event attribute, so that ``tx_search``
answers ``app.key='v' AND tx.height=5``.  Records are MessagePack
(``types/_msgpack.py``), byte for byte the JAX package's."""

from __future__ import annotations

from ..libs.query import Query
from ..mempool.mempool import TxKey
from ..storage.db import KVStore, MemDB
from ..types import _msgpack

K_TX = b"ti/"              # K_TX + hash -> record
K_ATTR = b"ta/"            # K_ATTR + key + 0 + value + 0 + height8 + hash


class TxIndexer:
    def __init__(self, db: KVStore | None = None):
        self.db = db or MemDB()

    def index(self, height: int, idx: int, tx: bytes, result,
              attrs: dict[str, str]) -> None:
        h = TxKey(tx)
        record = {
            "height": height, "index": idx, "tx": tx,
            "code": result.code, "log": result.log, "data": result.data,
            "gas_used": result.gas_used,
            "events": [(e.type, [(a.key, a.value) for a in e.attributes])
                       for e in result.events],
        }
        batch: dict[bytes, bytes] = {K_TX + h: _msgpack.packb(
            record)}
        # one posting PER OCCURRENCE: repeated attribute keys (two
        # transfer events with different recipients) must all be findable
        postings = [(k, v) for k, v in attrs.items()]
        postings.append(("tx.height", str(height)))
        for e in result.events:
            for a in e.attributes:
                if getattr(a, "index", True):
                    postings.append((f"{e.type}.{a.key}", str(a.value)))
        for k, v in postings:
            batch[_attr_key(k, v, height, h)] = b""
        self.db.set_batch(batch)

    def get(self, tx_hash: bytes) -> dict | None:
        raw = self.db.get(K_TX + tx_hash)
        if raw is None:
            return None
        return _record(tx_hash, _msgpack.unpackb(raw))

    def search(self, query: str, page: int = 1, per_page: int = 30,
               order_by: str = "asc") -> dict:
        """Full-grammar search (``libs/query``): plain string-equality
        clauses narrow candidates via the posting index; every remaining
        condition (ranges, CONTAINS, EXISTS, numeric equality) post-filters
        against the record's reconstructed event map — same result as the
        reference kv indexer's range scans (``state/txindex/kv/kv.go``)."""
        q = Query.parse(query)
        eq = q.equality_clauses()
        eq.pop("tm.event", None)             # implied: these are all txs
        result_hashes: set[bytes] | None = None
        for k, v in eq.items():
            found = set()
            prefix = _attr_prefix(k, v)
            for key, _ in self.db.iterate(prefix, prefix + b"\xff" * 9):
                found.add(key[-32:])
            result_hashes = found if result_hashes is None \
                else result_hashes & found
        if result_hashes is None:
            result_hashes = {k[len(K_TX):]
                             for k, _ in self.db.iterate(
                                 K_TX, K_TX + b"\xff" * 33)}
        records = []
        for h in result_hashes:
            raw = self.db.get(K_TX + h)
            if raw is None:
                continue
            d = _msgpack.unpackb(raw)
            if q.matches(_event_map(h, d)):
                records.append(_record(h, d))
        records.sort(key=lambda r: (r["height"], r["index"]),
                     reverse=(order_by == "desc"))
        page, per_page = max(1, int(page)), min(100, max(1, int(per_page)))
        start = (page - 1) * per_page
        return {"txs": records[start:start + per_page],
                "total_count": len(records)}


def _record(tx_hash: bytes, d: dict) -> dict:
    """The tx endpoint/search response shape, built from a decoded
    stored record (single source of truth for both)."""
    return {
        "hash": tx_hash.hex(), "height": d["height"],
        "index": d["index"], "tx": d["tx"].hex(),
        "tx_result": {"code": d["code"], "log": d["log"],
                      "data": d["data"].hex(),
                      "gas_used": d["gas_used"]},
    }


def _event_map(tx_hash: bytes, record: dict) -> dict[str, list[str]]:
    """Composite-key -> values map for query post-filtering, mirroring the
    attributes the live event bus publishes for a Tx event."""
    m: dict[str, list[str]] = {
        "tm.event": ["Tx"],
        "tx.height": [str(record["height"])],
        # lowercase hex, matching the live event bus attr (TxKey().hex())
        "tx.hash": [tx_hash.hex()],
    }
    for etype, attrs in record["events"]:
        for k, v in attrs:
            m.setdefault(f"{etype}.{k}", []).append(str(v))
    return m


def _attr_key(key: str, value: str, height: int, tx_hash: bytes) -> bytes:
    return (K_ATTR + key.encode() + b"\x00" + value.encode() + b"\x00"
            + height.to_bytes(8, "big") + tx_hash)


def _attr_prefix(key: str, value: str) -> bytes:
    return K_ATTR + key.encode() + b"\x00" + value.encode() + b"\x00"
