"""External SQL event sink (counterpart of ``cometbft_tpu/indexer/psql.py``;
reference: ``state/indexer/sink/psql/psql.go``).

Writes blocks, tx results, events and attributes to a relational
database so operators can query chain data with SQL and retain it
independently of the node.  Like the reference's psql sink it is
write-only from the node's perspective: ``tx_search``/``block_search``
are NOT served from SQL (the reference returns errors there too) — query
the database directly.

Backend: the DB-API 2.0 connection it is given (``conn``), with per-flavor
DDL (``postgres``, ``sqlite``) and SQL written to their common subset;
the tests pass stdlib ``sqlite3``.  The port imports no ``psycopg2``:
without a connection, a DSN (``tx_index.psql_conn``) raises
:class:`PsqlSinkError` with the JAX package's message for a missing
``psycopg2``, which is what the JAX package raises where it is not
installed.  The rows equal the JAX sink's, ``created_at`` aside.
"""

from __future__ import annotations

import json
import time

from ..mempool.mempool import TxKey

__all__ = ["PsqlSinkError", "PsqlEventSink"]


class PsqlSinkError(Exception):
    pass


_DDL = {
    "postgres": [
        """CREATE TABLE IF NOT EXISTS blocks (
             rowid BIGSERIAL PRIMARY KEY,
             height BIGINT NOT NULL,
             chain_id TEXT NOT NULL,
             created_at TIMESTAMPTZ NOT NULL DEFAULT now(),
             UNIQUE (height, chain_id))""",
        """CREATE TABLE IF NOT EXISTS tx_results (
             rowid BIGSERIAL PRIMARY KEY,
             block_id BIGINT NOT NULL REFERENCES blocks(rowid),
             index_in_block INTEGER NOT NULL,
             tx_hash TEXT NOT NULL,
             tx_result TEXT NOT NULL,
             UNIQUE (block_id, index_in_block))""",
        """CREATE TABLE IF NOT EXISTS events (
             rowid BIGSERIAL PRIMARY KEY,
             block_id BIGINT NOT NULL REFERENCES blocks(rowid),
             tx_id BIGINT REFERENCES tx_results(rowid),
             type TEXT NOT NULL)""",
        """CREATE TABLE IF NOT EXISTS attributes (
             event_id BIGINT NOT NULL REFERENCES events(rowid),
             key TEXT NOT NULL,
             composite_key TEXT NOT NULL,
             value TEXT)""",
    ],
    "sqlite": [
        """CREATE TABLE IF NOT EXISTS blocks (
             rowid INTEGER PRIMARY KEY AUTOINCREMENT,
             height INTEGER NOT NULL,
             chain_id TEXT NOT NULL,
             created_at REAL NOT NULL,
             UNIQUE (height, chain_id))""",
        """CREATE TABLE IF NOT EXISTS tx_results (
             rowid INTEGER PRIMARY KEY AUTOINCREMENT,
             block_id INTEGER NOT NULL REFERENCES blocks(rowid),
             index_in_block INTEGER NOT NULL,
             tx_hash TEXT NOT NULL,
             tx_result TEXT NOT NULL,
             UNIQUE (block_id, index_in_block))""",
        """CREATE TABLE IF NOT EXISTS events (
             rowid INTEGER PRIMARY KEY AUTOINCREMENT,
             block_id INTEGER NOT NULL REFERENCES blocks(rowid),
             tx_id INTEGER REFERENCES tx_results(rowid),
             type TEXT NOT NULL)""",
        """CREATE TABLE IF NOT EXISTS attributes (
             event_id INTEGER NOT NULL REFERENCES events(rowid),
             key TEXT NOT NULL,
             composite_key TEXT NOT NULL,
             value TEXT)""",
    ],
}


class PsqlEventSink:
    """Duck-types the TxIndexer/BlockIndexer surface the IndexerService
    pumps into, writing rows instead of kv postings."""

    def __init__(self, conn=None, dsn: str = "", chain_id: str = "",
                 flavor: str | None = None):
        if conn is None:
            raise PsqlSinkError(
                "tx_index.indexer='psql' needs the psycopg2 package "
                "(or pass a DB-API connection)")
        self.conn = conn
        self.chain_id = chain_id
        self.flavor = flavor or ("sqlite" if "sqlite3" in
                                 type(conn).__module__ else "postgres")
        self._ph = "%s" if self.flavor == "postgres" else "?"
        cur = self.conn.cursor()
        for stmt in _DDL[self.flavor]:
            cur.execute(stmt)
        self.conn.commit()

    # ------------------------------------------------------------ helpers

    def _exec(self, cur, sql: str, params=()):
        cur.execute(sql.replace("?", self._ph), params)

    def _insert_returning(self, cur, sql: str, params) -> int:
        if self.flavor == "postgres":
            self._exec(cur, sql + " RETURNING rowid", params)
            return cur.fetchone()[0]
        self._exec(cur, sql, params)
        return cur.lastrowid

    def _block_rowid(self, cur, height: int) -> int:
        self._exec(cur, "SELECT rowid FROM blocks WHERE height = ? AND "
                        "chain_id = ?", (height, self.chain_id))
        row = cur.fetchone()
        if row is not None:
            return row[0]
        if self.flavor == "postgres":
            # created_at is TIMESTAMPTZ DEFAULT now() — never bind a
            # float into it
            return self._insert_returning(
                cur, "INSERT INTO blocks (height, chain_id) "
                     "VALUES (?, ?)", (height, self.chain_id))
        return self._insert_returning(
            cur, "INSERT INTO blocks (height, chain_id, created_at) "
                 "VALUES (?, ?, ?)",
            (height, self.chain_id, time.time()))

    def _insert_events(self, cur, block_id: int, tx_id, events) -> None:
        """events: iterable of (type, [(key, value), ...])."""
        for etype, attrs in events:
            eid = self._insert_returning(
                cur, "INSERT INTO events (block_id, tx_id, type) "
                     "VALUES (?, ?, ?)", (block_id, tx_id, etype))
            for key, value in attrs:
                self._exec(cur,
                           "INSERT INTO attributes (event_id, key, "
                           "composite_key, value) VALUES (?, ?, ?, ?)",
                           (eid, key, f"{etype}.{key}", str(value)))

    # ---------------------------------------------------- indexer surface

    def index_block(self, height: int, events) -> None:
        """BlockIndexer surface: block-level (FinalizeBlock) events.
        ``events`` as the event bus delivers them:
        ``[(type, [(key, value), ...]), ...]``."""
        cur = self.conn.cursor()
        try:
            bid = self._block_rowid(cur, height)
            self._insert_events(cur, bid, None, events)
            self.conn.commit()
        except Exception:
            self.conn.rollback()
            raise

    def index(self, height: int, idx: int, tx: bytes, result,
              attrs: dict) -> None:
        """TxIndexer surface: one tx result + its events."""
        record = {
            "code": result.code, "log": result.log,
            "data": result.data.hex(), "gas_used": result.gas_used,
            "tx": tx.hex(),
        }
        cur = self.conn.cursor()
        try:
            bid = self._block_rowid(cur, height)
            tx_id = self._insert_returning(
                cur, "INSERT INTO tx_results (block_id, index_in_block, "
                     "tx_hash, tx_result) VALUES (?, ?, ?, ?)",
                (bid, idx, TxKey(tx).hex(), json.dumps(record)))
            self._insert_events(
                cur, bid, tx_id,
                [(e.type, [(a.key, a.value) for a in e.attributes])
                 for e in result.events])
            self.conn.commit()
        except Exception:
            self.conn.rollback()
            raise

    def block_indexer(self) -> "_BlockView":
        """The BlockIndexer-shaped facade the IndexerService pumps block
        events into (its ``index(height, events)`` signature differs
        from the tx ``index``)."""
        return _BlockView(self)

    # --------------------------------------------------- query surface

    def get(self, tx_hash: bytes):
        raise PsqlSinkError(
            "the psql sink is write-only from the node: query postgres "
            "directly (the reference sink equally serves no reads)")

    def search(self, query: str, page: int = 1, per_page: int = 30,
               order_by: str = "asc"):
        raise PsqlSinkError(
            "tx_search/block_search are not served by the psql sink: "
            "query postgres directly")

    def close(self) -> None:
        try:
            self.conn.close()
        except Exception:
            pass


class _BlockView:
    """Adapter matching BlockIndexer's ``index(height, events)``."""

    def __init__(self, sink: PsqlEventSink):
        self._sink = sink

    def index(self, height: int, events) -> None:
        self._sink.index_block(height, events)

    def search(self, *a, **k):
        return self._sink.search(*a, **k)
