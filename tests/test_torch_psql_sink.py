"""The port's SQL event sink (``cometbft_tpu_torch/indexer/psql.py``)
against the JAX package's: the six cases of ``tests/test_psql_sink.py``,
each feeding the same calls to both sinks, each over its own stdlib
``sqlite3`` connection, and the four tables must be equal row for row
(``created_at`` aside, a wall-clock stamp); the errors are the same
class name and text.  Then the node's wiring: ``tx_index.indexer =
"psql"`` with a DSN and no ``psycopg2`` raises the same
``PsqlSinkError`` at ``Node.create`` in both packages, and the node's
indexer service pumps a live port validator's blocks and txs into a
sink over ``sqlite3``: one ``blocks`` row a height and one
``tx_results`` row a committed tx."""

import asyncio
import json
import sqlite3

import pytest

import torch_node_fixtures as tnf
from cometbft_tpu.abci import types as JA
from cometbft_tpu.indexer import psql as J
from cometbft_tpu_torch.abci import types as PA
from cometbft_tpu_torch.indexer import psql as P
from torch_node_fixtures import no_host_verify  # noqa: F401

TABLES = {"blocks": "rowid, height, chain_id",
          "tx_results": "rowid, block_id, index_in_block, tx_hash, "
                        "tx_result",
          "events": "rowid, block_id, tx_id, type",
          "attributes": "event_id, key, composite_key, value"}


def _rows(sink) -> dict:
    cur = sink.conn.cursor()
    out = {}
    for table, cols in TABLES.items():
        cur.execute(f"SELECT {cols} FROM {table} ORDER BY rowid")
        out[table] = cur.fetchall()
    return out


def _result(A, events):
    return A.ExecTxResult(code=0, data=b"\x01", log="ok", gas_used=5,
                          events=events)


def _both(script):
    """``script(mod, abci_types, sink)`` on a JAX and a port sink over
    two in-memory sqlite3 databases: each side's outcome (a value, or the
    error's class name and text) and tables."""
    out = []
    for mod, A in ((J, JA), (P, PA)):
        sink = mod.PsqlEventSink(conn=sqlite3.connect(":memory:"),
                                 chain_id="sql-chain")
        try:
            try:
                got = ("ok", script(mod, A, sink))
            except Exception as e:
                got = (type(e).__name__, str(e))
            out.append((got, _rows(sink)))
        finally:
            sink.close()
    assert out[0] == out[1]
    return out[1]


def test_tx_and_block_rows():
    def script(mod, A, sink):
        ev = [A.Event(type="transfer", attributes=[
            A.EventAttribute(key="sender", value="alice"),
            A.EventAttribute(key="amount", value="7")])]
        sink.index(height=3, idx=0, tx=b"tx-bytes", result=_result(A, ev),
                   attrs={"tx.height": "3"})
        sink.index_block(3, [("rewards", [("validator", "v1")])])

    got, rows = _both(script)
    assert got == ("ok", None)
    assert [r[1:] for r in rows["blocks"]] == [(3, "sql-chain")]
    (tx,) = rows["tx_results"]
    rec = json.loads(tx[4])
    assert tx[2] == 0 and rec["tx"] == b"tx-bytes".hex() \
        and rec["gas_used"] == 5
    # tx-scoped and block-scoped events distinguished by tx_id
    assert [(t, tx_id is not None) for _, _, tx_id, t in rows["events"]] \
        == [("transfer", True), ("rewards", False)]
    assert [(c, v) for _, _, c, v in rows["attributes"]] == [
        ("transfer.sender", "alice"), ("transfer.amount", "7"),
        ("rewards.validator", "v1")]


def test_one_block_row_per_height():
    def script(mod, A, sink):
        for i in range(3):
            sink.index(height=9, idx=i, tx=b"t%d" % i,
                       result=_result(A, []), attrs={})

    _, rows = _both(script)
    assert len(rows["blocks"]) == 1 and len(rows["tx_results"]) == 3


def test_rollback_on_failure():
    class Boom:
        type = "x"

        @property
        def attributes(self):
            raise RuntimeError("boom")

    def script(mod, A, sink):
        sink.index(height=1, idx=0, tx=b"ok", result=_result(A, []),
                   attrs={})
        sink.index(height=1, idx=1, tx=b"t", result=_result(A, [Boom()]),
                   attrs={})

    got, rows = _both(script)
    assert got == ("RuntimeError", "boom")
    assert len(rows["tx_results"]) == 1      # the partial insert rolled back


def test_write_only_surface():
    for call in (lambda s: s.get(b"\x00" * 32),
                 lambda s: s.search("tx.height = 1")):
        got, _ = _both(lambda mod, A, sink: call(sink))
        assert got[0] == "PsqlSinkError"


def test_missing_psycopg2_is_a_clear_error():
    errs = []
    for mod in (J, P):
        with pytest.raises(mod.PsqlSinkError, match="psycopg2") as e:
            mod.PsqlEventSink(dsn="postgres://nowhere/none")
        errs.append(str(e.value))
    assert errs[0] == errs[1]


def test_block_indexer_facade_matches_service_signature():
    """IndexerService pumps block events via ``.index(height, events)``;
    the sink's BlockIndexer facade must accept exactly that call."""
    def script(mod, A, sink):
        bi = sink.block_indexer()
        bi.index(4, [("upgrade", [("version", "2")])])
        try:
            bi.search("x = 1")
        except mod.PsqlSinkError as e:
            return str(e)

    got, rows = _both(script)
    assert got[0] == "ok" and "not served" in got[1]
    assert [(t, tx_id) for _, _, tx_id, t in rows["events"]] == [
        ("upgrade", None)]


# ------------------------------------------------------------------ node

def test_node_psql_indexer_without_psycopg2_raises_alike():
    from cometbft_tpu.abci.kvstore import KVStoreApplication as JApp
    from cometbft_tpu.config import Config as JConfig
    from cometbft_tpu.config import test_consensus_config
    from cometbft_tpu.node import Node as JNode
    from cometbft_tpu.types.genesis import GenesisDoc as JDoc
    from cometbft_tpu.types.genesis import GenesisValidator as JVal
    from cometbft_tpu.types.priv_validator import MockPV as JPV
    from cometbft_tpu_torch.abci.kvstore import KVStoreApplication

    async def main():
        errs = []
        jpv = JPV.from_secret(b"sql0")
        jcfg = JConfig(consensus=test_consensus_config())
        jcfg.p2p.laddr = "tcp://127.0.0.1:0"
        jcfg.rpc.laddr = ""
        jcfg.tx_index.indexer = "psql"
        jcfg.tx_index.psql_conn = "postgres://nowhere/none"
        jcfg.validate()
        with pytest.raises(J.PsqlSinkError) as e:
            await JNode.create(JDoc(chain_id="sql-net", validators=[
                JVal(jpv.get_pub_key(), 10)]), JApp(),
                priv_validator=jpv, config=jcfg)
        errs.append(str(e.value))
        doc, pvs = tnf.genesis(1, chain_id="sql-net", tag=b"sql")
        cfg = tnf.config()
        cfg.tx_index.indexer = "psql"
        cfg.tx_index.psql_conn = "postgres://nowhere/none"
        cfg.validate()
        with pytest.raises(P.PsqlSinkError) as e:
            await tnf.make_node(doc, pvs[0], 0, config_=cfg,
                                app=KVStoreApplication(device="cpu"))
        errs.append(str(e.value))
        return errs

    errs = tnf.run(main())
    assert errs[0] == errs[1] and "psycopg2" in errs[0]


def test_indexer_service_pumps_a_live_node_into_the_sink():
    from cometbft_tpu_torch.indexer import IndexerService

    async def main():
        doc, pvs = tnf.genesis(1, chain_id="sql-net", tag=b"sql")
        node = await tnf.make_node(doc, pvs[0], 0)
        sink = P.PsqlEventSink(conn=sqlite3.connect(":memory:"),
                               chain_id="sql-net")
        svc = IndexerService(node.event_bus, sink, sink.block_indexer(),
                             name="sql.idx")
        await svc.start()
        await node.start()
        try:
            for tx in (b"a=1", b"b=2", b"c=3"):
                await node.mempool.check_tx(tx)
            await tnf.wait_height([node], 4)
            await asyncio.sleep(0.2)        # the pump's last events
            top = node.height()
            committed = sum(len(node.block_store.load_block(h).data.txs)
                            for h in range(1, top + 1))
        finally:
            await node.stop()
            await svc.stop()
        rows = _rows(sink)
        sink.close()
        return top, committed, rows

    top, committed, rows = tnf.run(main())
    heights = [h for _, h, _ in rows["blocks"]]
    assert heights == sorted(set(heights))
    assert set(range(1, top)) <= set(heights) <= set(range(1, top + 1))
    assert committed == 3
    assert len(rows["tx_results"]) == 3
    assert {json.loads(r[4])["tx"] for r in rows["tx_results"]} == {
        b"a=1".hex(), b"b=2".hex(), b"c=3".hex()}
