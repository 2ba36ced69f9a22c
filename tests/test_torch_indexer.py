"""The port's kv indexers (``cometbft_tpu_torch/indexer``) against the JAX
package's on the same seeded tx results and block events: every record
and posting byte for byte (the records are MessagePack, packed by the
port's own subset, ``types/_msgpack.py``, and by ``msgpack`` in the JAX
package), ``get`` equal, and ``tx_search`` / ``block_search`` pages equal
over a seeded set of queries, pages, page sizes and orders.  Also the
port's ``IndexerService`` fed by its event bus, as the node runs it."""

import asyncio

import msgpack
import numpy as np
import pytest

from cometbft_tpu.abci import types as JA
from cometbft_tpu.indexer import BlockIndexer as JBlock
from cometbft_tpu.indexer import TxIndexer as JTx
from cometbft_tpu.libs.query import QuerySyntaxError as JErr
from cometbft_tpu_torch.abci import types as TA
from cometbft_tpu_torch.indexer import BlockIndexer as TBlock
from cometbft_tpu_torch.indexer import IndexerService
from cometbft_tpu_torch.indexer import TxIndexer as TTx
from cometbft_tpu_torch.libs.pubsub import EventBus
from cometbft_tpu_torch.libs.query import QuerySyntaxError as TErr
from cometbft_tpu_torch.mempool.mempool import TxKey
from cometbft_tpu_torch.types import _msgpack
from cometbft_tpu_torch.types import events as ev

HEIGHTS = 12
TYPES = ("transfer", "app", "reward")
KEYS = ("to", "amount", "key", "sender", "note")


def _events(rng, A, n):
    out = []
    for _ in range(n):
        attrs = [A.EventAttribute(KEYS[rng.integers(len(KEYS))],
                                  ("v%d" % rng.integers(6)) if rng.random()
                                  < 0.7 else "%duatom" % rng.integers(500),
                                  bool(rng.random() < 0.85))
                 for _ in range(rng.integers(1, 4))]
        out.append(A.Event(TYPES[rng.integers(len(TYPES))], attrs))
    return out


def _chain(seed: int):
    """Per height: block events and txs with their results and attrs,
    in both packages' types, from one seed."""
    out = {"tx": [], "block": []}
    for pkg, A in (("j", JA), ("t", TA)):
        rng = np.random.default_rng(seed)
        txs, blocks = [], []
        for h in range(1, HEIGHTS + 1):
            blocks.append((h, _events(rng, A, rng.integers(0, 3))))
            for i in range(rng.integers(0, 5)):
                tx = b"tx-%d-%d-" % (h, i) + rng.bytes(rng.integers(1, 40))
                res = A.ExecTxResult(code=int(rng.integers(0, 3)),
                                     data=rng.bytes(rng.integers(0, 9)),
                                     log="log%d" % i,
                                     gas_used=int(rng.integers(0, 1 << 40)),
                                     events=_events(rng, A,
                                                    rng.integers(0, 4)))
                attrs = {ev.TX_HASH_KEY: TxKey(tx).hex(),
                         ev.TX_HEIGHT_KEY: str(h)}
                txs.append((h, i, tx, res, attrs))
        out["tx"].append(txs)
        out["block"].append(blocks)
    return out


def _indexed(seed: int):
    c = _chain(seed)
    jt, tt, jb, tb = JTx(), TTx(), JBlock(), TBlock()
    for (jtx, ttx) in zip(*c["tx"]):
        jt.index(*jtx)
        tt.index(*ttx)
    for (jblk, tblk) in zip(*c["block"]):
        jb.index(*jblk)
        tb.index(*tblk)
    return jt, tt, jb, tb, c


TX_QUERIES = (
    "tm.event='Tx'", "tx.height=3", "tx.height>=4 AND tx.height<9",
    "transfer.to='v1'", "transfer.to='v1' AND tx.height>2",
    "app.key EXISTS", "reward.amount CONTAINS 'uatom'",
    "transfer.amount > 100", "tm.event='Tx' AND app.note='v3'",
    "sender.x EXISTS", "reward.note='v0' AND reward.to='v2'",
    "tx.height = 5 AND transfer.amount <= 250")
BLOCK_QUERIES = (
    "block.height=4", "block.height > 6", "tm.event='NewBlock'",
    "tm.event='NewBlockEvents' AND transfer.to='v2'", "app.key EXISTS",
    "reward.amount CONTAINS 'uatom'", "transfer.amount >= 10",
    "block.height<=3 AND app.note='v1'")


@pytest.mark.parametrize("seed", range(3))
def test_records_and_postings_byte_for_byte(seed):
    jt, tt, jb, tb, c = _indexed(seed)
    assert tt.db._data == jt.db._data
    assert tb.db._data == jb.db._data
    assert len(tt.db._data) > 20
    for h, i, tx, res, attrs in c["tx"][1]:
        key = TxKey(tx)
        assert tt.get(key) == jt.get(key)
        raw = tt.db.get(b"ti/" + key)
        assert _msgpack.unpackb(raw) == msgpack.unpackb(raw, raw=False)
    assert tt.get(b"\x00" * 32) is None is jt.get(b"\x00" * 32)
    for h in range(1, HEIGHTS + 2):
        assert tb.has(h) == jb.has(h)


@pytest.mark.parametrize("seed", range(3))
def test_search_pages_equal_jax(seed):
    jt, tt, jb, tb, _ = _indexed(seed)
    rng = np.random.default_rng(50 + seed)
    hits = 0
    for q in TX_QUERIES:
        for order in ("asc", "desc"):
            page, per = int(rng.integers(1, 3)), int(rng.integers(1, 8))
            got = tt.search(q, page, per, order_by=order)
            assert got == jt.search(q, page, per, order_by=order), q
            hits += got["total_count"]
    for q in BLOCK_QUERIES:
        for order in ("asc", "desc"):
            page, per = int(rng.integers(1, 3)), int(rng.integers(1, 6))
            got = tb.search(q, page, per, order_by=order)
            assert got == jb.search(q, page, per, order_by=order), q
            hits += got["total_count"]
    assert hits > 0
    for bad in ("tx.height >", "a = 1 OR b = 2"):
        with pytest.raises(JErr) as je:
            jt.search(bad)
        with pytest.raises(TErr) as te:
            tt.search(bad)
        assert str(te.value) == str(je.value)


def test_service_indexes_what_the_bus_publishes():
    """The node's wiring: ``IndexerService`` pumps Tx and NewBlockEvents
    messages of the port's event bus into its indexers, which then hold
    the bytes of direct indexing."""
    jt, _, jb, _, c = _indexed(7)

    async def main():
        bus = EventBus()
        svc = IndexerService(bus, TTx(), TBlock(), name="t.idx")
        await svc.start()
        for h, events in c["block"][1]:
            bus.publish(ev.EVENT_NEW_BLOCK_EVENTS,
                        {"events": events, "height": str(h)},
                        {ev.BLOCK_HEIGHT_KEY: str(h)})
        for h, i, tx, res, attrs in c["tx"][1]:
            bus.publish(ev.EVENT_TX, {"tx": tx, "result": res, "height": h,
                                      "index": i}, attrs)
        bus.publish(ev.EVENT_NEW_BLOCK, {}, {})      # not indexed
        for _ in range(100):
            await asyncio.sleep(0)
        await svc.stop()
        assert bus.num_subscribers() == 0
        return svc

    svc = asyncio.run(main())
    assert svc.tx_indexer.db._data == jt.db._data
    assert svc.block_indexer.db._data == jb.db._data
