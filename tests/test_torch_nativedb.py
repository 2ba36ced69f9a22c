"""The port's native KV store and trees (``csrc/host/kvstore.cpp`` through
``cometbft_tpu_torch/storage/nativedb.py`` and ``native.merkle_root`` /
``merkle_levels``) against the JAX package's (``cometbft_tpu/storage/
nativedb.py``, ``cometbft_tpu/crypto/merkle.py:_levels_native``), on the
CPU.

The store: the same seeded operations (set, get, delete, batch, iterate
over ranges, close and reopen) on a port ``NativeDB`` and a JAX
``NativeDB`` give equal reads after every step and equal files; each
package, and ``LogDB``, opens the other's file.  The trees: the native
root and levels against the JAX package's native levels and the hashlib
loop at 0, 1, 2, 3, 63, 64, 65, 1,000 and 2,047 leaves, and the port's
``merkle.py`` on its native route; a node runs on native stores.
Comparisons are exact."""

import numpy as np
import pytest

from cometbft_tpu.crypto import merkle as JM
from cometbft_tpu.storage import db as jdb
from cometbft_tpu.storage import nativedb as jnative
from cometbft_tpu_torch import native
from cometbft_tpu_torch.crypto import merkle as TM
from cometbft_tpu_torch.storage import db as tdb
from cometbft_tpu_torch.storage import nativedb as tnative

pytestmark = pytest.mark.timeout(120)

LEAVES = (0, 1, 2, 3, 63, 64, 65, 1000, 2047)


def _same_file(a, b):
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()


def _ops(seed: int, n: int = 300):
    """Seeded operations over a small key space (so deletes and
    overwrites hit live keys)."""
    rng = np.random.default_rng(seed)
    keys = [b"k%03d" % i for i in range(40)]
    ops = []
    for _ in range(n):
        r = rng.random()
        k = keys[int(rng.integers(0, len(keys)))]
        if r < 0.55:
            ops.append(("set", k, rng.integers(0, 256, int(rng.integers(
                0, 80)), np.uint8).tobytes()))
        elif r < 0.75:
            ops.append(("delete", k, None))
        elif r < 0.9:
            batch = {}
            for _ in range(int(rng.integers(1, 6))):
                bk = keys[int(rng.integers(0, len(keys)))]
                batch[bk] = (None if rng.random() < 0.3 else
                             rng.integers(0, 256, 9, np.uint8).tobytes())
            ops.append(("batch", batch, None))
        else:
            ops.append(("reopen", None, None))
    return ops


def _reads(db):
    return ([(k, db.get(k)) for k in (b"k000", b"k017", b"k039", b"none")],
            list(db.iterate()), list(db.iterate(b"k010", b"k020")),
            list(db.iterate(b"k035")), db.size())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_store_matches_jax_on_seeded_operations(tmp_path, seed):
    tp, jp = str(tmp_path / "t" / "kv.db"), str(tmp_path / "j" / "kv.db")
    t, j = tnative.NativeDB(tp), jnative.NativeDB(jp)
    try:
        for op, a, b in _ops(seed):
            for db in (t, j):
                if op == "set":
                    db.set(a, b)
                elif op == "delete":
                    db.delete(a)
                elif op == "batch":
                    db.set_batch(a)
            if op == "reopen":
                t.close()
                j.close()
                t, j = tnative.NativeDB(tp), jnative.NativeDB(jp)
            assert _reads(t) == _reads(j)
    finally:
        t.close()
        j.close()
    _same_file(tp, jp)


def test_files_cross_open(tmp_path):
    tp, jp = str(tmp_path / "t.db"), str(tmp_path / "j.db")
    t, j = tnative.NativeDB(tp), jnative.NativeDB(jp)
    for db in (t, j):
        db.set(b"a", b"1")
        db.set_batch({b"b": b"2", b"c": None, b"d": b"4"})
        db.delete(b"d")
        db.close()
    for path in (tp, jp):
        for opener in (tnative.NativeDB, jnative.NativeDB, tdb.LogDB,
                       jdb.LogDB):
            db = opener(path)
            assert list(db.iterate()) == [(b"a", b"1"), (b"b", b"2")]
            db.close()


def test_torn_tail_truncated_alike(tmp_path):
    tp, jp = str(tmp_path / "t.db"), str(tmp_path / "j.db")
    for opener, path in ((tnative.NativeDB, tp), (jnative.NativeDB, jp)):
        db = opener(path)
        db.set(b"x", b"y" * 10)
        db.set(b"z", b"w")
        db.close()
        with open(path, "ab") as f:
            f.write(b"\x01\x02\x03")          # a torn record
        db = opener(path)
        assert list(db.iterate()) == [(b"x", b"y" * 10), (b"z", b"w")]
        db.set(b"q", b"r")
        db.close()
    _same_file(tp, jp)


def test_open_db_native_through_the_port(tmp_path):
    db = tdb.open_db("native", str(tmp_path / "sub" / "n.db"))
    db.set(b"k", b"v")
    db.close()
    db = tdb.open_db("native", str(tmp_path / "sub" / "n.db"))
    assert db.get(b"k") == b"v" and db.has(b"k") and not db.has(b"x")
    db.close()


def _items(n: int, seed: int):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, int(k), np.uint8).tobytes()
            for k in rng.integers(0, 150, n)]


@pytest.mark.parametrize("n", LEAVES)
def test_trees_match_jax_and_hashlib(n):
    items = _items(n, n)
    want_root = JM.hash_from_byte_slices(items)
    assert native.merkle_root(items) == want_root
    levels = native.merkle_levels(items)
    if n == 0:
        assert levels == []
        return
    assert levels == TM._levels_hashlib(items) == JM._levels_hashlib(items)
    jlevels = JM._levels_native(items)
    if jlevels is not None:
        assert levels == jlevels
    assert levels[-1] == [want_root]


@pytest.mark.parametrize("n", [64, 65, 300, 2047])
def test_merkle_host_route_matches_jax(n, monkeypatch):
    """``merkle.py``'s native route (64 to 2,047 leaves): roots and
    proofs equal to the JAX package's and the recursive reference, with
    the hashlib level loop not called."""
    def refuse(items):
        raise AssertionError("hashlib level loop on the native route")

    monkeypatch.setattr(TM, "_levels_hashlib", refuse)
    items = _items(n, 100 + n)
    want = JM.hash_from_byte_slices(items)
    assert TM.hash_from_byte_slices_fast(items, device="cpu") == want
    root, proofs = TM.proofs_from_byte_slices(items, device="cpu")
    ref_root, ref_proofs = TM.proofs_from_byte_slices_reference(items)
    jroot, jproofs = JM.proofs_from_byte_slices(items)
    assert root == ref_root == jroot == want
    assert [p.aunts for p in proofs] == [p.aunts for p in ref_proofs] == \
        [p.aunts for p in jproofs]


def test_closed_store_raises(tmp_path):
    db = tnative.NativeDB(str(tmp_path / "c.db"))
    db.close()
    with pytest.raises(tnative.NativeDBError):
        db.get(b"k")
    with pytest.raises(tnative.NativeDBError):
        list(db.iterate())


def test_node_runs_on_the_native_backend(tmp_path, monkeypatch):
    """``storage.db_backend = "native"`` through ``Node.create``: a lone
    validator commits on native stores, stops, and a node restarted from
    its home reads the same blocks back; the JAX ``NativeDB`` reads the
    port's block store file."""
    import asyncio

    from cometbft_tpu_torch.abci.kvstore import KVStoreApplication
    from cometbft_tpu_torch.config import MS, Config, test_consensus_config
    from cometbft_tpu_torch.crypto import _ed25519_py as ref
    from cometbft_tpu_torch.crypto import scheduler as vsched
    from cometbft_tpu_torch.node import Node
    from cometbft_tpu_torch.p2p import NodeKey
    from cometbft_tpu_torch.types.genesis import GenesisDoc, GenesisValidator
    from cometbft_tpu_torch.types.priv_validator import MockPV

    def refuse(*a, **kw):
        raise AssertionError("host oracle called on the node path")

    monkeypatch.setattr(ref, "verify_zip215", refuse)
    vsched.set_scheduler(None)
    pv = MockPV.from_secret(b"native-node")
    doc = GenesisDoc(chain_id="native-net",
                     validators=[GenesisValidator(pv.get_pub_key(), 10)])
    home = str(tmp_path / "home")

    def config():
        cc = test_consensus_config()
        cc.timeout_propose = 2000 * MS
        cfg = Config(consensus=cc)
        cfg.p2p.laddr = "tcp://127.0.0.1:0"
        cfg.rpc.laddr = ""
        cfg.base.device = "cpu"
        cfg.storage.db_backend = "native"
        return cfg

    async def make():
        return await Node.create(doc, KVStoreApplication(device="cpu"),
                                 priv_validator=pv, config=config(),
                                 node_key=NodeKey.from_secret(b"nn"),
                                 home=home, name="native0")

    async def main():
        node = await make()
        assert all(isinstance(db, tnative.NativeDB) for db in node._dbs)
        try:
            await node.start()
            await node.mempool.check_tx(b"nk=nv")

            async def reach(h):
                while node.height() < h:
                    await asyncio.sleep(0.05)

            await asyncio.wait_for(reach(3), 60)
            hashes = {h: node.block_store.load_block(h).hash()
                      for h in range(1, 4)}
        finally:
            await node.stop()
        back = await make()
        try:
            assert back.height() >= 3
            assert {h: back.block_store.load_block(h).hash()
                    for h in range(1, 4)} == hashes
        finally:
            await back.stop()
        assert vsched.get_scheduler() is None
        return hashes

    loop = asyncio.new_event_loop()
    try:
        loop.run_until_complete(main())
    finally:
        loop.close()
    path = str(tmp_path / "home" / "data" / "blockstore.db")
    t, j = tnative.NativeDB(path), jnative.NativeDB(path)
    try:
        assert list(t.iterate()) == list(j.iterate())
    finally:
        t.close()
        j.close()
