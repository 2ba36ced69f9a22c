"""The port's ``LogDB`` and ``open_db`` (``cometbft_tpu_torch/storage/
db.py``) against the JAX package's, on the CPU: the cases of
``tests/test_storage_abci.py:33,58`` (crash recovery with a torn tail,
compaction) run on both packages side by side, the files are equal byte
for byte after every step, each package opens the other's file, a
mid-log corruption is salvaged alike (equal quarantine sidecar, dirty
marker and survivors), and a seeded random workload of sets, deletes
and batches leaves equal files and equal reads.  A block store and a
state store over ``LogDB`` files written by one package load in the
other."""

import os

import numpy as np
import pytest

from cometbft_tpu.storage import db as jdb
from cometbft_tpu_torch.storage import db as tdb

pytestmark = pytest.mark.timeout(120)


def _both(tmp_path, name="kv.log"):
    tp, jp = str(tmp_path / ("t-" + name)), str(tmp_path / ("j-" + name))
    return tp, jp


def _same_file(a, b):
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()


def test_logdb_crash_recovery(tmp_path):
    tp, jp = _both(tmp_path)
    for mod, path in ((tdb, tp), (jdb, jp)):
        db = mod.LogDB(path)
        db.set(b"a", b"1")
        db.set(b"b", b"2")
        db.set(b"a", b"3")
        db.delete(b"b")
        db.close()
    _same_file(tp, jp)
    for mod, path in ((tdb, jp), (jdb, tp)):          # each reads the other's
        db2 = mod.LogDB(path)
        assert db2.get(b"a") == b"3" and db2.get(b"b") is None
        db2.close()
    for path in (tp, jp):
        with open(path, "ab") as f:
            f.write(b"\x01\x02\x03garbage-partial-record")
    for mod, path in ((tdb, tp), (jdb, jp)):
        db3 = mod.LogDB(path)
        assert db3.get(b"a") == b"3"
        db3.set(b"c", b"4")
        db3.close()
    _same_file(tp, jp)
    db4 = tdb.LogDB(jp)
    assert db4.get(b"c") == b"4"
    assert list(db4.iterate(b"a", b"c")) == [(b"a", b"3")]
    db4.close()


def test_logdb_compaction(tmp_path):
    tp, jp = _both(tmp_path)
    for mod, path in ((tdb, tp), (jdb, jp)):
        db = mod.LogDB(path)
        for _ in range(300):
            db.set(b"key", b"v" * 4096)
        db.set(b"other", b"x")
        assert os.path.getsize(path) < 1 << 21
        db.close()
    _same_file(tp, jp)
    for mod, path in ((tdb, jp), (jdb, tp)):
        db2 = mod.LogDB(path)
        assert db2.get(b"key") == b"v" * 4096 and db2.get(b"other") == b"x"
        db2.close()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_workload_files_equal(tmp_path, seed):
    rng = np.random.default_rng(seed)
    tp, jp = _both(tmp_path)
    t, j = tdb.LogDB(tp), jdb.LogDB(jp)
    keys = [b"k%03d" % i for i in range(40)]
    for _ in range(400):
        op = int(rng.integers(0, 10))
        k = keys[int(rng.integers(0, len(keys)))]
        if op < 6:
            v = rng.integers(0, 256, int(rng.integers(0, 3000)),
                             dtype=np.uint8).tobytes()
            t.set(k, v), j.set(k, v)
        elif op < 8:
            t.delete(k), j.delete(k)
        else:
            batch = {}
            for _ in range(int(rng.integers(1, 6))):
                kk = keys[int(rng.integers(0, len(keys)))]
                batch[kk] = None if rng.integers(0, 3) == 0 else \
                    rng.integers(0, 256, 100, dtype=np.uint8).tobytes()
            t.set_batch(dict(batch)), j.set_batch(dict(batch))
    assert list(t.iterate()) == list(j.iterate())
    assert list(t.iterate(b"k010", b"k020")) == \
        list(j.iterate(b"k010", b"k020"))
    t.close(), j.close()
    _same_file(tp, jp)
    t2, j2 = tdb.LogDB(jp), jdb.LogDB(tp)
    assert list(t2.iterate()) == list(j2.iterate())
    t2.close(), j2.close()


def test_mid_log_corruption_salvaged_alike(tmp_path):
    tp, jp = _both(tmp_path)
    for mod, path in ((tdb, tp), (jdb, jp)):
        db = mod.LogDB(path)
        for i in range(20):
            db.set(b"k%02d" % i, b"value-%02d" % i * 10)
        db.close()
        with open(path, "r+b") as f:
            f.seek(700)
            b = f.read(1)
            f.seek(700)
            f.write(bytes([b[0] ^ 0x40]))
    t, j = tdb.LogDB(tp), jdb.LogDB(jp)
    assert t.salvaged and j.salvaged
    assert t.salvage_spans == j.salvage_spans
    assert list(t.iterate()) == list(j.iterate())
    assert t.is_dirty() and j.is_dirty()
    assert t.dirty_info() == {"spans": [list(s) for s in t.salvage_spans],
                              "file": "t-kv.log"}
    t.close(), j.close()
    _same_file(tp, jp)
    _same_file(tp + ".quarantine", jp + ".quarantine")


def test_open_db_backends(tmp_path):
    assert isinstance(tdb.open_db("memdb"), tdb.MemDB)
    db = tdb.open_db("logdb", str(tmp_path / "x.db"))
    assert isinstance(db, tdb.LogDB)
    db.close()
    with pytest.raises(ValueError):
        tdb.open_db("logdb")
    from cometbft_tpu_torch.storage.nativedb import NativeDB

    db = tdb.open_db("native", str(tmp_path / "n.db"))
    assert isinstance(db, NativeDB)
    db.close()
    with pytest.raises(ValueError):
        tdb.open_db("native")
    with pytest.raises(ValueError):
        tdb.open_db("leveldb", str(tmp_path / "l.db"))


def test_data_dir_lock(tmp_path):
    lock = tdb.DataDirLock(str(tmp_path / "data"))
    with pytest.raises(RuntimeError):
        tdb.DataDirLock(str(tmp_path / "data"))
    lock.release()
    tdb.DataDirLock(str(tmp_path / "data")).release()


def test_stores_over_logdb_cross_load(tmp_path):
    """A JAX chain's block and state stores written to LogDB files by
    one package load in the other with equal records."""
    from torch_blocksync_fixtures import jax_chain

    chain = jax_chain()
    records = sorted(chain.block_dbs[-1].items()) + \
        sorted(chain.state_dbs[-1].items())
    tp, jp = _both(tmp_path, "stores.db")
    t, j = tdb.LogDB(tp), jdb.LogDB(jp)
    t.set_batch(dict(records)), j.set_batch(dict(records))
    t.close(), j.close()
    _same_file(tp, jp)
    from cometbft_tpu_torch.storage.blockstore import BlockStore
    from cometbft_tpu_torch.storage.statestore import StateStore

    t2 = tdb.LogDB(jp)
    bs, ss = BlockStore(t2), StateStore(t2)
    assert bs.height() == chain.block_store.height()
    top = bs.height()
    assert bs.load_block(top).hash() == \
        chain.block_store.load_block(top).hash()
    assert ss.load().app_hash == chain.state_store.load().app_hash
    t2.close()
