"""The port's consensus WAL (``cometbft_tpu_torch/consensus/wal.py``, its
records packed by the port's own MessagePack subset) against the JAX
package's (``msgpack``), on the CPU.  The same consensus records (votes
with extensions, proposals, block parts with their proofs, timeouts,
height sentinels; contents from numpy seeds, made by each package's
``_msg_to_wire``) written through both WALs must give equal segment
files, byte for byte, with rotation and pruning; each package must read
the other's files to the same records; and a torn tail, a torn write
(the ``wal.write.torn`` site), a corrupt record and a failed fsync
(``wal.fsync.eio``) must be handled alike."""

import os

import numpy as np
import pytest

from cometbft_tpu.consensus import state as JS
from cometbft_tpu.consensus import wal as JW
from cometbft_tpu.libs import failures as JF
from cometbft_tpu.types import codec as JC
from cometbft_tpu.types.part_set import PartSet as JPartSet
from cometbft_tpu_torch.consensus import state as TS
from cometbft_tpu_torch.consensus import wal as TW
from cometbft_tpu_torch.libs import failures as TF
from cometbft_tpu_torch.types import _msgpack
from cometbft_tpu_torch.types import codec as TC
from cometbft_tpu_torch.types.block_id import BlockID, PartSetHeader
from cometbft_tpu_torch.types.part_set import PartSet
from cometbft_tpu_torch.types.vote import Proposal, Vote

pytestmark = pytest.mark.timeout(120)

PACKAGES = {"port": (TW, TS, TF), "jax": (JW, JS, JF)}


def _records(seed, heights=4, votes=6):
    """(port records, JAX records) of ``heights`` heights: a proposal, its
    block parts, votes (precommits with extensions) and a timeout a
    height, then the height's sentinel (written with write_end_height by
    the caller, marked here as ("end", h))."""
    rng = np.random.default_rng(seed)
    tr, jr = [], []
    for h in range(1, heights + 1):
        data = rng.integers(0, 256, int(rng.integers(100, 9000)),
                            np.uint8).tobytes()
        tps = PartSet.from_data(data, part_size=4096, device="cpu")
        jps = JPartSet.from_data(data, part_size=4096)
        bid = BlockID(rng.integers(0, 256, 32, np.uint8).tobytes(),
                      tps.header())
        prop = Proposal(height=h, round=0, pol_round=-1, block_id=bid,
                        timestamp_ns=int(rng.integers(1, 2**62)),
                        signature=rng.integers(0, 256, 64,
                                               np.uint8).tobytes())
        items = [("proposal", prop, "")]
        items += [("part", (h, 0, tps.get_part(i)), "peer%d" % (i % 3))
                  for i in range(tps.total)]
        for i in range(votes):
            v = Vote(type=1 + i % 2, height=h, round=int(rng.integers(0, 3)),
                     block_id=bid if i % 4 else BlockID(),
                     timestamp_ns=int(rng.integers(1, 2**62)),
                     validator_address=rng.integers(0, 256, 20,
                                                    np.uint8).tobytes(),
                     validator_index=i,
                     signature=rng.integers(0, 256, 64, np.uint8).tobytes())
            if v.type == 2 and i % 4:
                v.extension = b"ext%d" % i
                v.extension_signature = rng.integers(
                    0, 256, 64, np.uint8).tobytes()
            items.append(("vote", v, "" if i == 0 else "peer%d" % i))
        for kind, obj, peer in items:
            tr.append({"#": kind, "peer": peer,
                       "data": TS._msg_to_wire(kind, obj)})
            if kind == "part":
                jobj = (h, 0, jps.get_part(obj[2].index))
            else:
                jobj = JC.unpack(TC.pack(obj))
            jr.append({"#": kind, "peer": peer,
                       "data": JS._msg_to_wire(kind, jobj)})
        ti = {"#": "timeout", "ti": {"d": int(rng.integers(1, 10**9)),
                                     "h": h, "r": 0, "s": 3}}
        tr.append(ti)
        jr.append(dict(ti))
        tr.append(("end", h))
        jr.append(("end", h))
    return tr, jr


def _write(mod, path, records, seg, sync_every=5, prune=True):
    wal = mod.WAL(path, max_segment_bytes=seg)
    for k, rec in enumerate(records):
        if isinstance(rec, tuple):
            wal.write_end_height(rec[1])
            if not prune:
                wal._prev_sentinel_seg = None
        elif k % sync_every == 0:
            wal.write_sync(rec)
        else:
            wal.write(rec)
    wal.flush_and_sync()
    return wal


def _after(wal, h):
    """``records_after_height(h)``, or the error's text (a pruned WAL
    has jumped past the heights it dropped)."""
    try:
        return wal.records_after_height(h)
    except Exception as e:
        return ("err", str(e))


def _files(mod, path):
    return [(os.path.basename(p), open(p, "rb").read())
            for p in mod.wal_segments(path)]


@pytest.mark.parametrize("seed,seg,prune", [(1, 4 << 20, True),
                                            (2, 6000, True),
                                            (3, 5000, False)])
def test_same_records_same_files_and_cross_reads(tmp_path, seed, seg, prune):
    tr, jr = _records(seed, heights=5)
    tp, jp = str(tmp_path / "t" / "cs.wal"), str(tmp_path / "j" / "cs.wal")
    tw = _write(TW, tp, tr, seg, prune=prune)
    jw = _write(JW, jp, jr, seg, prune=prune)
    assert [r for r in tr if not isinstance(r, tuple)] == \
        [r for r in jr if not isinstance(r, tuple)]
    tf, jf = _files(TW, tp), _files(JW, jp)
    assert tf == jf
    if seg < 10_000:
        assert len(tf) > 1                       # rotation happened
    for h in range(0, 6):
        assert _after(tw, h) == _after(jw, h)
    assert list(tw.iter_records()) == list(jw.iter_records())
    tw.close()
    jw.close()
    # each reads the other's files
    cross_t, cross_j = TW.WAL(jp, max_segment_bytes=seg), \
        JW.WAL(tp, max_segment_bytes=seg)
    for h in range(0, 6):
        assert _after(cross_t, h) == _after(cross_j, h)
    recs = list(cross_t.iter_records())
    assert recs == list(cross_j.iter_records())
    cross_t.close()
    cross_j.close()
    # the port decodes the JAX package's records into its own objects
    for rec in recs:
        if rec["#"] in ("proposal", "vote", "part"):
            obj = TS._msg_from_wire(rec["#"], rec["data"])
            assert _msgpack.packb(TS._msg_to_wire(rec["#"], obj)) == \
                _msgpack.packb(rec["data"])


def test_torn_tail_and_corrupt_record_handled_alike(tmp_path):
    tr, jr = _records(4, heights=3)
    out = {}
    for name, recs in (("port", tr), ("jax", jr)):
        mod = PACKAGES[name][0]
        path = str(tmp_path / name / "cs.wal")
        _write(mod, path, recs, 6000, prune=False).close()
        segs = mod.wal_segments(path)
        # a corrupt byte in the middle of the first segment, a torn
        # tail on the last
        with open(segs[0], "r+b") as f:
            f.seek(os.path.getsize(segs[0]) // 2)
            b = f.read(1)
            f.seek(-1, 1)
            f.write(bytes([b[0] ^ 0xFF]))
        with open(segs[-1], "ab") as f:
            f.write(b"\x13\x37garbage-torn-tail")
        wal = mod.WAL(path, max_segment_bytes=6000)
        out[name] = (list(wal.iter_records()), wal.records_after_height(0),
                     [open(p, "rb").read() for p in mod.wal_segments(path)])
        wal.close()
    assert out["port"] == out["jax"]
    assert len(out["port"][0]) < len(tr)


@pytest.mark.parametrize("cut", ["header", "body"])
def test_torn_write_truncated_alike(tmp_path, cut):
    out = {}
    for name, (mod, _, fail) in PACKAGES.items():
        path = str(tmp_path / name / "cs.wal")
        wal = mod.WAL(path)
        for i in range(5):
            wal.write_sync({"#": "vote", "n": i, "pad": "x" * 40})
        wal.close()
        size_before = os.path.getsize(path)
        wal = mod.WAL(path)
        fail.configure(enabled=True, seed=13,
                       faults=[f"wal.write.torn:at=1:cut={cut}"])
        try:
            with pytest.raises(mod.WALError):
                wal.write({"#": "vote", "n": 99, "pad": "y" * 40})
            with pytest.raises(mod.WALError):
                wal.write({"#": "vote", "n": -1})
            torn = open(path, "rb").read()
        finally:
            fail.reset()
            wal.close()
        wal = mod.WAL(path)
        recs = [r["n"] for r in wal.iter_records()]
        assert os.path.getsize(path) == size_before
        wal.write_sync({"#": "vote", "n": 100})
        out[name] = (torn, recs, open(path, "rb").read())
        wal.close()
    assert out["port"] == out["jax"]
    assert out["port"][1] == [0, 1, 2, 3, 4]


def test_fsync_eio_kills_handle_alike(tmp_path):
    import errno

    out = {}
    for name, (mod, _, fail) in PACKAGES.items():
        path = str(tmp_path / name / "cs.wal")
        wal = mod.WAL(path)
        wal.write_sync({"#": "vote", "n": 1})
        fail.configure(enabled=True, seed=3, faults=["wal.fsync.eio:at=1"])
        try:
            with pytest.raises(OSError) as ei:
                wal.write_sync({"#": "vote", "n": 2})
            assert ei.value.errno == errno.EIO
            for op in (wal.flush_and_sync,
                       lambda: wal.write({"#": "vote", "n": 3})):
                with pytest.raises(mod.WALError):
                    op()
        finally:
            fail.reset()
        wal2 = mod.WAL(path)
        out[name] = [r["n"] for r in wal2.iter_records()]
        wal2.close()
    assert out["port"] == out["jax"] == [1, 2]


def test_jumped_height_and_missing_sentinel(tmp_path):
    out = {}
    for name, (mod, _, _) in PACKAGES.items():
        path = str(tmp_path / name / "cs.wal")
        wal = mod.WAL(path)
        wal.write({"#": "vote", "n": 0})
        wal.write_end_height(3)
        wal.write({"#": "vote", "n": 1})
        res = []
        for h in (0, 2, 3, 4):
            try:
                res.append(("ok", wal.records_after_height(h)))
            except mod.WALError as e:
                res.append(("err", str(e)))
        out[name] = res
        wal.close()
    assert out["port"] == out["jax"]
    assert out["port"][1][0] == "err"


def test_oversized_record_rejected_alike(tmp_path):
    for name, (mod, _, _) in PACKAGES.items():
        wal = mod.WAL(str(tmp_path / name / "cs.wal"))
        with pytest.raises(mod.WALError, match="record too big"):
            wal.write({"#": "part", "b": b"\x00" * (mod.MAX_BODY + 1)})
        wal.close()
