"""Part sets of the port against the JAX package's: ``BitArray``,
``ConsensusParams.hash``, ``PartSet.from_data`` (header, every part's
bytes and proof) and ``add_part`` (the same parts accepted, the same
refused with the same error), on seeded data."""

import numpy as np
import pytest
import torch

from cometbft_tpu.crypto import merkle as JM
from cometbft_tpu.libs.bits import BitArray as JBits
from cometbft_tpu.types import params as JParams
from cometbft_tpu.types import part_set as JPS
from cometbft_tpu_torch.crypto import merkle as TM
from cometbft_tpu_torch.libs.bits import BitArray as TBits
from cometbft_tpu_torch.types import params as TParams
from cometbft_tpu_torch.types import part_set as TPS

torch.set_num_threads(1)

SIZES = (0, 1, 65_535, 65_536, 65_537, 3 * 65_536 + 5)


def _data(n, seed=7):
    return np.random.default_rng(seed + n).integers(
        0, 256, n, dtype=np.uint8).tobytes()


def _bits_state(b):
    return (b.size, b.get_true_indices(), str(b), b.is_empty(), b.is_full(),
            b.num_true_bits())


@pytest.mark.parametrize("size", [0, 1, 7, 64, 65, 300])
def test_bit_array_matches_jax(size):
    rng = np.random.default_rng(size)
    a_idx = rng.integers(0, max(size, 1), size // 2 + 1).tolist()
    b_idx = rng.integers(0, max(size, 1), size // 3 + 1).tolist()
    ja, jb = JBits.from_indices(size, a_idx), JBits.from_indices(size + 3,
                                                                 b_idx)
    ta, tb = TBits.from_indices(size, a_idx), TBits.from_indices(size + 3,
                                                                 b_idx)
    for j, t in ((ja, ta), (jb, tb), (ja.or_(jb), ta.or_(tb)),
                 (ja.and_(jb), ta.and_(tb)), (ja.not_(), ta.not_()),
                 (ja.sub(jb), ta.sub(tb)), (ja.copy(), ta.copy())):
        assert _bits_state(t) == _bits_state(j)
    for i in (-1, 0, size - 1, size, size + 5):
        assert ta.get_index(i) == ja.get_index(i)
        assert ta.set_index(i, True) == ja.set_index(i, True)
        assert _bits_state(ta) == _bits_state(ja)
        assert ta.set_index(i, False) == ja.set_index(i, False)
        assert _bits_state(ta) == _bits_state(ja)
    full = TBits(size, (1 << size) - 1)
    assert full.is_full() and full.num_true_bits() == size
    with pytest.raises(ValueError):
        TBits(-1)


def test_pick_random_matches_jax():
    import random

    idx = [1, 5, 9, 30]
    j, t = JBits.from_indices(40, idx), TBits.from_indices(40, idx)
    assert t.pick_random(random.Random(3)) == j.pick_random(random.Random(3))
    assert TBits(8).pick_random() == (0, False)


@pytest.mark.parametrize("fields", [
    {}, {"max_bytes": 1, "max_gas": -1},
    {"max_bytes": 22020096, "max_gas": 0, "max_age": 7, "app": 3,
     "ext": 11, "pbts": 4}])
def test_consensus_params_hash_matches_jax(fields):
    def make(mod):
        p = mod.default_consensus_params()
        p.block.max_bytes = fields.get("max_bytes", p.block.max_bytes)
        p.block.max_gas = fields.get("max_gas", p.block.max_gas)
        p.evidence.max_age_num_blocks = fields.get(
            "max_age", p.evidence.max_age_num_blocks)
        p.version.app = fields.get("app", 0)
        p.feature.vote_extensions_enable_height = fields.get("ext", 0)
        p.feature.pbts_enable_height = fields.get("pbts", 0)
        return p

    jp, tp = make(JParams), make(TParams)
    assert tp.hash() == jp.hash()
    assert tp.validate() == jp.validate()
    for h in (0, 3, 4, 11, 12):
        assert tp.feature.vote_extensions_enabled(h) == \
            jp.feature.vote_extensions_enabled(h)
        assert tp.feature.pbts_enabled(h) == jp.feature.pbts_enabled(h)
    assert TParams.BLOCK_PART_SIZE_BYTES == JParams.BLOCK_PART_SIZE_BYTES


def test_params_validate_and_timeliness_match_jax():
    for mut in (("block", "max_bytes", 0), ("block", "max_bytes", -2),
                ("block", "max_bytes", 200 * 1024 * 1024),
                ("block", "max_gas", -2),
                ("evidence", "max_age_num_blocks", 0),
                ("evidence", "max_age_duration_ns", 0),
                ("validator", "pub_key_types", [])):
        jp, tp = (m.default_consensus_params() for m in (JParams, TParams))
        for p in (jp, tp):
            setattr(getattr(p, mut[0]), mut[1], mut[2])
        assert tp.validate() == jp.validate() is not None
    js, ts = JParams.SynchronyParams(), TParams.SynchronyParams()
    for prop, recv, rnd in ((10**10, 10**10, 0), (10**10, 3 * 10**10, 2),
                            (10**10, 10**9, 0), (0, 16 * 10**9, 200)):
        assert ts.in_timely_bounds(prop, recv, rnd) == \
            js.in_timely_bounds(prop, recv, rnd)


@pytest.mark.parametrize("size", SIZES)
def test_part_set_from_data_matches_jax(size):
    data = _data(size)
    jps, tps = JPS.PartSet.from_data(data), TPS.PartSet.from_data(
        data, device="cpu")
    assert (tps.header().total, tps.header().hash) == \
        (jps.header().total, jps.header().hash)
    assert (tps.count, tps.byte_size, tps.is_complete()) == \
        (jps.count, jps.byte_size, jps.is_complete())
    assert str(tps.bit_array()) == str(jps.bit_array())
    for jp, tp in zip(jps.parts, tps.parts):
        assert (tp.index, tp.bytes_) == (jp.index, jp.bytes_)
        assert tuple(tp.proof) == tuple(jp.proof)
        assert tp.validate_basic() == jp.validate_basic()
    assert tps.get_data() == jps.get_data() == data
    assert tps.get_part(-1) is None and tps.get_part(tps.total) is None


def _proof(mod, p, **kw):
    return mod.Proof(**{**p._asdict(), **kw})


@pytest.mark.parametrize("size", [1, 65_537, 3 * 65_536 + 5])
def test_add_part_matches_jax(size):
    """A receiver assembles the set against the header: good parts are
    accepted once; a forged byte, a wrong proof index, an index out of
    range and an oversized part are refused with the JAX error."""
    data = _data(size, seed=11)
    jsrc = JPS.PartSet.from_data(data)
    tsrc = TPS.PartSet.from_data(data, device="cpu")
    jdst, tdst = JPS.PartSet(jsrc.header()), TPS.PartSet(tsrc.header())

    def both(jpart, tpart):
        out = []
        for dst, part, err in ((jdst, jpart, JPS.PartSetError),
                               (tdst, tpart, TPS.PartSetError)):
            try:
                out.append(("ok", dst.add_part(part)))
            except err as e:
                out.append(("err", str(e)))
        assert out[0] == out[1], out
        return out[0]

    jp0, tp0 = jsrc.parts[0], tsrc.parts[0]
    flip = bytes([tp0.bytes_[0] ^ 1]) + tp0.bytes_[1:]
    assert both(JPS.Part(0, flip, jp0.proof),
                TPS.Part(0, flip, tp0.proof)) == ("err", "invalid part proof")
    assert both(JPS.Part(0, jp0.bytes_, _proof(JM, jp0.proof, index=1)),
                TPS.Part(0, tp0.bytes_, _proof(TM, tp0.proof, index=1)))[0] \
        == "err"
    assert both(JPS.Part(jsrc.total, jp0.bytes_,
                         _proof(JM, jp0.proof, index=jsrc.total)),
                TPS.Part(tsrc.total, tp0.bytes_,
                         _proof(TM, tp0.proof, index=tsrc.total))) == \
        ("err", "part index out of range")
    big = b"\x00" * (TParams.BLOCK_PART_SIZE_BYTES + 1)
    assert both(JPS.Part(0, big, jp0.proof), TPS.Part(0, big, tp0.proof)) \
        == ("err", "part too big")
    assert both(JPS.Part(-1, b"", jp0.proof), TPS.Part(-1, b"", tp0.proof)) \
        == ("err", "negative index")
    for jp, tp in zip(reversed(jsrc.parts), reversed(tsrc.parts)):
        assert both(jp, tp) == ("ok", True)
        assert both(jp, tp) == ("ok", False)
    assert tdst.is_complete() and tdst.get_data() == data
    assert str(tdst.bit_array()) == str(jdst.bit_array())
    assert TPS.PartSet(tsrc.header()).is_complete() is False
    with pytest.raises(TPS.PartSetError):
        TPS.PartSet(tsrc.header()).get_data()

