"""The port's storage codec against the JAX package's.

- The MessagePack subset (``cometbft_tpu_torch/types/_msgpack.py``)
  against ``msgpack.packb(..., use_bin_type=True)`` and
  ``msgpack.unpackb(..., raw=False)`` at every size-class edge.
- ``codec.pack`` of each tagged type against the JAX ``codec.pack`` of
  the same object (carried over by ``convert.py`` or built from the same
  field values), byte for byte, and round trips through ``unpack``.
- Tags of types the port does not carry yet raise TypeError.
"""

import dataclasses

import msgpack
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from cometbft_tpu.testing import make_light_chain
from cometbft_tpu.types import codec as JC
from cometbft_tpu.types import evidence as JEv
from cometbft_tpu.types import vote as JVote
from cometbft_tpu.types.block_id import BlockID as JBlockID
from cometbft_tpu.types.block_id import PartSetHeader as JPSH
from cometbft_tpu.types.commit import CommitSig as JCommitSig
from cometbft_tpu.types.header import Data as JData
from cometbft_tpu_torch.light.types import LightBlock
from cometbft_tpu_torch.types import _msgpack as M
from cometbft_tpu_torch.types import codec as TC
from cometbft_tpu_torch.types import evidence as TEv
from cometbft_tpu_torch.types import vote as TVote
from cometbft_tpu_torch.types.block_id import BlockID as TBlockID
from cometbft_tpu_torch.types.block_id import PartSetHeader as TPSH
from cometbft_tpu_torch.types.commit import CommitSig as TCommitSig
from cometbft_tpu_torch.types.header import Data as TData

from test_torch_light_client import port_block

torch.set_num_threads(1)

pytestmark = pytest.mark.timeout(600)

CHAIN = "light-chain"


def _ref_pack(obj):
    return msgpack.packb(obj, use_bin_type=True)


def _ref_unpack(raw):
    return msgpack.unpackb(raw, raw=False, strict_map_key=False)


# ------------------------------------------------------- msgpack subset

INT_EDGES = [0, 1, 127, 128, 255, 256, 2**16 - 1, 2**16, 2**32 - 1, 2**32,
             2**63 - 1, 2**63, 2**64 - 1,
             -1, -32, -33, -128, -129, -2**15, -2**15 - 1, -2**31,
             -2**31 - 1, -2**63]
LEN_EDGES = [0, 1, 15, 16, 31, 32, 255, 256, 2**16 - 1, 2**16]


def _edge_values():
    vals = [None, True, False, *INT_EDGES]
    for n in LEN_EDGES:
        vals.append("s" * n)
        vals.append(b"\x00" * n)
        vals.append(list(range(n)))
        vals.append({f"k{i}": i for i in range(n)})
    vals += ["é" * 16, "∑" * 11, bytearray(b"ba"), (1, "t", b"u"),
             {"nested": [{"!": "X", "v": [None, -5, b"\xff"]}], "": {}}]
    return vals


@pytest.mark.parametrize("value", _edge_values(),
                         ids=lambda v: f"{type(v).__name__}:{str(v)[:24]}")
def test_msgpack_subset_matches_msgpack(value):
    raw = M.packb(value)
    assert raw == _ref_pack(value)
    back = M.unpackb(raw)
    want = _ref_unpack(raw)
    assert back == want and type(back) is type(want)


@pytest.mark.parametrize("bad", [2**64, -2**63 - 1])
def test_msgpack_subset_refuses_out_of_range_ints(bad):
    with pytest.raises(OverflowError):
        M.packb(bad)
    with pytest.raises(OverflowError):
        _ref_pack(bad)


@pytest.mark.parametrize("value", [1.5, object(), {1, 2}])
def test_msgpack_subset_refuses_other_types(value):
    with pytest.raises(TypeError):
        M.packb(value)


@pytest.mark.parametrize("raw", [b"", b"\xc4\x05ab", b"\x92\x01",
                                 b"\x01\x02", b"\xcb" + b"\x00" * 8,
                                 b"\xc1", b"\xd4\x00\x00"])
def test_msgpack_subset_refuses_bad_input(raw):
    with pytest.raises(ValueError):
        M.unpackb(raw)


_leaf = (st.none() | st.booleans()
         | st.integers(min_value=-2**63, max_value=2**64 - 1)
         | st.text(max_size=40) | st.binary(max_size=300))
_tree = st.recursive(_leaf, lambda kids: st.lists(kids, max_size=20)
                     | st.dictionaries(st.text(max_size=8), kids,
                                       max_size=20), max_leaves=60)


@settings(max_examples=150, deadline=None)
@given(_tree)
def test_msgpack_subset_random_trees(value):
    raw = M.packb(value)
    assert raw == _ref_pack(value)
    assert M.unpackb(raw) == _ref_unpack(raw)


# ----------------------------------------------------------- the codec

@pytest.fixture(scope="module")
def chains():
    ed = make_light_chain(4, n_vals=5, rotate_every=2, seed=b"codec")
    bls = make_light_chain(2, n_vals=4, key_types=["bls12_381"] * 3,
                           seed=b"codec-bls")
    return ed, bls


def _twin_objects(chains):
    """(JAX object, port object) pairs of every tagged type."""
    ed, bls = chains
    pairs = []
    for jb in (ed[0], ed[3], bls[1]):
        tb = port_block(jb)
        pairs += [(jb, tb), (jb.header, tb.header), (jb.commit, tb.commit),
                  (jb.validators, tb.validators),
                  (jb.validators.validators[1], tb.validators.validators[1]),
                  (jb.commit.block_id, tb.commit.block_id),
                  (jb.commit.block_id.part_set_header,
                   tb.commit.block_id.part_set_header),
                  (jb.commit.signatures[0], tb.commit.signatures[0])]
    assert bls[1].commit.agg_signature          # the aggregate keys appear
    pairs.append((JCommitSig(1, b"", -7, b""), TCommitSig(1, b"", -7, b"")))
    pairs.append((JData([b"tx1", b"", b"x" * 300]),
                  TData([b"tx1", b"", b"x" * 300])))
    vfields = dict(type=2, height=9, round=1, timestamp_ns=-3,
                   validator_address=b"\x03" * 20, validator_index=2,
                   signature=b"\x04" * 64, extension=b"ext",
                   extension_signature=b"\x05" * 64)
    jva = JVote.Vote(block_id=JBlockID(b"\x01" * 32, JPSH(1, b"\x02" * 32)),
                     **vfields)
    tva = TVote.Vote(block_id=TBlockID(b"\x01" * 32, TPSH(1, b"\x02" * 32)),
                     **vfields)
    jvb = JVote.Vote(block_id=JBlockID(), **vfields)
    tvb = TVote.Vote(block_id=TBlockID(), **vfields)
    pairs += [(jva, tva), (jvb, tvb)]
    pairs.append((JVote.Proposal(3, 2, -1, jva.block_id, 2**62, b"\x06" * 64),
                  TVote.Proposal(3, 2, -1, tva.block_id, 2**62,
                                 b"\x06" * 64)))
    pairs.append((JEv.DuplicateVoteEvidence(jvb, jva, 100, 10, 55),
                  TEv.DuplicateVoteEvidence(tvb, tva, 100, 10, 55)))
    jb, tb = ed[2], port_block(ed[2])
    pairs.append((JEv.LightClientAttackEvidence(
        jb.header.hash(), 3, 1, [jb.validators.validators[0]], 50, 77, jb),
        TEv.LightClientAttackEvidence(
            tb.header.hash(), 3, 1, [tb.validators.validators[0]], 50, 77,
            tb)))
    pairs.append(({"h": jb.header, "c": jb.commit, "v": jb.validators},
                  {"h": tb.header, "c": tb.commit, "v": tb.validators}))
    pairs.append(([1, "two", b"3", None], [1, "two", b"3", None]))
    return pairs


def test_pack_matches_jax_for_every_tagged_type(chains):
    tags = set()
    for j, t in _twin_objects(chains):
        raw = TC.pack(t)
        assert raw == JC.pack(j), type(t).__name__
        d = TC.to_dict(t)
        if isinstance(d, dict) and "!" in d:
            tags.add(d["!"])
    assert tags == {"PartSetHeader", "BlockID", "CommitSig", "Commit",
                    "Header", "Data", "Validator", "ValidatorSet", "Vote",
                    "Proposal", "DuplicateVoteEvidence",
                    "LightClientAttackEvidence", "LightBlock"}


def test_round_trip_and_cross_decode(chains):
    for j, t in _twin_objects(chains):
        raw = TC.pack(t)
        back = TC.unpack(raw)
        assert TC.pack(back) == raw
        # the JAX decoder reads the port's bytes and the port the JAX's
        assert JC.pack(JC.unpack(raw)) == raw
        assert TC.pack(TC.unpack(JC.pack(j))) == raw


def test_decoded_validator_set_rebuilds_its_caches(chains):
    ed, bls = chains
    for jb in (ed[3], bls[1]):
        tb = port_block(jb)
        vs = TC.unpack(TC.pack(tb.validators))
        # no cache comes over from the stored bytes: the dense view is
        # built on first use (the address index by the proposer lookup)
        assert "_dense" not in vs.__dict__
        assert vs.hash("cpu") == tb.validators.hash("cpu") == \
            jb.validators.hash()
        assert vs.address_index() == tb.validators.address_index()
        assert vs.total_voting_power() == tb.validators.total_voting_power()
        assert (vs.proposer.address if vs.proposer else None) == \
            (tb.validators.proposer.address if tb.validators.proposer
             else None)
        d, td = vs.dense(), tb.validators.dense()
        if td is None:
            assert d is None and vs.has_bls()
        else:
            assert np.array_equal(d[0], td[0])
            assert np.array_equal(d[1], td[1])


def test_decoded_light_block_verifies(chains):
    from cometbft_tpu_torch.types.validation import VerifyCommitLight

    ed, _ = chains
    lb = TC.unpack(TC.pack(port_block(ed[3])))
    assert isinstance(lb, LightBlock)
    assert lb.validate_basic(CHAIN, "cpu") is None
    VerifyCommitLight(CHAIN, lb.validators, lb.commit.block_id, lb.height,
                      lb.commit, device="cpu")


@pytest.mark.parametrize("tag", ["Block", "ExtendedCommit",
                                 "ExtendedCommitSig", "Nope"])
def test_tags_not_in_the_port_raise(tag):
    """An unknown tag raises TypeError.  The blocksync tags are in the
    port now (``tests/test_torch_block_store.py`` holds their bytes):
    a record of theirs without its fields raises KeyError."""
    cls = TypeError if tag == "Nope" else KeyError
    with pytest.raises(cls):
        TC.from_dict({"!": tag})
    with pytest.raises(cls):
        TC.unpack(_ref_pack({"!": tag, "x": 1}))


def test_unknown_types_and_key_types_raise(chains):
    with pytest.raises(TypeError):
        TC.pack(object())
    with pytest.raises(TypeError):
        TC.pack(1.5)
    raw = TC.pack(port_block(chains[0][0]).validators.validators[0])
    d = M.unpackb(raw)
    d["pk_type"] = "secp256k1"
    with pytest.raises(ValueError):
        TC.from_dict(d)


def test_header_fields_cover_the_dataclass(chains):
    """Every field of the port's Header goes through the codec."""
    h = port_block(chains[0][1]).header
    h2 = dataclasses.replace(h, version_app=7, consensus_hash=b"\x09" * 32,
                             evidence_hash=b"\x0a" * 32)
    assert TC.unpack(TC.pack(h2)) == h2
