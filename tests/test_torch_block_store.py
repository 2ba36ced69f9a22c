"""Blocks and the stores of the port against the JAX package's: the
codec bytes of ``Block``, ``ExtendedCommit`` and ``ExtendedCommitSig``;
``Block.hash``, ``fill_hashes`` and the messages of ``validate_basic``;
every key and value ``BlockStore`` and ``StateStore`` leave in ``MemDB``
after the same saves, prunes and truncations; ``State.from_genesis``.

The blocks are those of a chain made by the JAX package's executor
(``tests/torch_blocksync_fixtures.py``), carried across as bytes with
``convert.block_from_bytes`` and ``convert.state_from_bytes``."""

import copy
import dataclasses

import pytest
import torch

from cometbft_tpu.storage import blockstore as JBS
from cometbft_tpu.storage import statestore as JSS
from cometbft_tpu.storage.db import MemDB as JMemDB
from cometbft_tpu.types import codec as JC
from cometbft_tpu.types.block_id import BlockID as JBlockID
from cometbft_tpu.types.header import Block as JBlock
from cometbft_tpu.types.part_set import PartSet as JPartSet
from cometbft_tpu_torch import convert
from cometbft_tpu_torch.crypto.keys import Ed25519PubKey
from cometbft_tpu_torch.storage import blockstore as TBS
from cometbft_tpu_torch.storage import statestore as TSS
from cometbft_tpu_torch.storage.db import MemDB as TMemDB
from cometbft_tpu_torch.types import codec as TC
from cometbft_tpu_torch.types import genesis as TG
from cometbft_tpu_torch.types.block_id import BlockID as TBlockID
from cometbft_tpu_torch.types.commit import ExtendedCommit, ExtendedCommitSig
from cometbft_tpu_torch.types.header import Block as TBlock
from cometbft_tpu_torch.types.params import default_consensus_params
from cometbft_tpu_torch.types.part_set import PartSet as TPartSet

from torch_blocksync_fixtures import jax_chain

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def chain():
    return jax_chain()


def _port_block(jb):
    return convert.block_from_bytes(JC.pack(jb))


def _port_genesis(doc):
    p = default_consensus_params()
    p.feature.vote_extensions_enable_height = \
        doc.consensus_params.feature.vote_extensions_enable_height
    return TG.GenesisDoc(
        doc.chain_id, genesis_time_ns=doc.genesis_time_ns,
        consensus_params=p,
        validators=[TG.GenesisValidator(Ed25519PubKey(v.pub_key.bytes()),
                                        v.power, v.name)
                    for v in doc.validators])


# ---------------------------------------------------------------- codec

def test_blocks_and_extended_commits_pack_as_jax(chain):
    for jb, jext in zip(chain.blocks, chain.ext_commits):
        raw = JC.pack(jb)
        tb = convert.block_from_bytes(raw)
        assert isinstance(tb, TBlock)
        assert TC.pack(tb) == raw
        assert TC.pack(TC.unpack(raw)) == raw
        assert tb.hash() == jb.hash()
        assert tb.encode() == jb.encode()
        ext_raw = JC.pack(jext)
        text = TC.unpack(ext_raw)
        assert isinstance(text, ExtendedCommit)
        assert TC.pack(text) == ext_raw
        assert TC.pack(text.to_commit()) == JC.pack(jext.to_commit())
        for i, (js, ts) in enumerate(zip(jext.extended_signatures,
                                         text.extended_signatures)):
            assert isinstance(ts, ExtendedCommitSig)
            assert TC.pack(ts) == JC.pack(js)
            assert ts.validate_basic() == js.validate_basic()
            tv, jv = text.to_extended_vote(i), jext.to_extended_vote(i)
            assert TC.pack(tv) == JC.pack(jv)
        for on in (False, True):
            assert text.ensure_extensions(on) == jext.ensure_extensions(on)
    # the first block has no last commit: "lc" is nil
    assert TC.unpack(JC.pack(chain.blocks[0])).last_commit is None
    with pytest.raises(TypeError):
        convert.block_from_bytes(JC.pack(chain.ext_commits[0]))


def test_extended_commit_with_aggregate_fields_packs_as_jax(chain):
    jext = copy.deepcopy(chain.ext_commits[-1])
    jext.agg_signature, jext.agg_signers = b"\x07" * 96, b"\x0f"
    raw = JC.pack(jext)
    text = TC.unpack(raw)
    assert TC.pack(text) == raw
    assert TC.pack(text.to_commit()) == JC.pack(jext.to_commit())
    bad = copy.deepcopy(chain.ext_commits[0])
    bad.extended_signatures[1].extension = b"x"
    tbad = TC.unpack(JC.pack(bad))
    for on in (False, True):
        assert tbad.ensure_extensions(on) == bad.ensure_extensions(on)


# ------------------------------------------------------- block checks

def test_fill_hashes_and_hash_match_jax(chain):
    for jb in chain.blocks:
        tb = _port_block(jb)
        jb2, tb2 = copy.deepcopy(jb), copy.deepcopy(tb)
        for b in (jb2, tb2):
            b.header.data_hash = b.header.last_commit_hash = b""
            b.header.evidence_hash = b""
        jb2.fill_hashes()
        tb2.fill_hashes("cpu")
        assert TC.pack(tb2) == JC.pack(jb2) == JC.pack(jb)
        assert tb2.hash() == jb.hash()
    tb = _port_block(chain.blocks[3])
    tb.header.validators_hash = b""
    assert tb.hash() == b""


def _mutations():
    def drop_commit(b):
        b.last_commit = None

    def wrong_commit_hash(b):
        b.header.last_commit_hash = b"\x01" * 32

    def bad_commit_sig(b):
        b.last_commit.signatures[0].signature = b""

    def wrong_data(b):
        b.data.txs.append(b"tx")

    def no_chain(b):
        b.header.chain_id = ""

    def neg_height(b):
        b.header.height = -1

    def nil_last_block(b):
        b.header.last_block_id = type(b.header.last_block_id)()

    def proposer_size(b):
        b.header.proposer_address = b"\x01" * 5

    return [None, drop_commit, wrong_commit_hash, bad_commit_sig, wrong_data,
            no_chain, neg_height, nil_last_block, proposer_size]


@pytest.mark.parametrize("mut", _mutations(),
                         ids=lambda m: "ok" if m is None else m.__name__)
def test_validate_basic_messages_match_jax(chain, mut):
    jb = copy.deepcopy(chain.blocks[5])
    tb = _port_block(jb)
    if mut is not None:
        mut(jb)
        mut(tb)
    assert tb.validate_basic("cpu") == jb.validate_basic()
    if mut is not None:
        assert tb.validate_basic("cpu") is not None


# ------------------------------------------------------------ stores

def _parts_pair(jb):
    return JPartSet.from_data(JC.pack(jb)), TPartSet.from_data(
        TC.pack(_port_block(jb)), device="cpu")


def test_block_store_records_match_jax(chain):
    """The same saves (plain and with an extended commit), loads, prunes,
    truncations, tip removals and a statesync bootstrap leave the same
    keys and values."""
    jdb, tdb = JMemDB(), TMemDB()
    js, ts = JBS.BlockStore(jdb), TBS.BlockStore(tdb)
    ext_from = chain.doc.consensus_params.feature \
        .vote_extensions_enable_height
    for jb, jext in zip(chain.blocks, chain.ext_commits):
        jp, tp = _parts_pair(jb)
        tb = _port_block(jb)
        if jb.header.height >= ext_from:
            js.save_block_with_extended_commit(jb, jp, jext)
            ts.save_block_with_extended_commit(tb, tp, TC.unpack(
                JC.pack(jext)))
        else:
            js.save_block(jb, jp, jext.to_commit())
            ts.save_block(tb, tp, TC.unpack(JC.pack(jext.to_commit())))
        assert tdb._data == jdb._data
    assert tdb._data == chain.block_dbs[-1]
    for h in range(0, len(chain.blocks) + 2):
        for load in ("load_block", "load_block_commit",
                     "load_block_extended_commit"):
            a, b = getattr(js, load)(h), getattr(ts, load)(h)
            assert (a is None) == (b is None)
            if a is not None:
                assert TC.pack(b) == JC.pack(a)
        jm, tm = js.load_block_meta(h), ts.load_block_meta(h)
        assert (jm is None) == (tm is None)
        if jm is not None:
            assert (tm.block_size, tm.num_txs, tm.header_height) == \
                (jm.block_size, jm.num_txs, jm.header_height)
            assert TC.pack(tm.block_id) == JC.pack(jm.block_id)
        jparts, tparts = js.load_block_parts(h), ts.load_block_parts(h,
                                                                     "cpu")
        if jparts is not None:
            assert tparts.header().hash == jparts.header().hash
    assert TC.pack(ts.load_seen_commit()) == JC.pack(js.load_seen_commit())
    with pytest.raises(ValueError) as te:
        ts.save_block(_port_block(chain.blocks[2]), *_parts_pair(
            chain.blocks[2])[1:], None)
    with pytest.raises(ValueError) as je:
        js.save_block(chain.blocks[2], None, None)
    assert str(te.value) == str(je.value)
    assert (ts.base(), ts.height(), ts.size()) == \
        (js.base(), js.height(), js.size())
    for op, arg in (("prune_blocks", 1), ("prune_blocks", 4),
                    ("prune_blocks", 3), ("truncate_above", 10),
                    ("remove_tip", None), ("truncate_above", 9)):
        args = () if arg is None else (arg,)
        assert getattr(ts, op)(*args) == getattr(js, op)(*args)
        assert tdb._data == jdb._data
        assert (ts.base(), ts.height()) == (js.base(), js.height())
    for op, arg in (("prune_blocks", 40), ("truncate_above", 40),
                    ("truncate_above", -1)):
        with pytest.raises(ValueError) as te:
            getattr(ts, op)(arg)
        with pytest.raises(ValueError) as je:
            getattr(js, op)(arg)
        assert str(te.value) == str(je.value)
    assert ts.truncate_above(0) == js.truncate_above(0)
    assert tdb._data == jdb._data and ts.base() == js.base() == 0
    with pytest.raises(ValueError):
        ts.remove_tip()
    # a store reopened on the same db reads its bookkeeping back
    assert (TBS.BlockStore(tdb).base(), TBS.BlockStore(tdb).height()) == \
        (JBS.BlockStore(jdb).base(), JBS.BlockStore(jdb).height())
    jseen = chain.ext_commits[6].to_commit()
    for store, db, seen in ((js, JMemDB(), jseen),
                            (ts, TMemDB(), TC.unpack(JC.pack(jseen)))):
        store.__init__(db)
        store.bootstrap_statesync(7, seen)
    assert ts.db._data == js.db._data
    with pytest.raises(ValueError):
        ts.bootstrap_statesync(8, None)
    assert ts.is_dirty() is False
    ts.clear_dirty()


def test_state_store_records_match_jax(chain):
    """Every state of the chain saved, FinalizeBlock records, retain
    heights, pruning, the offline statesync height, a bootstrap, a
    rollback and a cleared state: the same keys and values."""
    jdb, tdb = JMemDB(), TMemDB()
    js, ts = JSS.StateStore(jdb), TSS.StateStore(tdb)
    for h, jst in enumerate(chain.states, start=1):
        raw = chain.state_dbs[h - 1][b"S/state"]
        tst = convert.state_from_bytes(raw)
        js.save(jst)
        ts.save(tst)
        js.save_finalize_block_response(h, b"resp%d" % h)
        ts.save_finalize_block_response(h, b"resp%d" % h)
        assert tdb._data == jdb._data
        assert TC.pack(ts.load().validators) == TC.pack(tst.validators)
        assert ts.load_finalize_block_response(h) == b"resp%d" % h
    for h in range(0, len(chain.states) + 3):
        jv, tv = js.load_validators(h), ts.load_validators(h)
        assert (jv is None) == (tv is None)
        if jv is not None:
            assert TC.pack(tv) == JC.pack(jv)
        jp, tp = js.load_params(h), ts.load_params(h)
        assert (jp is None) == (tp is None)
        if jp is not None:
            assert tp.hash() == jp.hash()
    for app, dc in ((0, 0), (5, 0), (5, 3), (0, 7)):
        js.set_retain_heights(app, dc)
        ts.set_retain_heights(app, dc)
        assert ts.get_retain_height() == js.get_retain_height()
    assert tdb._data == jdb._data
    for r in (1, 4, 3, 9):
        assert ts.prune_states(r) == js.prune_states(r)
        assert tdb._data == jdb._data
    js.set_offline_state_sync_height(42)
    ts.set_offline_state_sync_height(42)
    assert ts.get_offline_state_sync_height() == 42
    assert tdb._data == jdb._data
    jst = chain.states[-1]
    js.bootstrap(jst)
    ts.bootstrap(convert.state_from_bytes(JSS.StateStore(jdb).db.get(
        b"S/state")))
    assert tdb._data == jdb._data
    js.clear_state()
    ts.clear_state()
    assert tdb._data == jdb._data and ts.load() is None


def test_rollback_matches_jax(chain):
    jbdb, jsdb = JMemDB(), JMemDB()
    tbdb, tsdb = TMemDB(), TMemDB()
    for db, src in ((jbdb, chain.block_dbs[-1]), (tbdb, chain.block_dbs[-1]),
                    (jsdb, chain.state_dbs[-1]), (tsdb, chain.state_dbs[-1])):
        db._data.update(src)
    jbs, jss = JBS.BlockStore(jbdb), JSS.StateStore(jsdb)
    tbs, tss = TBS.BlockStore(tbdb), TSS.StateStore(tsdb)
    for remove in (False, True):
        jr = JSS.rollback_state(jss, jbs, remove_block=remove)
        tr = TSS.rollback_state(tss, tbs, remove_block=remove)
        assert tsdb._data == jsdb._data and tbdb._data == jbdb._data
        assert tr.last_block_height == jr.last_block_height
        if not remove:
            with pytest.raises(ValueError) as te:
                TSS.rollback_state(tss, tbs)
            with pytest.raises(ValueError) as je:
                JSS.rollback_state(jss, jbs)
            assert str(te.value) == str(je.value)
            jbs.remove_tip()
            tbs.remove_tip()
    with pytest.raises(ValueError):
        TSS.rollback_state(TSS.StateStore(TMemDB()), tbs)


def test_state_from_genesis_matches_jax(chain):
    tdoc = _port_genesis(chain.doc)
    tdoc.validate_and_complete()
    chain.doc.validate_and_complete()
    jst = JSS.State.from_genesis(chain.doc)
    tst = TSS.State.from_genesis(tdoc)
    jdb, tdb = JMemDB(), TMemDB()
    JSS.StateStore(jdb).save(jst)
    TSS.StateStore(tdb).save(tst)
    assert tdb._data == jdb._data
    assert tst.is_empty() is False and tst.last_validators is None
    cp = tst.copy()
    assert TC.pack(cp.validators) == TC.pack(tst.validators)
    assert cp.validators is not tst.validators
    # the genesis document round-trips through its JSON as JAX's does
    back = TG.GenesisDoc.from_json(tdoc.to_json())
    assert back.to_json() == tdoc.to_json()
    from cometbft_tpu.types.genesis import GenesisDoc as JGenesis

    assert JGenesis.from_json(tdoc.to_json()).to_json() == \
        chain.doc.to_json() == tdoc.to_json()
    for bad in (dataclasses.replace(tdoc, chain_id=""),
                dataclasses.replace(tdoc, chain_id="x" * 51),
                dataclasses.replace(tdoc, initial_height=0)):
        with pytest.raises(TG.GenesisError):
            bad.validate_and_complete()


def test_block_ids_of_the_chain_match(chain):
    """The block IDs the stores and the executor use: hash and part-set
    header, from the block's bytes."""
    for jb, jp in zip(chain.blocks, chain.parts):
        tb = _port_block(jb)
        tp = TPartSet.from_data(TC.pack(tb), device="cpu")
        assert TC.pack(TBlockID(tb.hash(), tp.header())) == \
            JC.pack(JBlockID(jb.hash(), jp.header()))
    assert isinstance(chain.blocks[0], JBlock)
