"""The port's block executor against the JAX package's: a chain of 4
validators and 12 heights made by the JAX package's own
``BlockExecutor`` (``tests/torch_blocksync_fixtures.py``) is made again
by the port's, height by height, from the same genesis and the same
signed commits.  Each proposal's bytes, each state after
``apply_block`` and every store record must equal the JAX package's;
``validate_block`` must fail with the JAX package's text on each
mutation.  Vote extensions are on from height 11, so those heights are
saved with their extended commit."""

import copy
import dataclasses

import pytest
import torch

from cometbft_tpu.sm import validation as JV
from cometbft_tpu.sm.execution import \
    unpack_finalize_response as j_unpack_resp
from cometbft_tpu.types import codec as JC
from cometbft_tpu_torch import convert
from cometbft_tpu_torch.abci import types as TA
from cometbft_tpu_torch.abci.application import Application
from cometbft_tpu_torch.abci.client import (ABCIClientError, LocalClient,
                                            _decode_value, _encode_value,
                                            dispatch_to_app)
from cometbft_tpu_torch.crypto.keys import Ed25519PubKey
from cometbft_tpu_torch.libs import fail, pubsub
from cometbft_tpu_torch.mempool.mempool import NopMempool, TxKey
from cometbft_tpu_torch.sm import execution as TE
from cometbft_tpu_torch.sm import validation as TV
from cometbft_tpu_torch.storage.blockstore import BlockStore
from cometbft_tpu_torch.storage.db import MemDB
from cometbft_tpu_torch.storage.statestore import State, StateStore
from cometbft_tpu_torch.types import codec as TC
from cometbft_tpu_torch.types import events as ev
from cometbft_tpu_torch.types.block_id import BlockID
from cometbft_tpu_torch.types.commit import ExtendedCommit
from cometbft_tpu_torch.types.genesis import GenesisDoc, GenesisValidator
from cometbft_tpu_torch.types.params import default_consensus_params

from torch_blocksync_fixtures import T0, jax_chain, run

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def chain():
    return jax_chain()


def port_genesis(doc):
    p = default_consensus_params()
    p.feature.vote_extensions_enable_height = \
        doc.consensus_params.feature.vote_extensions_enable_height
    return GenesisDoc(
        doc.chain_id, genesis_time_ns=doc.genesis_time_ns,
        consensus_params=p,
        validators=[GenesisValidator(Ed25519PubKey(v.pub_key.bytes()),
                                     v.power) for v in doc.validators])


def port_node(doc):
    bdb, sdb = MemDB(), MemDB()
    bs, ss = BlockStore(bdb), StateStore(sdb)
    state = State.from_genesis(port_genesis(doc))
    ss.save(state)
    ex = TE.BlockExecutor(ss, bs, LocalClient(Application()), NopMempool(),
                          device="cpu")
    return ex, state


@pytest.fixture(scope="module")
def replay(chain):
    """The chain made again by the port's executor: per height the block
    and part set it proposes, and its stores after the apply."""
    async def main():
        ex, state = port_node(chain.doc)
        sub = ex.event_bus.subscribe("t", {"tm.event": ev.EVENT_NEW_BLOCK},
                                     unbuffered=True)
        out = {"blocks": [], "parts": [], "states": [], "bdbs": [],
               "sdbs": [], "events": sub}
        last_ext = ExtendedCommit(0, 0, BlockID(), [])
        for h, jext in enumerate(chain.ext_commits, start=1):
            proposer = state.validators.get_proposer().address
            block, parts = await ex.create_proposal_block(
                h, state, last_ext, proposer, T0 + h * 10**9)
            bid = BlockID(block.hash(), parts.header())
            ext = TC.unpack(JC.pack(jext))
            if state.consensus_params.feature.vote_extensions_enabled(h):
                ex.block_store.save_block_with_extended_commit(block, parts,
                                                               ext)
            else:
                ex.block_store.save_block(block, parts, ext.to_commit())
            assert await ex.process_proposal(block, state)
            state = await ex.apply_block(state, bid, block)
            out["blocks"].append(block)
            out["parts"].append(parts)
            out["states"].append(state)
            out["bdbs"].append(dict(ex.block_store.db._data))
            out["sdbs"].append(dict(ex.state_store.db._data))
            last_ext = ext
        return out

    return run(main())


def test_proposals_match_jax(chain, replay):
    for jb, jp, tb, tp in zip(chain.blocks, chain.parts, replay["blocks"],
                              replay["parts"]):
        assert TC.pack(tb) == JC.pack(jb)
        assert (tp.header().total, tp.header().hash) == \
            (jp.header().total, jp.header().hash)
        assert [p.bytes_ for p in tp.parts] == [p.bytes_ for p in jp.parts]


def test_states_and_stores_match_jax(chain, replay):
    for h in range(len(chain.blocks)):
        assert replay["sdbs"][h] == chain.state_dbs[h], f"state db at {h+1}"
        assert replay["bdbs"][h] == chain.block_dbs[h], f"block db at {h+1}"
        st = convert.state_from_bytes(chain.state_dbs[h][b"S/state"])
        assert dataclasses.asdict(replay["states"][h]).keys() == \
            dataclasses.asdict(st).keys()
    # vote extensions from height 11: its extended commit was stored
    assert b"EC/" + (11).to_bytes(8, "big") in replay["bdbs"][-1]


def test_finalize_responses_decode_as_jax(chain, replay):
    for h in range(1, len(chain.blocks) + 1):
        key = b"S/r/" + h.to_bytes(8, "big")
        raw = replay["sdbs"][-1][key]
        assert raw == chain.state_dbs[-1][key]
        tr, jr = TE.unpack_finalize_response(raw), j_unpack_resp(raw)
        assert tr.results_hash("cpu") == jr.results_hash()
        assert len(tr.tx_results) == len(jr.tx_results) == 0


def test_events_fired(replay):
    q = replay["events"].queue
    heights = []
    while not q.empty():
        msg = q.get_nowait()
        heights.append(msg.attrs[ev.BLOCK_HEIGHT_KEY])
    assert heights == [str(h) for h in range(1, 13)]


def _mutations():
    def height(b, st):
        b.header.height += 1

    def chain_id(b, st):
        b.header.chain_id = "other-chain"

    def last_block_id(b, st):
        b.header.last_block_id = dataclasses.replace(
            b.header.last_block_id, hash=b"\x02" * 32)

    def validators_hash(b, st):
        b.header.validators_hash = b"\x03" * 32

    def next_validators_hash(b, st):
        b.header.next_validators_hash = b"\x03" * 32

    def consensus_hash(b, st):
        b.header.consensus_hash = b"\x04" * 32

    def app_hash(b, st):
        b.header.app_hash = b"\x05" * 32

    def last_results_hash(b, st):
        b.header.last_results_hash = b"\x06" * 32

    def time_not_monotonic(b, st):
        b.header.time_ns = st.last_block_time_ns

    def time_not_median(b, st):
        b.header.time_ns += 1

    def proposer(b, st):
        b.header.proposer_address = b"\x07" * 20

    def missing_commit(b, st):
        b.last_commit = None

    def bad_signature(b, st):
        s = b.last_commit.signatures[1].signature
        b.last_commit.signatures[1].signature = s[:5] + bytes(
            [s[5] ^ 1]) + s[6:]
        b.header.last_commit_hash = b.last_commit.hash()

    def commit_for_other_block(b, st):
        b.last_commit.block_id = dataclasses.replace(
            b.last_commit.block_id, hash=b"\x08" * 32)
        b.header.last_commit_hash = b.last_commit.hash()

    def protocol_version(b, st):
        b.header.version_block = 10

    return [None, height, chain_id, last_block_id, validators_hash,
            next_validators_hash, consensus_hash, app_hash,
            last_results_hash, time_not_monotonic, time_not_median, proposer,
            missing_commit, bad_signature, commit_for_other_block,
            protocol_version]


def _outcome(fn):
    try:
        fn()
    except Exception as e:          # class name and text are compared
        return type(e).__name__, str(e)
    return None


# the first block has no last commit and no time rule
_FIRST_BLOCK_ONLY_HEADER = ("bad_signature", "commit_for_other_block",
                            "time_not_monotonic", "time_not_median",
                            "missing_commit")
_CASES = [(h, m) for h in (1, 6) for m in _mutations()
          if h > 1 or m is None or m.__name__ not in _FIRST_BLOCK_ONLY_HEADER]


@pytest.mark.parametrize("h,mut", _CASES, ids=lambda x: (
    x if isinstance(x, int) else "ok" if x is None else x.__name__))
def test_validate_block_errors_match_jax(chain, mut, h):
    jstate = chain.states[h - 2] if h > 1 else None
    if jstate is None:
        from cometbft_tpu.storage.statestore import State as JState

        jstate = JState.from_genesis(chain.doc)
    tstate = convert.state_from_bytes(chain.state_dbs[h - 2][b"S/state"]) \
        if h > 1 else State.from_genesis(port_genesis(chain.doc))
    jb = copy.deepcopy(chain.blocks[h - 1])
    tb = convert.block_from_bytes(JC.pack(jb))
    if mut is not None:
        mut(jb, jstate)
        mut(tb, tstate)
    want = _outcome(lambda: JV.validate_block(jstate, jb, backend="cpu"))
    got = _outcome(lambda: TV.validate_block(tstate, tb, device="cpu"))
    assert got == want
    assert (got is None) == (mut is None)
    if mut is not None and got[0] == "BlockValidationError":
        # the blocksync form (signatures proven elsewhere) agrees too
        want = _outcome(lambda: JV.validate_block(
            jstate, jb, backend="cpu", verify_last_commit_sigs=False))
        got = _outcome(lambda: TV.validate_block(
            tstate, tb, device="cpu", verify_last_commit_sigs=False))
        assert got == want


def test_median_time_matches_jax(chain):
    for jb, jst in zip(chain.blocks[1:], chain.states):
        tb = convert.block_from_bytes(JC.pack(jb))
        tst = convert.state_from_bytes(
            chain.state_dbs[jb.header.height - 2][b"S/state"])
        assert TV.median_time(tb.last_commit, tst.last_validators) == \
            JV.median_time(jb.last_commit, jst.last_validators) == \
            jb.header.time_ns


def test_vote_extension_calls_and_abci_dispatch(chain):
    async def main():
        ex, state = port_node(chain.doc)
        ext = TC.unpack(JC.pack(chain.ext_commits[-1]))
        vote = ext.to_extended_vote(0)
        assert await ex.extend_vote(vote) == b""
        assert await ex.verify_vote_extension(vote) is True
        app = Application()
        assert await dispatch_to_app(app, "echo", {"msg": "hi"}) == "hi"
        assert (await dispatch_to_app(app, "info", {})).last_block_height \
            == 0
        assert await dispatch_to_app(
            app, "offer_snapshot", {"snapshot": None, "app_hash": b""}) == \
            TA.OFFER_SNAPSHOT_REJECT
        with pytest.raises(ABCIClientError):
            await dispatch_to_app(app, "nope", {})
        cl = LocalClient(app)
        resp = await cl.prepare_proposal(TA.PrepareProposalRequest(
            max_tx_bytes=5, txs=[b"abc", b"de", b"f"], height=1, time_ns=0))
        assert resp.txs == [b"abc", b"de"]
        assert (await cl.check_tx(b"x")).is_ok
        assert (await cl.commit()).retain_height == 0
        with pytest.raises(RuntimeError):
            await NopMempool().check_tx(b"x")
        return True

    assert run(main())


def test_finalize_response_encoding_matches_jax():
    from cometbft_tpu.abci import types as JA
    from cometbft_tpu.abci.client import _encode_value as j_encode
    from cometbft_tpu.types import params as JP
    import msgpack

    from cometbft_tpu_torch.types import _msgpack
    from cometbft_tpu_torch.types import params as TP

    def resp(A, P):
        return A.FinalizeBlockResponse(
            events=[A.Event("transfer", [A.EventAttribute("k", "v"),
                                         A.EventAttribute("n", "1", False)])],
            tx_results=[A.ExecTxResult(code=0, data=b"\x01", log="ok",
                                       gas_wanted=5, gas_used=3),
                        A.ExecTxResult(code=2)],
            validator_updates=[A.ValidatorUpdate("ed25519", b"\x02" * 32,
                                                 7)],
            consensus_param_updates=P.default_consensus_params(),
            app_hash=b"\x09" * 32)

    jr, tr = resp(JA, JP), resp(TA, TP)
    raw = msgpack.packb(j_encode(jr), use_bin_type=True)
    assert _msgpack.packb(_encode_value(tr)) == raw
    back = _decode_value(_msgpack.unpackb(raw))
    assert back == tr
    assert tr.results_hash("cpu") == jr.results_hash()
    assert TxKey(b"tx") == __import__("hashlib").sha256(b"tx").digest()


def test_pubsub_and_fail_points():
    bus = pubsub.EventBus()
    sub = bus.subscribe("a", {"tm.event": "Tx", "tx.height": "3"})
    # a query string compiles (libs/query); any other type is refused
    q = bus.subscribe("b", "tm.event='Tx' AND tx.height > 3")
    with pytest.raises(TypeError):
        bus.subscribe("bad", 5)
    bus.publish("Tx", 1, {"tx.height": "3"})
    bus.publish("Tx", 2, {"tx.height": "4"})
    bus.publish("NewBlock", 3, {"tx.height": "3"})
    assert sub.queue.qsize() == 1 and sub.queue.get_nowait().data == 1
    assert q.queue.qsize() == 1 and q.queue.get_nowait().data == 2
    assert bus.num_subscribers() == 2
    bus.unsubscribe("b")
    small = bus.subscribe("c", {})
    for i in range(300):
        bus.publish("X", i)
    assert small.queue.qsize() == 256
    assert small.queue.get_nowait().data == 300 - 256
    bus.unsubscribe("a")
    assert bus.num_subscribers() == 1
    fail.fail_point("unarmed")          # no CMT_FAIL_INDEX: a no-op
    assert fail.labels_seen() == []
