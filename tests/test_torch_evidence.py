"""The port's evidence verification and pool (``cometbft_tpu_torch/
evidence``) against the JAX package's, on the CPU, over the 4-validator,
12-height chain of ``tests/torch_blocksync_fixtures.py`` (the JAX
package's stores, carried into the port's byte for byte).  The same
evidence (duplicate votes and light-client attacks: valid, tampered,
mis-powered, misplaced in time or height, expired; made from numpy seeds)
gives the same verdict (error class and message) in both packages, the
same evidence bytes and hashes, and the pool the same pending records,
``check_evidence`` outcomes and ABCI misbehaviour.  The port's signature
checks are fresh device lanes through its scheduler on ``"cpu"``
(``verify_uncached``; every one counted), never the host oracle."""

import dataclasses

import numpy as np
import pytest

from cometbft_tpu.evidence import pool as JPool
from cometbft_tpu.evidence import verify as JVerify
from cometbft_tpu.light.types import LightBlock as JLightBlock
from cometbft_tpu.types import codec as JC
from cometbft_tpu.types import evidence as JE
from cometbft_tpu_torch.crypto import _ed25519_py as ref
from cometbft_tpu_torch.crypto import scheduler as vsched
from cometbft_tpu_torch.evidence import pool as TPool
from cometbft_tpu_torch.evidence import verify as TVerify
from cometbft_tpu_torch.light.types import LightBlock
from cometbft_tpu_torch.storage.blockstore import BlockStore
from cometbft_tpu_torch.storage.db import MemDB
from cometbft_tpu_torch.storage.statestore import StateStore
from cometbft_tpu_torch.types import codec as TC
from cometbft_tpu_torch.types import evidence as TE
from cometbft_tpu_torch.types.block_id import BlockID, PartSetHeader
from cometbft_tpu_torch.types.commit import (BLOCK_ID_FLAG_COMMIT, Commit,
                                             CommitSig)
from cometbft_tpu_torch.types.vote import PREVOTE_TYPE, Vote

from torch_blocksync_fixtures import CHAIN, jax_chain

pytestmark = pytest.mark.timeout(150)


@pytest.fixture(scope="module")
def chain():
    return jax_chain()


@pytest.fixture(autouse=True)
def sched():
    vsched.set_scheduler(None)
    s = vsched.VerificationScheduler(device="cpu")
    vsched.set_scheduler(s)
    yield s
    vsched.set_scheduler(None)


@pytest.fixture(autouse=True)
def no_oracle(monkeypatch):
    """The port's path must not verify on the host."""
    def refuse(*a, **kw):
        raise AssertionError("host oracle called on the evidence path")

    monkeypatch.setattr(ref, "verify_zip215", refuse)


class Both:
    """Both packages' stores, state and signers over the chain."""

    def __init__(self, chain):
        self.chain = chain
        self.jbs, self.jss = chain.block_store, chain.state_store
        tb, ts = MemDB(), MemDB()
        tb._data.update(chain.block_dbs[-1])
        ts._data.update(chain.state_dbs[-1])
        self.tbs, self.tss = BlockStore(tb), StateStore(ts)
        self.jstate = chain.states[-1]
        self.tstate = self.tss.load()
        self.by_addr = {k.pub_key().address(): k for k in chain.keys}

    def vote_pair(self, h, idx, rng, tamper=False, vidx=None, rnd=0):
        """Two prevotes of validator ``idx`` at height ``h`` for
        different random blocks: (port votes, JAX votes)."""
        vals = self.tss.load_validators(h)
        v = vals.get_by_index(idx)
        out = []
        for k in range(2):
            bid = BlockID(rng.integers(0, 256, 32, np.uint8).tobytes(),
                          PartSetHeader(1, rng.integers(
                              0, 256, 32, np.uint8).tobytes()))
            tv = Vote(type=PREVOTE_TYPE, height=h, round=rnd, block_id=bid,
                      timestamp_ns=int(rng.integers(1, 2**60)),
                      validator_address=v.address,
                      validator_index=idx if vidx is None else vidx)
            tv.signature = self.by_addr[v.address].sign(tv.sign_bytes(CHAIN))
            if tamper and k == 1:
                tv.signature = bytes([tv.signature[0] ^ 1]) + \
                    tv.signature[1:]
            out.append(tv)
        return out, [JC.unpack(TC.pack(v)) for v in out]

    def dup(self, h, idx, rng, **kw):
        (a, b), (ja, jb) = self.vote_pair(h, idx, rng, **kw)
        tvals = self.tss.load_validators(h)
        jvals = self.jss.load_validators(h)
        t = self.tbs.load_block(h).header.time_ns
        return (TE.DuplicateVoteEvidence.from_votes(a, b, t, tvals),
                JE.DuplicateVoteEvidence.from_votes(ja, jb, t, jvals))


def _verdict(fn):
    try:
        fn()
        return ("ok",)
    except Exception as e:
        return (type(e).__name__, str(e))


def _same_evidence(tev, jev):
    assert TC.pack(tev) == JC.pack(jev)
    assert tev.hash() == jev.hash() and tev.encode() == jev.encode()


def _verify_both(b, tev, jev, tstate=None, jstate=None, stores=True):
    t = _verdict(lambda: TVerify.verify_evidence(
        tev, tstate or b.tstate, b.tss, device="cpu",
        block_store=b.tbs if stores else None))
    j = _verdict(lambda: JVerify.verify_evidence(
        jev, jstate or b.jstate, b.jss, backend="cpu",
        block_store=b.jbs if stores else None))
    assert t == j
    return t


def test_duplicate_vote_verdicts_match(chain, sched):
    b = Both(chain)
    rng = np.random.default_rng(1)
    verdicts = []
    for h in (3, 7, 12):
        for idx in (0, 3):
            tev, jev = b.dup(h, idx, rng)
            _same_evidence(tev, jev)
            verdicts.append(_verify_both(b, tev, jev))
    assert set(verdicts) == {("ok",)}
    lanes = sched.stats()["single_checks"]["uncached"]
    assert lanes == 2 * len(verdicts)
    # tampered vote, wrong powers, wrong time, unknown validator
    tev, jev = b.dup(5, 1, rng, tamper=True)
    assert _verify_both(b, tev, jev)[0] == "EvidenceError"
    tev, jev = b.dup(5, 2, rng)
    for field, delta in (("validator_power", 1), ("total_voting_power", 5),
                         ("timestamp_ns", 1)):
        t2 = dataclasses.replace(tev, **{field: getattr(tev, field) + delta})
        j2 = dataclasses.replace(jev, **{field: getattr(jev, field) + delta})
        _same_evidence(t2, j2)
        assert _verify_both(b, t2, j2)[0] == "EvidenceError"
    # time not pinned without the block store: the forged time passes
    t2 = dataclasses.replace(tev, timestamp_ns=tev.timestamp_ns + 1)
    j2 = dataclasses.replace(jev, timestamp_ns=jev.timestamp_ns + 1)
    assert _verify_both(b, t2, j2, stores=False) == ("ok",)


def test_evidence_not_applicable_and_invalid_alike(chain):
    b = Both(chain)
    rng = np.random.default_rng(2)
    # a height past the stores: no block to pin the time to
    (a, c), (ja, jc) = b.vote_pair(12, 0, rng)
    for v in (a, c, ja, jc):
        v.height = 13
    tev = TE.DuplicateVoteEvidence(*sorted(
        (a, c), key=lambda v: v.block_id.key()), 40, 10, 5)
    jev = JE.DuplicateVoteEvidence(*sorted(
        (ja, jc), key=lambda v: v.block_id.key()), 40, 10, 5)
    assert _verify_both(b, tev, jev)[0] == "EvidenceNotApplicableError"
    # unordered votes: validate_basic fails first
    t2 = dataclasses.replace(tev, vote_a=tev.vote_b, vote_b=tev.vote_a)
    j2 = dataclasses.replace(jev, vote_a=jev.vote_b, vote_b=jev.vote_a)
    assert _verify_both(b, t2, j2)[0] == "EvidenceError"
    # expired: the evidence params shrunk in both states
    tev, jev = b.dup(2, 1, rng)
    ts = dataclasses.replace(b.tstate)
    js = dataclasses.replace(b.jstate)
    ts.consensus_params = dataclasses.replace(
        b.tstate.consensus_params, evidence=dataclasses.replace(
            b.tstate.consensus_params.evidence, max_age_num_blocks=3,
            max_age_duration_ns=1))
    js.consensus_params = dataclasses.replace(
        b.jstate.consensus_params, evidence=dataclasses.replace(
            b.jstate.consensus_params.evidence, max_age_num_blocks=3,
            max_age_duration_ns=1))
    assert _verify_both(b, tev, jev, ts, js)[0] == \
        "EvidenceNotApplicableError"


def _attack(b, h, rng, tamper=False):
    """A light-client attack on height ``h``: a forged header signed by
    every validator of height ``h - 1`` (the common height)."""
    real = b.tbs.load_block(h).header
    header = dataclasses.replace(real, app_hash=rng.integers(
        0, 256, 32, np.uint8).tobytes())
    vals = b.tss.load_validators(h)
    bid = BlockID(header.hash(), PartSetHeader(1, rng.integers(
        0, 256, 32, np.uint8).tobytes()))
    commit = Commit(h, 0, bid, [
        CommitSig(BLOCK_ID_FLAG_COMMIT, v.address, real.time_ns + 1 + i, b"")
        for i, v in enumerate(vals.validators)])
    for i, v in enumerate(vals.validators):
        sig = b.by_addr[v.address].sign(commit.vote_sign_bytes(CHAIN, i))
        if tamper and i == 2:
            sig = bytes([sig[0] ^ 4]) + sig[1:]
        commit.signatures[i].signature = sig
    lb = LightBlock(header=header, commit=commit, validators=vals)
    tev = TE.LightClientAttackEvidence(
        conflicting_header_hash=header.hash(), conflicting_height=h,
        common_height=h - 1, byzantine_validators=list(vals.validators),
        total_voting_power=vals.total_voting_power(),
        timestamp_ns=b.tbs.load_block(h - 1).header.time_ns,
        conflicting_block=lb)
    jev = JC.unpack(TC.pack(tev))
    assert isinstance(jev.conflicting_block, JLightBlock)
    return tev, jev


def test_light_client_attack_verdicts_match(chain):
    b = Both(chain)
    rng = np.random.default_rng(3)
    tev, jev = _attack(b, 9, rng)
    _same_evidence(tev, jev)
    assert _verify_both(b, tev, jev) == ("ok",)
    tev, jev = _attack(b, 9, rng, tamper=True)
    assert _verify_both(b, tev, jev)[0] == "ErrInvalidSignature"
    t2 = dataclasses.replace(tev, conflicting_block=None)
    j2 = dataclasses.replace(jev, conflicting_block=None)
    assert _verify_both(b, t2, j2)[0] == "EvidenceError"


def test_pool_pending_check_and_update_match(chain):
    b = Both(chain)
    rng = np.random.default_rng(4)
    tp = TPool.EvidencePool(state_store=b.tss, block_store=b.tbs,
                            device="cpu")
    jp = JPool.EvidencePool(state_store=b.jss, block_store=b.jbs,
                            backend="cpu")
    out = {"t": [], "j": []}
    tp.on_evidence_added = lambda ev: out["t"].append(ev.hash())
    jp.on_evidence_added = lambda ev: out["j"].append(ev.hash())
    # no state yet: not applicable
    tev, jev = b.dup(4, 0, rng)
    assert _verdict(lambda: tp.add_evidence(tev)) == \
        _verdict(lambda: jp.add_evidence(jev))
    tp.state, jp.state = b.tstate, b.jstate
    assert tp.add_evidence(tev) is jp.add_evidence(jev) is True
    assert tp.add_evidence(tev) is jp.add_evidence(jev) is False
    # conflicting votes reported by consensus become evidence on update
    for h, idx in ((6, 1), (8, 2), (11, 3)):
        (a, c), (ja, jc) = b.vote_pair(h, idx, rng)
        tp.report_conflicting_votes(a, c)
        jp.report_conflicting_votes(ja, jc)
    (a, c), (ja, jc) = b.vote_pair(10, 0, rng, tamper=True)
    tp.report_conflicting_votes(a, c)           # dropped: bad signature
    jp.report_conflicting_votes(ja, jc)
    tp.update(b.tstate, [])
    jp.update(b.jstate, [])
    assert out["t"] == out["j"] and len(out["t"]) == 4
    tpend, jpend = tp.pending_evidence(0), jp.pending_evidence(0)
    assert [TC.pack(e) for e in tpend] == [JC.pack(e) for e in jpend]
    cap = len(TC.pack(tpend[0])) + 1
    assert [TC.pack(e) for e in tp.pending_evidence(cap)] == \
        [JC.pack(e) for e in jp.pending_evidence(cap)]
    assert [dataclasses.asdict(m) for m in tp.abci_evidence(tpend,
                                                            b.tstate)] == \
        [dataclasses.asdict(m) for m in jp.abci_evidence(jpend, b.jstate)]
    assert sorted(tp.db._data.items()) == sorted(jp.db._data.items())
    # check_evidence: pending ok, duplicates and committed refused
    for tl, jl in ((tpend[:2], jpend[:2]),
                   (tpend[:1] * 2, jpend[:1] * 2)):
        assert _verdict(lambda: tp.check_evidence(tl)) == \
            _verdict(lambda: jp.check_evidence(jl))
    fresh_t, fresh_j = b.dup(9, 1, rng)
    assert _verdict(lambda: tp.check_evidence([fresh_t])) == \
        _verdict(lambda: jp.check_evidence([fresh_j])) == ("ok",)
    tp.update(b.tstate, tpend[:1])
    jp.update(b.jstate, jpend[:1])
    assert _verdict(lambda: tp.check_evidence(tpend[:1])) == \
        _verdict(lambda: jp.check_evidence(jpend[:1]))
    assert sorted(tp.db._data.items()) == sorted(jp.db._data.items())
    assert tp.is_committed(tpend[0]) and not tp.is_pending(tpend[0])
    # the whole evidence list past the params' byte cap
    ts = dataclasses.replace(b.tstate)
    js = dataclasses.replace(b.jstate)
    for st, src in ((ts, b.tstate), (js, b.jstate)):
        st.consensus_params = dataclasses.replace(
            src.consensus_params, evidence=dataclasses.replace(
                src.consensus_params.evidence, max_bytes=cap))
    tp.state, jp.state = ts, js
    assert _verdict(lambda: tp.check_evidence(tpend[1:])) == \
        _verdict(lambda: jp.check_evidence(jpend[1:]))


def test_evidence_without_a_scheduler_raises(chain):
    vsched.set_scheduler(None)
    b = Both(chain)
    tev, _ = b.dup(3, 0, np.random.default_rng(5))
    with pytest.raises(RuntimeError, match="no verification scheduler"):
        TVerify.verify_evidence(tev, b.tstate, b.tss, device="cpu",
                                block_store=b.tbs)
