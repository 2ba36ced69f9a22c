"""The port's VoteSet and HeightVoteSet against the JAX package's, on the
CPU: the same votes in the same order (made from numpy seeds: powers,
blocks, timestamps, tampered signatures, conflicting votes, extensions)
go into both packages' vote sets, and every add result or error (class
and message), the +2/3 majority, the tallies, the bit arrays and the
``make_commit``/``make_extended_commit`` bytes (``codec.pack``) must be
equal.  The port's vote sets verify through its scheduler on ``"cpu"``
(the signatures are first verified in one batch, so most adds are cache
hits, as in consensus); the JAX package's run with no scheduler (direct
verification)."""

import asyncio

import numpy as np
import pytest
import torch

from cometbft_tpu.consensus.height_vote_set import HeightVoteSet as JHVS
from cometbft_tpu.crypto.keys import Ed25519PrivKey as JPriv
from cometbft_tpu.types import codec as JC
from cometbft_tpu.types.block_id import BlockID as JBID
from cometbft_tpu.types.block_id import PartSetHeader as JPSH
from cometbft_tpu.types.validator_set import Validator as JVal
from cometbft_tpu.types.validator_set import ValidatorSet as JVS
from cometbft_tpu.types.vote import Vote as JVote
from cometbft_tpu.types.vote_set import VoteSet as JVoteSet
from cometbft_tpu_torch.consensus.height_vote_set import HeightVoteSet
from cometbft_tpu_torch.crypto import scheduler as vsched
from cometbft_tpu_torch.crypto.keys import Ed25519PrivKey as TPriv
from cometbft_tpu_torch.types import codec as TC
from cometbft_tpu_torch.types.block_id import BlockID, PartSetHeader
from cometbft_tpu_torch.types.validator_set import Validator, ValidatorSet
from cometbft_tpu_torch.types.vote import PRECOMMIT_TYPE, PREVOTE_TYPE, Vote
from cometbft_tpu_torch.types.vote_set import VoteSet, VoteSetError

torch.set_num_threads(1)

CHAIN = "vote-set-test"
H = 9


@pytest.fixture(autouse=True)
def _scheduler():
    """The port's vote sets need a registered scheduler (on the CPU)."""
    vsched.set_scheduler(None)
    sched = vsched.VerificationScheduler(device="cpu", max_wait_ms=2)
    vsched.set_scheduler(sched)
    yield sched
    vsched.set_scheduler(None)


class Fixture:
    """Validators from a numpy seed (random powers), both packages' sets,
    and a signer making one vote as both packages' Vote objects."""

    def __init__(self, seed, n=7):
        rng = np.random.default_rng(seed)
        self.rng = rng
        self.privs = [TPriv(rng.integers(0, 256, 32, np.uint8).tobytes())
                      for _ in range(n)]
        powers = [int(p) for p in rng.integers(1, 50, n)]
        self.tvals = ValidatorSet([Validator(p.pub_key(), w)
                                   for p, w in zip(self.privs, powers)])
        self.jvals = JVS([JVal(JPriv(p.bytes()).pub_key(), w)
                          for p, w in zip(self.privs, powers)])
        assert [v.address for v in self.tvals.validators] == \
            [v.address for v in self.jvals.validators]
        self.by_addr = {p.pub_key().address(): p for p in self.privs}

    def block(self, tag: int):
        if tag < 0:
            return BlockID(), JBID()
        h = bytes([tag]) * 32
        p = bytes([tag ^ 0xFF]) * 32
        return BlockID(h, PartSetHeader(2, p)), JBID(h, JPSH(2, p))

    def vote(self, typ, idx, tag, rnd=0, height=H, ts=None, ext=b"",
             sign_ext=False, tamper=False, addr=None):
        tb, jb = self.block(tag)
        # an index past the set signs as validator 0
        v = self.tvals.get_by_index(idx) or self.tvals.get_by_index(0)
        ts = ts if ts is not None else 1_000 + int(self.rng.integers(1, 10**6))
        kw = dict(type=typ, height=height, round=rnd, timestamp_ns=ts,
                  validator_address=addr or v.address, validator_index=idx,
                  extension=ext)
        tv, jv = Vote(block_id=tb, **kw), JVote(block_id=jb, **kw)
        priv = self.by_addr[v.address]
        sig = priv.sign(tv.sign_bytes(CHAIN))
        if tamper:
            sig = bytes([sig[0] ^ 0x40]) + sig[1:]
        tv.signature = jv.signature = sig
        if sign_ext:
            es = priv.sign(tv.extension_sign_bytes(CHAIN))
            tv.extension_signature = jv.extension_signature = es
        return tv, jv


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as e:
        return ("err", type(e).__name__, str(e))


def _prefetch(fx, pairs):
    """Verify the votes' signatures in one scheduler batch first (the
    consensus prefetch), so the vote sets mostly hit the cache."""
    async def main():
        s = vsched.get_scheduler()
        await s.start()
        try:
            await asyncio.gather(*(
                s.verify(fx.tvals.get_by_index(tv.validator_index).pub_key,
                         tv.sign_bytes(CHAIN), tv.signature)
                for tv, _ in pairs
                if 0 <= tv.validator_index < fx.tvals.size()))
        finally:
            await s.stop()

    asyncio.run(main())


def _compare_state(tvs, jvs):
    assert tvs.sum == jvs.sum
    tm, th = tvs.two_thirds_majority()
    jm, jh = jvs.two_thirds_majority()
    assert th == jh
    assert (tm.key() if tm else None) == (jm.key() if jm else None)
    assert tvs.has_two_thirds_any() == jvs.has_two_thirds_any()
    assert tvs.has_all() == jvs.has_all()
    assert tvs.bit_array().get_true_indices() == jvs.bit_array().get_true_indices()
    assert sorted(tvs.votes_by_block) == sorted(jvs.votes_by_block)
    for k in tvs.votes_by_block:
        assert tvs.votes_by_block[k].bit_array.get_true_indices() == \
            jvs.votes_by_block[k].bit_array.get_true_indices()
        assert tvs.votes_by_block[k].sum == jvs.votes_by_block[k].sum
    for i in range(tvs.val_set.size()):
        a, b = tvs.get_by_index(i), jvs.get_by_index(i)
        assert (a is None) == (b is None)
        if a is not None:
            assert a.encode() == b.encode()


def _sequence(fx, typ, ext=False):
    """A vote sequence over blocks 1 and 2 and nil: valid votes, exact
    duplicates, a re-signed duplicate, conflicts (valid and tampered),
    bad index, wrong address, wrong height and round, a tampered
    signature, and extension cases when ``ext``."""
    n = fx.tvals.size()
    seq = []
    for i in range(n):
        tag = 1 if i % 3 else (2 if i % 2 else -1)
        kw = {}
        if ext and typ == PRECOMMIT_TYPE and tag >= 0:
            kw = dict(ext=b"e%d" % i, sign_ext=i != 4)
        seq.append(fx.vote(typ, i, tag, **kw))
    seq.append(seq[1])                                   # exact duplicate
    seq.append(fx.vote(typ, 1, 1, ts=seq[1][0].timestamp_ns + 1))
    ekw = dict(ext=b"c", sign_ext=True) if ext else {}
    seq.append(fx.vote(typ, 2, 2, **ekw))                # conflict, valid
    seq.append(fx.vote(typ, 5, 2, tamper=True, **ekw))   # conflict, bad sig
    seq.append(fx.vote(typ, n + 3, 1))                   # bad index
    seq.append(fx.vote(typ, 3, 1, addr=b"\x01" * 20))    # wrong address
    seq.append(fx.vote(typ, 3, 1, height=H + 1))         # wrong height
    seq.append(fx.vote(typ, 3, 1, rnd=1))                # wrong round
    if ext:
        seq.append(fx.vote(PREVOTE_TYPE, 0, 1))          # wrong type
    return seq


@pytest.mark.parametrize("seed,typ,ext", [
    (1, PREVOTE_TYPE, False), (2, PRECOMMIT_TYPE, False),
    (3, PRECOMMIT_TYPE, True)])
def test_same_votes_same_results(seed, typ, ext):
    fx = Fixture(seed)
    tvs = VoteSet(CHAIN, H, 0, typ, fx.tvals, extensions_enabled=ext)
    jvs = JVoteSet(CHAIN, H, 0, typ, fx.jvals, extensions_enabled=ext)
    seq = _sequence(fx, typ, ext)
    # the fresh validators' own votes verify in one batch (their gossip)
    _prefetch(fx, seq[:fx.tvals.size()])
    results = []
    for k, (tv, jv) in enumerate(seq):
        a = _outcome(lambda: tvs.add_vote(tv))
        b = _outcome(lambda: jvs.add_vote(jv))
        if a[0] == "err" and a[1] == "ConflictingVoteError":
            a, b = a[:2], b[:2]
        assert a == b, (k, a, b)
        results.append(a)
        _compare_state(tvs, jvs)
    assert ("err", "ConflictingVoteError") in results
    if typ == PRECOMMIT_TYPE and tvs.has_two_thirds_majority():
        assert TC.pack(tvs.make_commit()) == JC.pack(jvs.make_commit())
        assert TC.pack(tvs.make_extended_commit()) == \
            JC.pack(jvs.make_extended_commit())
    else:
        assert _outcome(tvs.make_commit)[:2] == _outcome(jvs.make_commit)[:2]


def test_peer_maj23_tracks_conflicts_into_majority():
    """A peer's +2/3 claim for block 2 makes conflicting votes for it
    count: the tracked block can cross +2/3 through conflicts."""
    fx = Fixture(4, n=4)
    tvs = VoteSet(CHAIN, H, 0, PRECOMMIT_TYPE, fx.tvals)
    jvs = JVoteSet(CHAIN, H, 0, PRECOMMIT_TYPE, fx.jvals)
    first = [fx.vote(PRECOMMIT_TYPE, i, 1) for i in range(4)]
    second = [fx.vote(PRECOMMIT_TYPE, i, 2) for i in range(4)]
    _prefetch(fx, first)
    for tv, jv in first[:2]:
        assert tvs.add_vote(tv) == jvs.add_vote(jv)
    tb, jb = fx.block(2)
    tvs.set_peer_maj23("p", tb)
    jvs.set_peer_maj23("p", jb)
    a = _outcome(lambda: tvs.set_peer_maj23("p", fx.block(1)[0]))
    b = _outcome(lambda: jvs.set_peer_maj23("p", fx.block(1)[1]))
    assert a == b and a[0] == "err"
    for tv, jv in second:
        a, b = _outcome(lambda: tvs.add_vote(tv)), \
            _outcome(lambda: jvs.add_vote(jv))
        assert a[:2] == b[:2]
        _compare_state(tvs, jvs)
    assert tvs.bit_array_by_block_id(tb).get_true_indices() == \
        jvs.bit_array_by_block_id(jb).get_true_indices()
    assert TC.pack(tvs.make_commit()) == JC.pack(jvs.make_commit())


def test_height_vote_set_rounds_and_catchup_cap():
    fx = Fixture(5, n=4)
    th = HeightVoteSet(CHAIN, H, fx.tvals)
    jh = JHVS(CHAIN, H, fx.jvals)
    for r in (0, 3, 1):
        th.set_round(r)
        jh.set_round(r)
        assert sorted(th._sets) == sorted(jh._sets)
    votes = [fx.vote(PREVOTE_TYPE, i, 1, rnd=r)
             for r, i in ((7, 0), (8, 1), (9, 2), (4, 3))]
    _prefetch(fx, votes)
    for tv, jv in votes:
        a = _outcome(lambda: th.add_vote(tv, "peer"))
        b = _outcome(lambda: jh.add_vote(jv, "peer"))
        assert a == b
    assert sorted(th._sets) == sorted(jh._sets)
    assert th.pol_info()[0] == jh.pol_info()[0]


def test_vote_set_without_a_scheduler_raises():
    vsched.set_scheduler(None)
    fx = Fixture(6, n=4)
    tvs = VoteSet(CHAIN, H, 0, PREVOTE_TYPE, fx.tvals)
    with pytest.raises(RuntimeError, match="no verification scheduler"):
        tvs.add_vote(fx.vote(PREVOTE_TYPE, 0, 1)[0])
    with pytest.raises(VoteSetError):
        VoteSet(CHAIN, H, 0, 7, fx.tvals)
