"""The port's reactor messages (``cometbft_tpu_torch/consensus/reactor.py``,
``mempool/reactor.py``, ``evidence/reactor.py``, packed with the port's
MessagePack subset) against the JAX package's, on the CPU: every
consensus, mempool and evidence message packs to the JAX bytes, each
package unpacks the other's, and a port reactor fed JAX frames reaches
the same peer state and pool calls as a JAX reactor fed the port's.
Objects are made in the JAX package from numpy seeds and carried over
with the codecs (``codec.pack`` in one package, ``codec.unpack`` in the
other: equal bytes, PR 9)."""

import asyncio

import numpy as np
import pytest

from cometbft_tpu.consensus import reactor as JR
from cometbft_tpu.crypto.keys import Ed25519PrivKey as JPriv
from cometbft_tpu.crypto.merkle import Proof as JProof
from cometbft_tpu.evidence import reactor as JER
from cometbft_tpu.libs.bits import BitArray as JBits
from cometbft_tpu.mempool import reactor as JMR
from cometbft_tpu.types import codec as JC
from cometbft_tpu.types.block_id import BlockID as JBlockID
from cometbft_tpu.types.block_id import PartSetHeader as JPSH
from cometbft_tpu.types.commit import BLOCK_ID_FLAG_COMMIT
from cometbft_tpu.types.commit import Commit as JCommit
from cometbft_tpu.types.commit import CommitSig as JCommitSig
from cometbft_tpu.types.evidence import DuplicateVoteEvidence as JDup
from cometbft_tpu.types.part_set import Part as JPart
from cometbft_tpu.types.validator_set import Validator as JVal
from cometbft_tpu.types.validator_set import ValidatorSet as JValSet
from cometbft_tpu.types.vote import PRECOMMIT_TYPE, PREVOTE_TYPE
from cometbft_tpu.types.vote import Proposal as JProposal
from cometbft_tpu.types.vote import Vote as JVote
from cometbft_tpu_torch.consensus import reactor as TR
from cometbft_tpu_torch.crypto.merkle import Proof as TProof
from cometbft_tpu_torch.evidence import reactor as TER
from cometbft_tpu_torch.libs.bits import BitArray
from cometbft_tpu_torch.mempool import reactor as TMR
from cometbft_tpu_torch.mempool.mempool import TxKey
from cometbft_tpu_torch.types import codec as TC
from cometbft_tpu_torch.types.part_set import Part as TPart

pytestmark = pytest.mark.timeout(60)


def _to_port(obj):
    return TC.unpack(JC.pack(obj))


def _rb(rng, n):
    return rng.integers(0, 256, n, dtype=np.uint8).tobytes()


def _jax_objects(seed):
    rng = np.random.default_rng(seed)
    bid = JBlockID(_rb(rng, 32), JPSH(int(rng.integers(1, 5)),
                                      _rb(rng, 32)))
    vote = JVote(type=PREVOTE_TYPE, height=int(rng.integers(1, 1 << 40)),
                 round=int(rng.integers(0, 5)), block_id=bid,
                 timestamp_ns=int(rng.integers(0, 1 << 62)),
                 validator_address=_rb(rng, 20),
                 validator_index=int(rng.integers(0, 150)),
                 signature=_rb(rng, 64),
                 extension=_rb(rng, int(rng.integers(0, 30))),
                 extension_signature=_rb(rng, 64))
    prop = JProposal(height=vote.height, round=vote.round,
                     pol_round=int(rng.integers(-1, 2)), block_id=bid,
                     timestamp_ns=vote.timestamp_ns,
                     signature=_rb(rng, 64))
    n = int(rng.integers(1, 6))
    part = JPart(int(rng.integers(0, n)), _rb(rng, 700),
                 JProof(n, int(rng.integers(0, n)), _rb(rng, 32),
                        tuple(_rb(rng, 32) for _ in range(3))))
    commit = JCommit(vote.height, vote.round, bid, [
        JCommitSig(BLOCK_ID_FLAG_COMMIT, _rb(rng, 20),
                   int(rng.integers(0, 1 << 62)), _rb(rng, 64))
        for _ in range(4)])
    bits = JBits(int(rng.integers(1, 200)))
    for i in rng.integers(0, bits.size, 7):
        bits.set_index(int(i), True)
    return rng, vote, prop, part, commit, bits


def _messages(pkg, codec, ba_to_wire, part_to_wire, objs):
    rng, vote, prop, part, commit, bits = objs
    P = pkg._pack
    h, r = vote.height, vote.round
    psh = prop.block_id.part_set_header
    return [
        P("nrs", h=h, r=r, s=3, lcr=-1),
        P("hv", h=h, r=r, t=PRECOMMIT_TYPE, i=vote.validator_index),
        P("nvb", h=h, r=r, psh=codec.to_dict(psh), bits=ba_to_wire(bits)),
        P("maj23", h=h, r=r, t=PREVOTE_TYPE,
          bid=codec.to_dict(prop.block_id)),
        P("prop", p=codec.to_dict(prop)),
        P("pol", h=h, polr=prop.pol_round, pol=ba_to_wire(bits)),
        P("part", h=h, r=r, p=part_to_wire(part)),
        P("vote", v=codec.to_dict(vote)),
        P("vsb", h=h, r=r, t=PREVOTE_TYPE, bits=ba_to_wire(bits)),
        P("commit", c=codec.to_dict(commit)),
    ]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_consensus_messages_equal_and_cross_decode(seed):
    jobj = _jax_objects(seed)
    jpart = jobj[3]
    tpart = TPart(jpart.index, jpart.bytes_, TProof(*jpart.proof))
    tobj = (jobj[0], _to_port(jobj[1]), _to_port(jobj[2]), tpart,
            _to_port(jobj[4]), BitArray(jobj[5].size, jobj[5]._bits))
    jm = _messages(JR, JC, JR._ba_to_wire, JR._part_to_wire, jobj)
    tm = _messages(TR, TC, TR._ba_to_wire, TR._part_to_wire, tobj)
    assert jm == tm
    for raw in jm:
        d = TR._unpack(raw)
        assert d == JR._unpack(raw)
        for key in ("p", "v", "c", "bid", "psh"):
            if key in d and d["@"] != "part":
                obj = TC.from_dict(d[key])
                assert JC.pack(JC.from_dict(d[key])) == TC.pack(obj)
        if d["@"] == "part":
            p = TR._part_from_wire(d["p"])
            assert TR._pack("part", h=d["h"], r=d["r"],
                            p=TR._part_to_wire(p)) == raw
        for key in ("bits", "pol"):
            if key in d:
                ba = TR._ba_from_wire(d[key])
                assert ba == BitArray(jobj[5].size, jobj[5]._bits)


class _Peer:
    def __init__(self, pid="peer0000aaaa"):
        self.id = pid
        self.sent: list = []
        self._data: dict = {}

    def send(self, chan, msg):
        self.sent.append((chan, msg))
        return True

    def get(self, k):
        return self._data.get(k)

    def set(self, k, v):
        self._data[k] = v


@pytest.mark.parametrize("seed", [4, 5])
def test_peer_state_follows_messages_alike(seed):
    """The same state-channel sequence leaves the two packages'
    PeerStates equal."""
    rng = np.random.default_rng(seed)
    tps, jps = TR.PeerState(), JR.PeerState()
    h = 5
    for _ in range(60):
        kind = int(rng.integers(0, 3))
        if kind == 0:
            h += int(rng.integers(0, 2))
            args = (h, int(rng.integers(0, 3)), int(rng.integers(1, 8)),
                    int(rng.integers(-1, 2)))
            tps.apply_new_round_step(*args)
            jps.apply_new_round_step(*args)
        elif kind == 1:
            args = (h - int(rng.integers(0, 2)), int(rng.integers(0, 3)),
                    int(rng.choice([PREVOTE_TYPE, PRECOMMIT_TYPE])),
                    int(rng.integers(0, 10)), 10)
            tps.set_has_vote(*args)
            jps.set_has_vote(*args)
        else:
            bits = int(rng.integers(0, 1 << 10))
            args = (h, int(rng.integers(0, 3)),
                    int(rng.choice([PREVOTE_TYPE, PRECOMMIT_TYPE])))
            tps.apply_vote_set_bits(*args, BitArray(10, bits))
            jps.apply_vote_set_bits(*args, JBits(10, bits))
        for name in ("height", "round", "step", "last_commit_round"):
            assert getattr(tps, name) == getattr(jps, name)
        for name in ("prevotes", "precommits"):
            assert {k: v._bits for k, v in getattr(tps, name).items()} == \
                {k: v._bits for k, v in getattr(jps, name).items()}
        assert (tps.last_commit._bits if tps.last_commit else None) == \
            (jps.last_commit._bits if jps.last_commit else None)


# ---------------------------------------------------------------- mempool

class _Cache:
    def has(self, key):
        return False


class _Mempool:
    """What the mempool reactor reads of a mempool."""

    def __init__(self, txs=()):
        self.txs = {TxKey(t): t for t in txs}
        self.cache = _Cache()
        self.checked: list = []
        self.max_txs = 100
        self.on_txs_removed = None

    def get_tx(self, key):
        return self.txs.get(key)

    def is_full(self):
        return False

    def items(self):
        return list(self.txs.items())

    async def check_tx(self, tx):
        self.checked.append(tx)


@pytest.mark.parametrize("seed", [0, 1])
def test_mempool_frames_equal_and_cross_decode(seed):
    rng = np.random.default_rng(seed)
    txs = [_rb(rng, int(rng.integers(1, 300))) for _ in range(20)]
    keys = [TxKey(t) for t in txs]

    async def frames(mod):
        mr = mod.MempoolReactor(_Mempool(txs), batch_bytes=2048)
        peer = _Peer()
        mr.add_peer(peer)                  # the capability hello
        await mr.stop()                    # before its tasks ever run
        mr._send_ann(peer, keys, set())
        mr._send_req(peer, keys[:7])
        mr._on_request(peer, keys)
        return [m for _, m in peer.sent]

    loop = asyncio.new_event_loop()
    try:
        jf = loop.run_until_complete(frames(JMR))
        tf = loop.run_until_complete(frames(TMR))
    finally:
        loop.close()
    assert jf == tf and len(tf) > 4

    async def feed(mod, raw_frames):
        mp = _Mempool()
        mr = mod.MempoolReactor(mp)
        peer = _Peer()
        for raw in raw_frames:
            mr.receive(mod.MEMPOOL_CHANNEL, peer, raw)
        await asyncio.sleep(0)
        await asyncio.sleep(0)
        return sorted(mp.checked), sorted(mr._requests), [
            m for _, m in peer.sent], peer.id in mr._capable

    loop = asyncio.new_event_loop()
    try:
        got_t = loop.run_until_complete(feed(TMR, jf))
        got_j = loop.run_until_complete(feed(JMR, tf))
    finally:
        loop.close()
    assert got_t == got_j
    assert sorted(got_t[0]) == sorted(txs)


# --------------------------------------------------------------- evidence

def _jax_evidence(seed):
    rng = np.random.default_rng(seed)
    keys = [JPriv.from_secret(b"ev%d" % i) for i in range(4)]
    vals = JValSet([JVal(k.pub_key(), 10) for k in keys])
    k = keys[int(rng.integers(0, 4))]
    idx, _ = vals.get_by_address(k.pub_key().address())
    votes = []
    for _ in range(2):
        v = JVote(type=PRECOMMIT_TYPE, height=9, round=0, block_id=JBlockID(_rb(rng, 32),
                                             JPSH(1, _rb(rng, 32))),
                  timestamp_ns=7, validator_address=k.pub_key().address(),
                  validator_index=idx)
        v.signature = k.sign(v.sign_bytes("ev-net"))
        votes.append(v)
    return JDup.from_votes(votes[0], votes[1], 1234, vals)


class _Pool:
    def __init__(self, pending=()):
        self.pending = list(pending)
        self.added: list = []
        self.on_evidence_added = None

    def pending_evidence(self, max_bytes):
        return self.pending

    def add_evidence(self, ev):
        self.added.append(ev)
        return True


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_evidence_messages_equal_and_cross_decode(seed):
    jev = _jax_evidence(seed)
    tev = _to_port(jev)
    jpeer, tpeer = _Peer(), _Peer()
    JER.EvidenceReactor(_Pool([jev])).add_peer(jpeer)
    TER.EvidenceReactor(_Pool([tev])).add_peer(tpeer)
    assert jpeer.sent == tpeer.sent and len(tpeer.sent) == 1
    chan, raw = tpeer.sent[0]
    assert chan == TER.EVIDENCE_CHANNEL == JER.EVIDENCE_CHANNEL
    tpool, jpool = _Pool(), _Pool()
    TER.EvidenceReactor(tpool).receive(chan, _Peer(), raw)
    JER.EvidenceReactor(jpool).receive(chan, _Peer(), raw)
    assert TC.pack(tpool.added[0]) == JC.pack(jpool.added[0]) == \
        JC.pack(jev)
