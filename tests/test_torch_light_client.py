"""The light client of the port against the JAX package's on the same
chains: the client (skipping with bisection, sequential, backwards,
pruning), the divergence detector (forked witness, trace walk with
two-sided evidence, lagging witness), the trusted store, ``MemDB``,
votes, proposals, evidence and proposer rotation.

Chains come from ``cometbft_tpu.testing.make_light_chain`` and cross
into the port through ``cometbft_tpu_torch.convert`` (numpy arrays and
field values, with each set's proposer priorities and proposer).  The
port's client runs with ``device="cpu"`` (its plain versions), the JAX
client with ``backend="cpu"``.  Each case must end the same way in both
(the same result or the same error class and message), fetch the same
heights from each provider in the same order, report evidence with the
same hashes to the same providers, and leave the same keys and bytes in
the trusted store."""

import asyncio
import dataclasses

import numpy as np
import pytest
import torch

from cometbft_tpu import light as JL
from cometbft_tpu.crypto.keys import Ed25519PrivKey as JPriv
from cometbft_tpu.light import detector as JDet
from cometbft_tpu.storage import db as JDB
from cometbft_tpu.testing import make_light_chain
from cometbft_tpu.types import evidence as JEv
from cometbft_tpu.types import vote as JVote
from cometbft_tpu.types.block_id import BlockID as JBlockID
from cometbft_tpu.types.block_id import PartSetHeader as JPSH
from cometbft_tpu.types.header import Header as JHeader
from cometbft_tpu.types.validator_set import Validator as JValidator
from cometbft_tpu.types.validator_set import ValidatorSet as JValidatorSet
from cometbft_tpu_torch import convert
from cometbft_tpu_torch import light as TL
from cometbft_tpu_torch.crypto.keys import Ed25519PubKey as TPub
from cometbft_tpu_torch.light import detector as TDet
from cometbft_tpu_torch.storage import db as TDB
from cometbft_tpu_torch.types import evidence as TEv
from cometbft_tpu_torch.types import vote as TVote
from cometbft_tpu_torch.types.block_id import BlockID as TBlockID
from cometbft_tpu_torch.types.block_id import PartSetHeader as TPSH
from cometbft_tpu_torch.types.validator_set import Validator as TValidator
from cometbft_tpu_torch.types.validator_set import ValidatorSet as TValidatorSet

# the plain versions run on tensors of a few lanes: one intra-op thread is
# as fast, and leaves the cores to the other test workers
torch.set_num_threads(1)

pytestmark = pytest.mark.timeout(900)

CHAIN = "light-chain"
PERIOD = 3600 * 1_000_000_000       # 1 h trusting period


def run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


def _now(chain):
    return chain[-1].header.time_ns + 60 * 1_000_000_000


# ------------------------------------------------------------ conversion

def _commit_args(c):
    n = c.size()
    sigs = np.zeros((n, 96), np.uint8)
    for i, cs in enumerate(c.signatures):
        sigs[i, :len(cs.signature)] = np.frombuffer(cs.signature, np.uint8)
    bid = c.block_id
    return dict(height=c.height, round_=c.round, block_hash=bid.hash,
                part_set_total=bid.part_set_header.total,
                part_set_hash=bid.part_set_header.hash,
                flags=[cs.block_id_flag for cs in c.signatures],
                timestamps_ns=[cs.timestamp_ns for cs in c.signatures],
                addresses=[cs.validator_address for cs in c.signatures],
                sigs=sigs, sig_lens=[len(cs.signature)
                                     for cs in c.signatures],
                agg_signature=c.agg_signature, agg_signers=c.agg_signers)


def _header_args(h):
    f = {x.name: getattr(h, x.name) for x in dataclasses.fields(JHeader)
         if x.name != "last_block_id"}
    b = h.last_block_id
    f["last_block_id"] = (b.hash, b.part_set_header.total,
                          b.part_set_header.hash)
    return f


def _set_args(vs):
    vals = vs.validators
    return dict(pubs=[v.pub_key.bytes() for v in vals],
                powers=[v.voting_power for v in vals],
                key_types=[v.pub_key.type() for v in vals],
                priorities=[v.proposer_priority for v in vals],
                proposer_address=vs.proposer.address if vs.proposer
                else b"")


def port_block(lb):
    return convert.light_block_from_arrays(
        _header_args(lb.header), commit=_commit_args(lb.commit),
        **_set_args(lb.validators))


def port_chain(chain):
    return [port_block(lb) for lb in chain]


# -------------------------------------------------------------- providers

def _provider(base, not_found):
    class ChainProvider(base):
        """Serves a chain; records the heights fetched, in order, and the
        evidence reported to it."""

        def __init__(self, chain, name="prov"):
            self.by_height = {lb.height: lb for lb in chain}
            self.tip = max(self.by_height)
            self.name = name
            self.fetched = []
            self.reported = []

        def id(self):
            return self.name

        async def light_block(self, height):
            self.fetched.append(height)
            if height == 0:
                height = self.tip
            lb = self.by_height.get(height)
            if lb is None:
                raise not_found(f"{self.name}: {height}")
            return lb

        async def report_evidence(self, evidence):
            self.reported.append(evidence)

    return ChainProvider


JProv = _provider(JL.Provider, JL.ErrLightBlockNotFound)
TProv = _provider(TL.Provider, TL.ErrLightBlockNotFound)


class Side:
    """One package's client over one package's chains."""

    def __init__(self, pkg, prov, chains, client_kw, device_kw):
        self.pkg = pkg
        self.providers = {name: prov(c, name) for name, c in chains.items()}
        self.client_kw = client_kw
        self.device_kw = device_kw

    def client(self, primary, witnesses=(), trust_height=1, **kw):
        p = self.providers[primary]
        anchor = p.by_height[trust_height]
        return self.pkg.Client(
            CHAIN, self.pkg.TrustOptions(PERIOD, trust_height,
                                         anchor.header.hash()),
            p, witnesses=[self.providers[w] for w in witnesses],
            **self.client_kw, **self.device_kw, **kw)


def sides(chains, **client_kw):
    """(JAX side, port side) over ``chains`` ({provider name: JAX chain})."""
    return (Side(JL, JProv, chains, client_kw, {"backend": "cpu"}),
            Side(TL, TProv, {k: port_chain(c) for k, c in chains.items()},
                 client_kw, {"device": "cpu"}))


def outcome(coro_fn):
    """Run ``coro_fn()``: ("ok", header hash) or (error class name,
    message, witness, common height)."""
    try:
        lb = run(coro_fn())
        return ("ok", None if lb is None else lb.header.hash())
    except Exception as e:
        return (type(e).__name__, str(e), getattr(e, "witness_id", None),
                getattr(e, "common_height", None))


def record(side, client):
    """What a run leaves behind: fetches and evidence per provider, the
    store's keys and bytes, the surviving witnesses."""
    return {
        "fetched": {n: list(p.fetched) for n, p in side.providers.items()},
        "evidence": {n: [(type(e).__name__, e.hash(), e.common_height,
                          e.conflicting_height) for e in p.reported]
                     for n, p in side.providers.items()},
        "store": list(client.store.db.iterate()),
        "witnesses": [w.id() for w in client.witnesses],
    }


def both(chains, action, client_args, **client_kw):
    """Run ``action(client)`` (a coroutine function) on each side; return
    the (outcome, record) pairs."""
    out = []
    for side in sides(chains, **client_kw):
        client = side.client(**client_args)
        out.append((outcome(lambda: action(client)), record(side, client)))
    return out


def assert_same(pair):
    (jo, jr), (to, tr) = pair
    assert to == jo
    assert tr == jr
    return jo, jr


# ------------------------------------------------------------ client cases

def test_skipping_sync_bisects_like_jax():
    chain = make_light_chain(200, n_vals=4, rotate_every=10)
    o, r = assert_same(both(
        {"primary": chain},
        lambda c: c.verify_light_block_at_height(200),
        {"primary": "primary"}, now_ns=lambda: _now(chain)))
    assert o == ("ok", chain[199].header.hash())
    fetched = r["fetched"]["primary"]
    assert len(fetched) < 60 and len(set(fetched)) > 3, fetched
    assert [k[3:] for k, _ in r["store"]][-1] == (200).to_bytes(8, "big")


def test_skipping_sync_refuses_an_unlinked_target_like_jax():
    """A target whose commit was signed by another key set: bisection ends
    at an adjacent pair that does not verify, with the same error."""
    chain = make_light_chain(12, n_vals=4)
    forged = make_light_chain(12, n_vals=4, seed=b"forged")
    o, _ = assert_same(both(
        {"primary": chain[:8] + forged[8:]},
        lambda c: c.verify_light_block_at_height(12),
        {"primary": "primary"}, now_ns=lambda: _now(chain)))
    assert o[0] == "ErrInvalidHeader", o


def test_sequential_mode_like_jax():
    chain = make_light_chain(60, n_vals=4)
    o, r = assert_same(both(
        {"primary": chain},
        lambda c: c.verify_light_block_at_height(60),
        {"primary": "primary"}, mode=JL.SEQUENTIAL,
        now_ns=lambda: _now(chain)))
    assert o == ("ok", chain[59].header.hash())
    assert len(r["store"]) == 60


def test_sequential_mode_flags_a_bad_signature_like_jax():
    chain = make_light_chain(20, n_vals=4)
    bad = chain[13].commit.signatures[2]
    sig = bytearray(bad.signature)
    sig[5] ^= 1
    bad.signature = bytes(sig)
    o, r = assert_same(both(
        {"primary": chain},
        lambda c: c.verify_light_block_at_height(20),
        {"primary": "primary"}, mode=JL.SEQUENTIAL,
        now_ns=lambda: _now(chain)))
    assert o[0] == "ErrBatchItemInvalid" and "height 14" in o[1], o
    assert len(r["store"]) == 1             # only the anchor


def test_wrong_trust_hash_and_expired_anchor_like_jax():
    chain = make_light_chain(5, n_vals=4)
    o, _ = assert_same(both(
        {"primary": chain}, lambda c: c.verify_light_block_at_height(3),
        {"primary": "primary"}, now_ns=lambda: _now(chain)))
    assert o == ("ok", chain[2].header.hash())
    late = chain[0].header.time_ns + PERIOD + 1
    o, _ = assert_same(both(
        {"primary": chain}, lambda c: c.verify_light_block_at_height(5),
        {"primary": "primary"}, now_ns=lambda: late))
    assert o[0] == "LightClientError" and "expired" in o[1], o

    async def wrong_anchor(c):
        c.trust.header_hash = b"\x00" * 32
        return await c.initialize()
    o, _ = assert_same(both({"primary": chain}, wrong_anchor,
                            {"primary": "primary"},
                            now_ns=lambda: _now(chain)))
    assert o[0] == "LightClientError" and "trusted hash" in o[1], o


def test_update_to_the_latest_like_jax():
    chain = make_light_chain(30, n_vals=4, rotate_every=3, seed=b"upd")

    async def twice(c):
        await c.update()
        return await c.update()
    o, r = assert_same(both({"primary": chain}, twice,
                            {"primary": "primary"},
                            now_ns=lambda: _now(chain)))
    assert o == ("ok", chain[29].header.hash())


def test_forked_witness_like_jax():
    chain = make_light_chain(30, n_vals=4)
    fork = make_light_chain(30, n_vals=4, seed=b"fork")
    o, r = assert_same(both(
        {"primary": chain, "witness": chain[:20] + fork[20:]},
        lambda c: c.verify_light_block_at_height(25),
        {"primary": "primary", "witnesses": ("witness",)},
        now_ns=lambda: _now(chain)))
    # the fork is signed by its own keys, so its block verifies on its
    # own: a divergence from the trusted root, evidence to both sides
    assert o[:4] == ("DivergenceError", o[1], "witness", 1), o
    assert [e[2:] for e in r["evidence"]["primary"]] == [(1, 25)]
    assert [e[2:] for e in r["evidence"]["witness"]] == [(1, 25)]
    assert len(r["store"]) == 1


def test_detector_trace_walk_two_sided_evidence_like_jax():
    H, F = 30, 22
    chain = make_light_chain(H, n_vals=4)
    forked = make_light_chain(H, n_vals=4, fork_at=F, fork_skew_ns=777)
    o, r = assert_same(both(
        {"primary": chain, "witness": forked},
        lambda c: c.verify_light_block_at_height(H),
        {"primary": "primary", "witnesses": ("witness",)},
        mode=JL.SEQUENTIAL, now_ns=lambda: _now(chain)))
    assert o[0] == "DivergenceError" and o[2] == "witness" and o[3] == F
    ev = r["evidence"]
    assert [e[2:] for e in ev["witness"]] == [(F, F + 1)]
    assert [e[2:] for e in ev["primary"]] == [(F, F + 1)]
    assert ev["witness"][0][1] != ev["primary"][0][1]
    assert len(r["store"]) == 1             # nothing divergent was saved


def test_detector_drops_a_lagging_witness_like_jax():
    chain = make_light_chain(10, n_vals=4)
    tchain = port_chain(chain)
    assert JDet.MAX_WITNESS_LAG_STRIKES == TDet.MAX_WITNESS_LAG_STRIKES == 3
    seen = []
    for side, c, det in zip(sides({"primary": chain,
                                   "laggard": chain[:2],
                                   "healthy": chain},
                                  now_ns=lambda: _now(chain)),
                            (chain, tchain), (JDet, TDet)):
        client = side.client("primary", ("laggard", "healthy"))

        async def main():
            client.store.save(c[0])
            present = []
            for _ in range(det.MAX_WITNESS_LAG_STRIKES):
                present.append([w.id() for w in client.witnesses])
                await det.detect_divergence(client, c[7], _now(chain))
            return present
        seen.append((run(main()), record(side, client)))
    assert seen[1] == seen[0]
    assert seen[0][0][-1] == ["laggard", "healthy"]
    assert seen[0][1]["witnesses"] == ["healthy"]


def test_backwards_verification_like_jax():
    chain = make_light_chain(40, n_vals=4)

    async def main(c):
        await c.initialize()
        return await c.verify_light_block_at_height(10)
    o, r = assert_same(both({"primary": chain}, main,
                            {"primary": "primary", "trust_height": 30},
                            now_ns=lambda: _now(chain)))
    assert o == ("ok", chain[9].header.hash())
    assert len(r["store"]) == 2
    # a broken link below the anchor raises the same error
    bad = list(chain)
    bad[19] = chain[19].__class__(header=dataclasses.replace(
        chain[19].header, app_hash=b"\x01" * 32),
        commit=chain[19].commit, validators=chain[19].validators)
    o, _ = assert_same(both({"primary": bad}, main,
                            {"primary": "primary", "trust_height": 30},
                            now_ns=lambda: _now(chain)))
    assert o[0] == "LightClientError" and "chain break" in o[1], o


def test_pruning_like_jax():
    chain = make_light_chain(20, n_vals=4)

    async def main(c):
        await c.initialize()
        return await c.verify_light_block_at_height(20)
    o, r = assert_same(both({"primary": chain}, main,
                            {"primary": "primary", "pruning_size": 5},
                            mode=JL.SEQUENTIAL,
                            now_ns=lambda: _now(chain)))
    assert o == ("ok", chain[19].header.hash())
    assert [int.from_bytes(k[3:], "big") for k, _ in r["store"]] == \
        list(range(16, 21))


# -------------------------------------------------- store, db, rotation

def test_trusted_store_writes_jax_keys_and_bytes():
    chain = make_light_chain(8, n_vals=5, rotate_every=2, seed=b"st")
    js, ts = JL.TrustedStore(), TL.TrustedStore()
    for jb, tb in zip(chain, port_chain(chain)):
        js.save(jb)
        ts.save(tb)
    assert list(ts.db.iterate()) == list(js.db.iterate())
    for s in (js, ts):
        s.prune(3)
    assert list(ts.db.iterate()) == list(js.db.iterate())
    lb = ts.latest()
    assert lb.height == js.latest().height == 8
    assert ts.first().height == js.first().height == 6
    assert lb.header.hash() == chain[7].header.hash()
    assert lb.validators.hash("cpu") == chain[7].validators.hash()
    assert ts.get(2) is None and js.get(2) is None
    # a decoded set builds its caches anew
    assert lb.validators.dense()[0].shape == (5, 32)
    assert lb.validators.address_index() == {
        v.address: i for i, v in enumerate(chain[7].validators.validators)}


def test_memdb_matches_jax():
    j, t = JDB.MemDB(), TDB.MemDB()
    ops = [("set", b"b", b"2"), ("set", b"a", b"1"), ("set", b"c\x00", b""),
           ("delete", b"zz", None), ("set", b"b", b"22"),
           ("batch", {b"d": b"4", b"a": None}, None), ("delete", b"c\x00", None)]
    for op, k, v in ops:
        for db in (j, t):
            if op == "set":
                db.set(k, v)
            elif op == "delete":
                db.delete(k)
            else:
                db.set_batch(k)
        assert list(t.iterate()) == list(j.iterate())
    assert list(t.iterate(b"b", b"d")) == list(j.iterate(b"b", b"d")) == \
        [(b"b", b"22")]
    assert [t.has(k) for k in (b"a", b"b")] == [j.has(k) for k in (b"a", b"b")]
    assert TDB.height_key(b"lb/", 258) == JDB.height_key(b"lb/", 258)


def test_data_dir_lock(tmp_path):
    lock = TDB.DataDirLock(str(tmp_path / "data"))
    with pytest.raises(RuntimeError):
        TDB.DataDirLock(str(tmp_path / "data"))
    lock.release()
    TDB.DataDirLock(str(tmp_path / "data")).release()


def _sets(powers, seed=b"rot"):
    privs = [JPriv.from_secret(seed + b"%d" % i) for i in range(len(powers))]
    jv = JValidatorSet([JValidator(p.pub_key(), pw)
                        for p, pw in zip(privs, powers)])
    tv = TValidatorSet([TValidator(TPub(p.pub_key().bytes()), pw)
                        for p, pw in zip(privs, powers)])
    return privs, jv, tv


def _state(vs):
    return ([(v.address, v.voting_power, v.proposer_priority)
             for v in vs.validators],
            vs.proposer.address if vs.proposer else None)


def test_proposer_sequence_and_change_set_match_jax():
    powers = [1, 3, 7, 7, 12, 40, 1000]
    privs, jv, tv = _sets(powers)
    assert _state(tv) == _state(jv)
    for _ in range(50):
        jv.increment_proposer_priority(1)
        tv.increment_proposer_priority(1)
        assert _state(tv) == _state(jv)
        assert tv.get_proposer().address == jv.get_proposer().address
    assert _state(tv.copy_increment_proposer_priority(3)) == \
        _state(jv.copy_increment_proposer_priority(3))
    new = JPriv.from_secret(b"new-validator").pub_key()
    j_changes = [JValidator(privs[0].pub_key(), 0),
                 JValidator(privs[4].pub_key(), 5),
                 JValidator(new, 300)]
    t_changes = [TValidator(TPub(c.pub_key.bytes()), c.voting_power)
                 for c in j_changes]
    jv.update_with_change_set(j_changes)
    tv.update_with_change_set(t_changes)
    assert _state(tv) == _state(jv)
    assert tv.validate_basic() == jv.validate_basic()
    assert tv.hash("cpu") == jv.hash()
    assert tv.dense()[0].shape == (7, 32)
    for _ in range(5):
        jv.increment_proposer_priority(2)
        tv.increment_proposer_priority(2)
        assert _state(tv) == _state(jv)
    for bad in ([TValidator(TPub(new.bytes()), 1)] * 2,
                [TValidator(TPub(privs[0].pub_key().bytes()), 0)],
                [TValidator(TPub(new.bytes()), -1)]):
        with pytest.raises(ValueError):
            tv.copy().update_with_change_set(bad)


# ------------------------------------------------ votes, evidence hashes

def _bid(pkg_bid, pkg_psh, tag):
    return pkg_bid(bytes([tag]) * 32, pkg_psh(2, bytes([tag + 1]) * 32))


def _vote_pair(pkg, bid, psh, priv, tag, **over):
    f = dict(type=pkg.PRECOMMIT_TYPE, height=7, round=2,
             block_id=_bid(bid, psh, tag), timestamp_ns=-1_500_000_001,
             validator_address=priv.pub_key().address(), validator_index=3)
    f.update(over)
    return pkg.Vote(**f)


def test_vote_and_proposal_match_jax():
    priv = JPriv.from_secret(b"voter")
    tpub = TPub(priv.pub_key().bytes())
    for over in ({}, {"type": JVote.PREVOTE_TYPE, "round": 0},
                 {"timestamp_ns": 0}, {"timestamp_ns": 3 * 10**9},
                 {"height": 2**63 - 1}):
        jv = _vote_pair(JVote, JBlockID, JPSH, priv, 9, **over)
        tv = _vote_pair(TVote, TBlockID, TPSH, priv, 9, **over)
        for chain_id in ("", "c" * 50):
            assert tv.sign_bytes(chain_id) == jv.sign_bytes(chain_id)
            assert tv.sign_bytes_for(chain_id, "bls12_381") == \
                jv.sign_bytes_for(chain_id, "bls12_381")
            assert tv.extension_sign_bytes(chain_id) == \
                jv.extension_sign_bytes(chain_id)
        sig = priv.sign(jv.sign_bytes(CHAIN))
        jv.signature = tv.signature = sig
        assert tv.encode() == jv.encode()
        assert tv.verify(CHAIN, tpub) and jv.verify(CHAIN, priv.pub_key())
        assert tv.validate_basic() == jv.validate_basic() is None
        tv2 = tv.copy()
        tv2.timestamp_ns += 1
        assert not tv2.verify(CHAIN, tpub)
        assert tv.verify(CHAIN, tpub)         # the memo follows the edit
    for over in ({"height": 0}, {"round": -1}, {"validator_index": -1},
                 {"validator_address": b"\x01" * 19}, {"type": 5}):
        jv = _vote_pair(JVote, JBlockID, JPSH, priv, 9, signature=b"s",
                        **over)
        tv = _vote_pair(TVote, TBlockID, TPSH, priv, 9, signature=b"s",
                        **over)
        assert tv.validate_basic() == jv.validate_basic() is not None
    for pol, rnd in ((-1, 0), (0, 1), (1, 1)):
        jp = JVote.Proposal(5, rnd, pol, _bid(JBlockID, JPSH, 4), 10**9 + 7,
                            b"\x02" * 64)
        tp = TVote.Proposal(5, rnd, pol, _bid(TBlockID, TPSH, 4), 10**9 + 7,
                            b"\x02" * 64)
        assert tp.sign_bytes(CHAIN) == jp.sign_bytes(CHAIN)
        assert tp.validate_basic() == jp.validate_basic()
        tp.signature = priv.sign(tp.sign_bytes(CHAIN))
        assert tp.verify(CHAIN, tpub)


def test_evidence_hashes_match_jax():
    priv = JPriv.from_secret(b"equivocator")
    _, jset, tset = _sets([5, 9, 11])
    jset = JValidatorSet([*jset.validators, JValidator(priv.pub_key(), 4)])
    tset = TValidatorSet([*tset.validators,
                          TValidator(TPub(priv.pub_key().bytes()), 4)])
    jvs = [_vote_pair(JVote, JBlockID, JPSH, priv, t, signature=b"\x07" * 64)
           for t in (30, 10)]
    tvs = [_vote_pair(TVote, TBlockID, TPSH, priv, t, signature=b"\x07" * 64)
           for t in (30, 10)]
    jd = JEv.DuplicateVoteEvidence.from_votes(*jvs, 123, jset)
    td = TEv.DuplicateVoteEvidence.from_votes(*tvs, 123, tset)
    assert td.encode() == jd.encode() and td.hash() == jd.hash()
    assert td.validate_basic() == jd.validate_basic() is None
    assert td.height() == 7 and td.abci_kind() == jd.abci_kind()
    chain = make_light_chain(3, n_vals=4)
    tlb = port_block(chain[2])
    jl = JEv.LightClientAttackEvidence(chain[2].header.hash(), 3, 2, [], 40,
                                       99, chain[2])
    tl = TEv.LightClientAttackEvidence(tlb.header.hash(), 3, 2, [], 40, 99,
                                       tlb)
    assert tl.hash() == jl.hash()
    assert tl.validate_basic() == jl.validate_basic() is None
    for n in (0, 1, 2, 5):
        je, te = [jd, jl] * n, [td, tl] * n
        assert TEv.evidence_list_hash(te, device="cpu") == \
            JEv.evidence_list_hash(je)
    with pytest.raises(TEv.EvidenceError):
        TEv.DuplicateVoteEvidence.from_votes(tvs[0], None, 1, tset)


# ------------------------------------------------------ LocalNodeProvider

class _Block:
    def __init__(self, header):
        self.header = header


class _BlockStore:
    """A node's block store as ``LocalNodeProvider`` reads it: the tip has
    no stored commit yet, only the seen commit."""

    def __init__(self, chain):
        self.chain = chain

    def height(self):
        return len(self.chain)

    def load_block(self, h):
        return _Block(self.chain[h - 1].header) if 1 <= h <= len(
            self.chain) else None

    def load_block_commit(self, h):
        return self.chain[h - 1].commit if 1 <= h < len(self.chain) \
            else None

    def load_seen_commit(self):
        return self.chain[-1].commit


class _StateStore:
    def __init__(self, chain):
        self.chain = chain

    def load_validators(self, h):
        return self.chain[h - 1].validators if 1 <= h <= len(
            self.chain) else None


class _Pool:
    def __init__(self, fail):
        self.fail, self.added = fail, []

    def add_evidence(self, ev):
        if self.fail:
            raise ValueError("pool refuses")
        self.added.append(ev)


@pytest.mark.parametrize("fail", [False, True])
def test_local_node_provider_with_stub_stores(fail):
    chain = port_chain(make_light_chain(4, n_vals=4))
    jchain = make_light_chain(4, n_vals=4)
    out = []
    for pkg, c in ((JL, jchain), (TL, chain)):
        pool = _Pool(fail)
        prov = pkg.LocalNodeProvider(_BlockStore(c), _StateStore(c),
                                     name="node", evidence_pool=pool)
        tip = run(prov.light_block(0))
        mid = run(prov.light_block(2))
        assert tip.commit is c[-1].commit and tip.height == 4
        assert mid.validators is c[1].validators
        with pytest.raises(pkg.ErrLightBlockNotFound) as e:
            run(prov.light_block(9))
        ev = object()
        run(prov.report_evidence(ev))
        assert prov.received_evidence == [ev]
        assert pool.added == ([] if fail else [ev])
        out.append((prov.id(), tip.header.hash(), mid.header.hash(),
                    str(e.value)))
    assert out[1] == out[0]
    assert TL.Provider.id(TProv(chain)) == "ChainProvider"
