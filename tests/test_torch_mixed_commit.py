"""Mixed-key commits (Ed25519 and secp256k1 validators, BASELINE
configs[4]'s key mix) through the port against the JAX package, on the
CPU, at 40 validators with every tenth secp256k1 (10%).

Keys come from numpy-seeded secrets; commits carry commit, nil and
absent lanes at seeded positions and powers.  Held exactly:

- the commit rules (``VerifyCommit``, ``VerifyCommitLight``,
  ``VerifyCommitLightAllSignatures``, ``VerifyCommitLightTrusting`` and
  its ``AllSignatures`` variant, ``verify_commits_light_batched``) and
  the light verifier above them (``verify_adjacent``,
  ``verify_non_adjacent``, ``verify``, ``verify_sequential_batched``):
  the outcome, exception class and lane (or item) index, on clean
  commits and with a bad Ed25519 lane, a bad secp256k1 lane, both, and
  too little power;
- ``ValidatorSet.hash`` and the codec bytes of mixed sets (40 and 100
  validators: the recursive tree and the host level route);
- ``BatchVerifier`` per-lane verdicts against the JAX
  ``TpuBatchVerifier``'s (its Ed25519 lanes on its host route:
  ``MIN_DEVICE_LANES`` is raised, since its XLA compile of the verify
  kernel takes minutes on this CPU; its routing and demux are the same),
  and a mixed micro-batch of the verification scheduler demuxed to the
  right futures.

The port runs on ``device="cpu"`` (the kernels' plain versions); the
pure-Python Ed25519 oracle is patched to raise, so no Ed25519 lane is
verified on the host."""

import asyncio
import copy
from fractions import Fraction

import numpy as np
import pytest
import torch

from cometbft_tpu.crypto import batch as JB
from cometbft_tpu.crypto import scheduler as jsched
from cometbft_tpu.crypto.keys import Ed25519PrivKey as JEdPriv
from cometbft_tpu.crypto.secp256k1 import Secp256k1PrivKey as JSecpPriv
from cometbft_tpu.light import verifier as JLV
from cometbft_tpu.light.types import LightBlock as JLightBlock
from cometbft_tpu.types import codec as JCodec
from cometbft_tpu.types import commit as JC
from cometbft_tpu.types import validation as JV
from cometbft_tpu.types.block_id import BlockID as JBlockID
from cometbft_tpu.types.block_id import PartSetHeader as JPSH
from cometbft_tpu.types.canonical import canonical_vote_sign_bytes
from cometbft_tpu.types.header import Header as JHeader
from cometbft_tpu.types.validator_set import Validator as JValidator
from cometbft_tpu.types.validator_set import ValidatorSet as JValidatorSet
from cometbft_tpu.types.vote import PRECOMMIT_TYPE
from cometbft_tpu_torch.crypto import _ed25519_py as ref
from cometbft_tpu_torch.crypto import batch as TB
from cometbft_tpu_torch.crypto import keys as tkeys
from cometbft_tpu_torch.crypto import scheduler as vsched
from cometbft_tpu_torch.light import verifier as TLV
from cometbft_tpu_torch.types import codec as TCodec
from cometbft_tpu_torch.types import validation as TV

from test_torch_aggregate import port_block, port_commit, port_vals

torch.set_num_threads(1)

pytestmark = pytest.mark.timeout(300)

CHAIN = "mixed-chain"
PERIOD = 14 * 24 * 3600 * 10**9
N_VALS = 40
SECP_EVERY = 10                    # validator i is secp256k1 when i % 10 == 0
A, C, N = JC.BLOCK_ID_FLAG_ABSENT, JC.BLOCK_ID_FLAG_COMMIT, \
    JC.BLOCK_ID_FLAG_NIL
BID = JBlockID(bytes(range(32)), JPSH(1, b"\x5a" * 32))


@pytest.fixture(autouse=True)
def no_host_ed25519(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("host Ed25519 oracle called")

    monkeypatch.setattr(ref, "verify_zip215", refuse)
    vsched.set_scheduler(None)
    jsched.set_scheduler(None)
    yield
    vsched.set_scheduler(None)
    jsched.set_scheduler(None)


def make_set(seed: int, n: int = N_VALS):
    """A JAX mixed validator set at seeded powers and its keys by
    address."""
    rng = np.random.default_rng(seed)
    secrets = [rng.integers(0, 256, 32, np.uint8).tobytes()
               for _ in range(n)]
    privs = [JSecpPriv.from_secret(s) if i % SECP_EVERY == 0
             else JEdPriv.from_secret(s) for i, s in enumerate(secrets)]
    powers = rng.integers(1, 50, n)
    vals = JValidatorSet([JValidator(p.pub_key(), int(pw))
                          for p, pw in zip(privs, powers)])
    return vals, {p.pub_key().address(): p for p in privs}


def sign_commit(vals, by_addr, flags, height=5, bid=BID):
    sigs = []
    for lane, (v, f) in enumerate(zip(vals.validators, flags)):
        if f == A:
            sigs.append(JC.CommitSig())
            continue
        ts = 1_700_000_000_000_000_000 + 1000 * lane
        sb = canonical_vote_sign_bytes(CHAIN, PRECOMMIT_TYPE, height, 0,
                                       bid if f == C else JBlockID(), ts)
        sigs.append(JC.CommitSig(f, v.address, ts, by_addr[v.address]
                                 .sign(sb)))
    return JC.Commit(height, 0, bid, sigs)


def seeded_flags(seed: int, n: int = N_VALS, absent=0.05, nil=0.1):
    u = np.random.default_rng(seed).random(n)
    return [A if x < absent else N if x < absent + nil else C for x in u]


def lanes_of(vals, kind):
    return [i for i, v in enumerate(vals.validators)
            if v.pub_key.type() == kind]


def tamper(commit, lane):
    c = copy.deepcopy(commit)
    sig = bytearray(c.signatures[lane].signature)
    sig[40] ^= 1
    c.signatures[lane].signature = bytes(sig)
    return c


def outcome(fn, *args, **kw):
    try:
        fn(*args, **kw)
        return None
    except Exception as e:
        cause = getattr(e, "cause", None)
        return (type(e).__name__, getattr(e, "idx", None),
                getattr(e, "item", None),
                None if cause is None else type(cause).__name__,
                getattr(cause, "idx", None))


def all_rules(jvals, jc, tvals, tc):
    out = {}
    for name in ("VerifyCommit", "VerifyCommitLight",
                 "VerifyCommitLightAllSignatures"):
        out[name] = (
            outcome(getattr(JV, name), CHAIN, jvals, jc.block_id,
                    jc.height, jc, backend="cpu"),
            outcome(getattr(TV, name), CHAIN, tvals, tc.block_id,
                    tc.height, tc, device="cpu"))
    for name in ("VerifyCommitLightTrusting",
                 "VerifyCommitLightTrustingAllSignatures"):
        out[name] = (
            outcome(getattr(JV, name), CHAIN, jvals, jc, Fraction(1, 3),
                    backend="cpu"),
            outcome(getattr(TV, name), CHAIN, tvals, tc, Fraction(1, 3),
                    device="cpu"))
    out["verify_commits_light_batched"] = (
        outcome(JV.verify_commits_light_batched, CHAIN, jvals,
                [(jc.block_id, jc.height, jc)] * 2, backend="cpu"),
        outcome(TV.verify_commits_light_batched, CHAIN, tvals,
                [(tc.block_id, tc.height, tc)] * 2, device="cpu"))
    return out


@pytest.fixture(scope="module")
def mixed():
    vals, by_addr = make_set(11)
    flags = seeded_flags(12)
    return vals, by_addr, flags, sign_commit(vals, by_addr, flags)


def test_mixed_set_hash_and_codec_match_jax():
    for seed, n in ((21, N_VALS), (22, 100)):
        jvals, _ = make_set(seed, n)
        tvals = port_vals(jvals)
        assert [v.address for v in tvals.validators] == \
            [v.address for v in jvals.validators]
        assert {v.pub_key.type() for v in tvals.validators} == \
            {"ed25519", "secp256k1"}
        assert tvals.dense() is None
        assert tvals.hash("cpu") == jvals.hash()
        assert TCodec.pack(tvals) == JCodec.pack(jvals)
        again = TCodec.unpack(JCodec.pack(jvals))
        assert [(v.pub_key, v.voting_power) for v in again.validators] == \
            [(v.pub_key, v.voting_power) for v in tvals.validators]


def _case(mixed, which):
    vals, by_addr, flags, commit = mixed
    ed = [i for i in lanes_of(vals, "ed25519") if flags[i] == C]
    sp = [i for i in lanes_of(vals, "secp256k1") if flags[i] == C]
    sp_nil = [i for i in lanes_of(vals, "secp256k1") if flags[i] == N]
    if which == "clean":
        return commit
    if which == "bad_ed25519":
        return tamper(commit, ed[len(ed) // 2])
    if which == "bad_secp256k1":
        return tamper(commit, sp[-1])
    if which == "bad_both":
        return tamper(tamper(commit, ed[-1]), sp[0])
    if which == "bad_secp256k1_first":
        return tamper(commit, sp[0])
    if which == "bad_secp256k1_nil":
        if not sp_nil:
            nil_flags = list(flags)
            nil_flags[sp[0]] = N
            c = sign_commit(vals, by_addr, nil_flags)
            return tamper(c, sp[0])
        return tamper(commit, sp_nil[0])
    if which == "low_power":
        low = [A if i % 3 else f for i, f in enumerate(flags)]
        return sign_commit(vals, by_addr, low)
    raise ValueError(which)


CASES = ("clean", "bad_ed25519", "bad_secp256k1", "bad_both",
         "bad_secp256k1_first", "bad_secp256k1_nil", "low_power")


@pytest.mark.parametrize("which", CASES)
def test_commit_rules_match_jax(mixed, which):
    jvals = mixed[0]
    jc = _case(mixed, which)
    res = all_rules(jvals, jc, port_vals(jvals), port_commit(jc))
    for name, (j, t) in res.items():
        assert t == j, (which, name)
    if which == "clean":
        assert all(j is None for j, _ in res.values())
    if which == "bad_secp256k1_first":
        lane = res["VerifyCommit"][0][1]
        assert res["VerifyCommit"][0][0] == "ErrInvalidSignature"
        assert jvals.validators[lane].pub_key.type() == "secp256k1"


def _mixed_chain(n_blocks=4):
    """A JAX light chain over one mixed set (the shape of
    ``cometbft_tpu.testing.make_light_chain``)."""
    vals, by_addr = make_set(31, 24)
    blocks, prev = [], JBlockID()
    for h in range(1, n_blocks + 1):
        header = JHeader(chain_id=CHAIN, height=h,
                         time_ns=1_700_000_000_000_000_000 + h * 10**9,
                         last_block_id=prev, validators_hash=vals.hash(),
                         next_validators_hash=vals.hash(),
                         proposer_address=vals.validators[0].address)
        bid = JBlockID(header.hash(), JPSH(1, b"\x5a" * 32))
        sigs = []
        for v in vals.validators:
            ts = header.time_ns + 1
            sb = canonical_vote_sign_bytes(CHAIN, PRECOMMIT_TYPE, h, 0, bid,
                                           ts)
            sigs.append(JC.CommitSig(C, v.address, ts,
                                     by_addr[v.address].sign(sb)))
        blocks.append(JLightBlock(header=header,
                                  commit=JC.Commit(h, 0, bid, sigs),
                                  validators=vals.copy()))
        prev = bid
    return blocks


def test_light_verifier_over_a_mixed_chain():
    chain = _mixed_chain()
    pc = [port_block(lb) for lb in chain]
    now = chain[-1].header.time_ns + 10**9
    for jb, tb in zip(chain, pc):
        assert tb.header.hash() == jb.header.hash()
        assert tb.validators.hash("cpu") == jb.validators.hash()
    for name, a, b in (("verify_adjacent", 0, 1),
                       ("verify_non_adjacent", 0, 3), ("verify", 1, 3)):
        j = outcome(getattr(JLV, name), CHAIN, chain[a], chain[b], PERIOD,
                    now, backend="cpu")
        t = outcome(getattr(TLV, name), CHAIN, pc[a], pc[b], PERIOD, now,
                    device="cpu")
        assert j == t == None, name  # noqa: E711
    j = outcome(JLV.verify_sequential_batched, CHAIN, chain[0], chain[1:],
                PERIOD, now, backend="cpu")
    t = outcome(TLV.verify_sequential_batched, CHAIN, pc[0], pc[1:], PERIOD,
                now, device="cpu")
    assert j == t == None  # noqa: E711
    # a bad secp256k1 lane in the third header: both name the same item
    secp = lanes_of(chain[2].validators, "secp256k1")[0]
    bad = JLightBlock(header=chain[2].header,
                      commit=tamper(chain[2].commit, secp),
                      validators=chain[2].validators)
    tbad = port_block(bad)
    for name, a, b in (("verify_adjacent", 1, 2),
                       ("verify_non_adjacent", 0, 2)):
        j = outcome(getattr(JLV, name), CHAIN, chain[a], bad, PERIOD, now,
                    backend="cpu")
        t = outcome(getattr(TLV, name), CHAIN, pc[a], tbad, PERIOD, now,
                    device="cpu")
        assert j == t, name
    j = outcome(JLV.verify_sequential_batched, CHAIN, chain[0],
                [chain[1], bad, chain[3]], PERIOD, now, backend="cpu")
    t = outcome(TLV.verify_sequential_batched, CHAIN, pc[0],
                [pc[1], tbad, pc[3]], PERIOD, now, device="cpu")
    assert j == t and j is not None


def _items(seed: int):
    """(port items, JAX items): mixed lanes, some tampered, some with a
    signature of the wrong length."""
    vals, by_addr = make_set(seed, 30)
    rng = np.random.default_rng(seed + 1)
    secp = lanes_of(vals, "secp256k1")
    tp, jp = [], []
    for i, v in enumerate(vals.validators):
        priv = by_addr[v.address]
        msg = rng.integers(0, 256, int(rng.integers(1, 200)),
                           np.uint8).tobytes()
        sig = priv.sign(msg)
        if i % 7 == 3 or i == secp[0]:
            sig = sig[:9] + bytes([sig[9] ^ 2]) + sig[10:]
        if i % 11 == 5 or i == secp[1]:
            sig = sig[:63]
        tp.append((tkeys.pub_key_from_type_bytes(v.pub_key.type(),
                                                 v.pub_key.bytes()),
                   msg, sig))
        jp.append((v.pub_key, msg, sig))
    return tp, jp


@pytest.mark.parametrize("seed", [41, 42])
def test_batch_verifier_lanes_match_jax(seed, monkeypatch):
    tp, jp = _items(seed)
    monkeypatch.setattr(JB.TpuBatchVerifier, "MIN_DEVICE_LANES", 10**9)
    jbv = JB.TpuBatchVerifier()
    for it in jp:
        jbv.add(*it)
    jok, jlanes = jbv.verify()
    tbv = TB.create_batch_verifier("cpu")
    for it in tp:
        tbv.add(*it)
    before = TB.HOST_LANES["secp256k1"]
    tok, tlanes = tbv.verify()
    assert (tok, tlanes) == (jok, jlanes)
    assert any(tlanes) and not all(tlanes)
    kinds = [p.type() for p, _, _ in tp]
    assert {kinds[i] for i, ok in enumerate(tlanes) if not ok} == \
        {"ed25519", "secp256k1"}
    assert TB.HOST_LANES["secp256k1"] - before == kinds.count("secp256k1")
    # a batch of secp256k1 lanes alone, and of one lane
    secp = [i for i, k in enumerate(kinds) if k == "secp256k1"]
    for pick in (secp, secp[:1]):
        tbv = TB.create_batch_verifier("cpu")
        for i in pick:
            tbv.add(*tp[i])
        ok, lanes = tbv.verify()
        assert lanes == [jlanes[i] for i in pick]
        assert ok == all(jlanes[i] for i in pick)


def test_mixed_scheduler_batch_demuxes(monkeypatch):
    tp, jp = _items(43)
    tp = [it for it in tp if len(it[2]) == 64]
    jp = [it for it in jp if len(it[2]) == 64]

    async def port():
        s = vsched.VerificationScheduler(device="cpu", max_wait_ms=5,
                                         max_lanes=256)
        await s.start()
        try:
            got = await asyncio.gather(*(s.verify(*it) for it in tp))
            return got, s.stats()
        finally:
            await s.stop()

    async def jax():
        s = jsched.VerificationScheduler(backend="cpu", max_wait_ms=5)
        await s.start()
        try:
            return await asyncio.gather(*(s.verify(*it) for it in jp))
        finally:
            await s.stop()

    got, stats = asyncio.run(port())
    want = asyncio.run(jax())
    assert got == want
    assert stats["batches"] >= 1 and stats["lanes_bad"] == want.count(False)
    kinds = [p.type() for p, _, _ in tp]
    assert {kinds[i] for i, ok in enumerate(got) if not ok} == \
        {"ed25519", "secp256k1"}
