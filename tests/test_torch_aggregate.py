"""BLS aggregate commits: the port's commit types and verification against
the JAX package on the same commits.

Commits are made with the JAX package (keys from fixed secrets, every
validator's lane signed, then ``types/commit.aggregate_commit``) and
carried into the port by ``cometbft_tpu_torch.convert`` from bytes and
numpy arrays.  The port runs with ``device="cpu"`` (its plain versions:
the G1 fold, the Ed25519 kernels), the JAX package with
``backend="cpu"``.  Hashes, encodings and bitmaps must be equal bytes;
every verification must end the same way: accepted, or the same error
class with the same message and, for a bad signature, the same lane (for
``ErrBatchItemInvalid`` the same item, height, cause and lane)."""

import copy
import dataclasses
from fractions import Fraction

import numpy as np
import pytest
import torch

from cometbft_tpu.crypto.keys import Ed25519PrivKey as JEdPriv
from cometbft_tpu.light import verifier as JLV
from cometbft_tpu.testing import bls_priv_from_secret, make_light_chain
from cometbft_tpu.types import commit as JC
from cometbft_tpu.types import validation as JV
from cometbft_tpu.types.block_id import BlockID as JBlockID
from cometbft_tpu.types.block_id import PartSetHeader as JPartSetHeader
from cometbft_tpu.types.canonical import canonical_vote_sign_bytes
from cometbft_tpu.types.header import Header as JHeader
from cometbft_tpu.types.validator_set import Validator as JValidator
from cometbft_tpu.types.validator_set import ValidatorSet as JValidatorSet
from cometbft_tpu.types.vote import PRECOMMIT_TYPE
from cometbft_tpu_torch import convert
from cometbft_tpu_torch.crypto import merkle as TM
from cometbft_tpu_torch.light import verifier as TLV
from cometbft_tpu_torch.ops import _build
from cometbft_tpu_torch.types import commit as TC
from cometbft_tpu_torch.types import validation as TV

# the plain versions run on tensors of a few lanes: one intra-op thread is
# as fast, and leaves the cores to the other test workers
torch.set_num_threads(1)

pytestmark = pytest.mark.timeout(900)

CHAIN = "agg-chain"
PERIOD = 14 * 24 * 3600 * 10**9
A, C, N, X = (JC.BLOCK_ID_FLAG_ABSENT, JC.BLOCK_ID_FLAG_COMMIT,
              JC.BLOCK_ID_FLAG_NIL, JC.BLOCK_ID_FLAG_AGGREGATE)


# ----------------------------------------------------------------- fixtures

def make_commit(key_types, flags, powers, seed: bytes, height: int = 5):
    """A JAX validator set and its aggregated commit: lane i of the
    address-sorted set takes ``flags`` of the validator made i-th."""
    privs = [bls_priv_from_secret(seed + b"b%d" % i) if kt == "bls12_381"
             else JEdPriv.from_secret(seed + b"e%d" % i)
             for i, kt in enumerate(key_types)]
    flag_of = {p.pub_key().address(): f for p, f in zip(privs, flags)}
    priv_of = {p.pub_key().address(): p for p in privs}
    vals = JValidatorSet([JValidator(p.pub_key(), pw)
                          for p, pw in zip(privs, powers)])
    bid = JBlockID(bytes(range(32)), JPartSetHeader(1, b"\x5a" * 32))
    sigs = []
    for lane, v in enumerate(vals.validators):
        f, priv = flag_of[v.address], priv_of[v.address]
        if f == A:
            sigs.append(JC.CommitSig())
            continue
        ts = 1_700_000_000_000_000_000 + 1000 * lane
        sign_ts = 0 if priv.type() == "bls12_381" else ts
        sb = canonical_vote_sign_bytes(CHAIN, PRECOMMIT_TYPE, height, 0,
                                       bid if f == C else JBlockID(),
                                       sign_ts)
        sigs.append(JC.CommitSig(f, v.address, ts, priv.sign(sb)))
    raw = JC.Commit(height, 0, bid, sigs)
    return vals, raw, JC.aggregate_commit(raw, vals)


def port_vals(vals):
    vs = vals.validators
    return convert.validator_set_from_arrays(
        [v.pub_key.bytes() for v in vs], [v.voting_power for v in vs],
        [v.pub_key.type() for v in vs])


def commit_args(c):
    sigs = np.zeros((c.size(), 96), np.uint8)
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


def port_commit(c):
    return convert.commit_from_arrays(**commit_args(c))


def _mixed():
    """8 Ed25519 and 8 BLS validators of unequal power: BLS NIL lanes, an
    absent BLS lane and an absent Ed25519 lane."""
    kts = ["ed25519", "bls12_381"] * 8
    flags = [C, C, C, N, C, C, C, C, A, C, C, C, C, N, C, A]
    powers = [10 + 3 * i for i in range(16)]
    return kts, flags, powers


SETS = {
    "bls16": (["bls12_381"] * 16, [C] * 13 + [A, C, C], [10] * 16),
    "bls64": (["bls12_381"] * 64, [A if i % 9 == 4 else C for i in range(64)],
              [5 + i % 7 for i in range(64)]),
    "mixed": _mixed(),
}


@pytest.fixture(scope="module", params=sorted(SETS))
def case(request):
    kts, flags, powers = SETS[request.param]
    vals, raw, agg = make_commit(kts, flags, powers,
                                 request.param.encode())
    assert agg.has_aggregate()
    return request.param, vals, raw, agg


def outcome(fn, *args, **kw):
    try:
        fn(*args, **kw)
        return None
    except Exception as e:              # compare class, message and demux
        cause = getattr(e, "cause", None)
        return (type(e).__name__, str(e), getattr(e, "idx", None),
                getattr(e, "item", None), getattr(e, "height", None),
                type(cause).__name__ if cause is not None else None,
                getattr(cause, "idx", None))


FNS = ("VerifyCommit", "VerifyCommitLight", "VerifyCommitLightAllSignatures")


def both(name, vals, commit):
    j = outcome(getattr(JV, name), CHAIN, vals, commit.block_id,
                commit.height, commit, backend="cpu")
    pc = port_commit(commit)
    t = outcome(getattr(TV, name), CHAIN, port_vals(vals), pc.block_id,
                pc.height, pc, device="cpu")
    return j, t


def both_trusting(vals, commit, level=Fraction(1, 3), count_all=False):
    j = outcome(JV.VerifyCommitLightTrusting, CHAIN, vals, commit, level,
                backend="cpu", count_all=count_all)
    t = outcome(TV.VerifyCommitLightTrusting, CHAIN, port_vals(vals),
                port_commit(commit), level, device="cpu",
                count_all=count_all)
    return j, t


def both_batched(vals, commits):
    j = outcome(JV.verify_commits_light_batched, CHAIN, vals,
                [(c.block_id, c.height, c) for c in commits], backend="cpu")
    pcs = [port_commit(c) for c in commits]
    t = outcome(TV.verify_commits_light_batched, CHAIN, port_vals(vals),
                [(c.block_id, c.height, c) for c in pcs], device="cpu")
    return j, t


# ------------------------------------------------------ bitmaps and shapes

def test_signer_bitmap_and_indices_match_jax():
    rng = np.random.default_rng(17)
    for n in (0, 1, 7, 8, 9, 64, 100):
        for _ in range(4):
            idx = sorted(rng.choice(n, size=int(rng.integers(0, n + 1)),
                                    replace=False).tolist()) if n else []
            bm = TC.signer_bitmap(idx, n)
            assert bm == JC.signer_bitmap(idx, n)
            assert TC.bitmap_indices(bm, n) == JC.bitmap_indices(bm, n) \
                == idx
        for bm in (bytes((n + 7) // 8 + 1), b"\xff" * ((n + 7) // 8)):
            assert TC.bitmap_indices(bm, n) == JC.bitmap_indices(bm, n)
    assert TC.bitmap_indices(b"\x80", 7) is JC.bitmap_indices(b"\x80", 7) \
        is None
    for bad in ([8], [-1]):
        with pytest.raises(ValueError):
            TC.signer_bitmap(bad, 8)
        with pytest.raises(ValueError):
            JC.signer_bitmap(bad, 8)


def _malformed(agg):
    """Shape faults of an aggregate commit, by name."""
    lanes = agg.aggregate_lanes()
    out = {}
    c = copy.deepcopy(agg)
    c.agg_signature = b""
    out["no signature"] = c
    c = copy.deepcopy(agg)
    c.agg_signature = agg.agg_signature[:95]
    out["short signature"] = c
    c = copy.deepcopy(agg)
    for i in lanes:
        c.signatures[i] = JC.CommitSig(C, c.signatures[i].validator_address,
                                       c.signatures[i].timestamp_ns,
                                       b"\x01" * 96)
    out["signature without lanes"] = c
    c = copy.deepcopy(agg)
    c.agg_signers = agg.agg_signers + b"\x00"
    out["bitmap length"] = c
    c = copy.deepcopy(agg)
    absent = next(i for i, cs in enumerate(agg.signatures)
                  if not cs.is_aggregate())
    bm = bytearray(agg.agg_signers)
    bm[absent // 8] |= 1 << (absent % 8)
    c.agg_signers = bytes(bm)
    out["stray bitmap bit"] = c
    c = copy.deepcopy(agg)
    c.signatures[lanes[1]].signature = b"\x02" * 96
    out["lane with a signature"] = c
    return out


def test_commit_shape_hash_and_encoding_match_jax(case):
    name, vals, raw, agg = case
    tc = port_commit(agg)
    assert tc.has_aggregate() and not port_commit(raw).has_aggregate()
    assert tc.aggregate_lanes() == agg.aggregate_lanes()
    assert tc.hash("cpu") == agg.hash()
    assert port_commit(raw).hash("cpu") == raw.hash() != agg.hash()
    assert tc.encode() == agg.encode()
    assert tc.validate_basic() is agg.validate_basic() is None
    assert tc.aggregate_sign_bytes(CHAIN) == agg.aggregate_sign_bytes(CHAIN)
    tv = port_vals(vals)
    assert tv.hash("cpu") == vals.hash()
    assert tv.bls_cohort() == vals.bls_cohort()
    assert tv.has_bls() and tv.dense() is None
    for i, v in enumerate(vals.validators):
        kt = v.pub_key.type()
        assert tc.vote_sign_bytes_for(CHAIN, i, kt) == \
            agg.vote_sign_bytes_for(CHAIN, i, kt)
    for fault, jc in _malformed(agg).items():
        pc = port_commit(jc)
        assert pc._validate_aggregate() == jc._validate_aggregate(), fault
        assert pc.validate_basic() == jc.validate_basic() is not None, fault
        assert pc.hash("cpu") == jc.hash(), fault


def test_aggregate_commit_matches_jax(case):
    _, vals, raw, agg = case
    folded = TC.aggregate_commit(port_commit(raw), port_vals(vals))
    assert folded.encode() == agg.encode()
    assert TC.aggregate_commit(folded, port_vals(vals)) is folded


def test_commit_hash_on_the_kernel_route_matches_jax():
    """2,100 lanes plus the aggregate leaf (longer than 118 bytes, so the
    leaves are hashed with hashlib and the levels by ``merkle_tree``)."""
    rng = np.random.default_rng(23)
    n = 2100
    lanes = [JC.CommitSig(X if rng.random() < 0.9 else A,
                          rng.bytes(20), int(rng.integers(0, 1 << 62)), b"")
             for _ in range(n)]
    for cs in lanes:
        if cs.block_id_flag == A:
            cs.validator_address, cs.timestamp_ns = b"", 0
    jc = JC.Commit(9, 1, JBlockID(rng.bytes(32), JPartSetHeader(
        3, rng.bytes(32))), lanes, rng.bytes(96),
        JC.signer_bitmap([i for i, cs in enumerate(lanes)
                          if cs.block_id_flag == X], n))
    assert n + 1 >= TM.MERKLE_KERNEL_MIN_LEAVES
    _build.PLAIN_CALLS.clear()
    assert port_commit(jc).hash("cpu") == jc.hash()
    assert _build.PLAIN_CALLS["merkle_tree"] > 0
    assert port_commit(jc).encode() == jc.encode()


# ------------------------------------------------------------ verification

def test_verify_commit_aggregate_verdicts_match_jax(case):
    """``crypto/blsagg.verify_commit_aggregate`` against the JAX
    package's on the same signers (index list and bool mask), a stray
    signer, no signers and a wrong message; a rebuilt per-set table gets
    a rebuilt device table."""
    from cometbft_tpu.crypto import blsagg as JA
    from cometbft_tpu_torch.crypto import blsagg as TA

    _, vals, _, agg = case
    tv = port_vals(vals)
    lanes = agg.aggregate_lanes()
    mask = np.zeros(vals.size(), bool)
    mask[lanes] = True
    msg = agg.aggregate_sign_bytes(CHAIN)
    other = next(i for i in range(vals.size()) if i not in lanes)
    for signers, m in ((lanes, msg), (mask, msg), (lanes[1:], msg),
                       (lanes + [other], msg), ([], msg),
                       (np.zeros(vals.size(), bool), msg),
                       (lanes, msg + b"x")):
        j = JA.verify_commit_aggregate(vals, signers, m, agg.agg_signature)
        t = TA.verify_commit_aggregate(tv, signers, m, agg.agg_signature,
                                       device="cpu")
        assert j == t
    assert TA.verify_commit_aggregate(tv, mask, msg, agg.agg_signature,
                                      device="cpu")
    first = tv.__dict__["_bls_dev_tbl"]
    assert first[0] is tv.__dict__["_bls_agg_tbl"]
    tv.__dict__.pop("_bls_agg_tbl")
    assert TA.verify_commit_aggregate(tv, lanes, msg, agg.agg_signature,
                                      device="cpu")
    assert tv.__dict__["_bls_dev_tbl"][0] is tv.__dict__["_bls_agg_tbl"] \
        is not first[0]


@pytest.mark.parametrize("fn", FNS)
def test_valid_aggregate_commit(case, fn):
    _, vals, _, agg = case
    j, t = both(fn, vals, agg)
    assert j == t == None  # noqa: E711


def test_valid_aggregate_commit_trusting_and_batched(case):
    name, vals, _, agg = case
    assert both_trusting(vals, agg) == (None, None)
    assert both_trusting(vals, agg, count_all=True) == (None, None)
    j, t = both_trusting(vals, agg, Fraction(1, 1), count_all=True)
    assert j == t
    other = make_commit(*SETS[name], name.encode(), height=6)[2]
    j, t = both_batched(vals, [agg, other])
    assert j == t == None  # noqa: E711


def test_trusting_set_missing_one_signer(case):
    """The aggregate cannot be attributed in a set that lacks one signer:
    it contributes no power, and the other lanes decide."""
    _, vals, _, agg = case
    gone = agg.aggregate_lanes()[2]
    trusted = JValidatorSet([v.copy() for i, v in enumerate(vals.validators)
                             if i != gone])
    for level in (Fraction(1, 3), Fraction(1, 10)):
        j, t = both_trusting(trusted, agg, level)
        assert j == t


def _with_bitmap(c, lanes):
    c.agg_signers = JC.signer_bitmap(lanes, c.size())
    return c


def _faults(vals, agg):
    lanes = agg.aggregate_lanes()
    out = {}
    c = copy.deepcopy(agg)
    other = make_commit(["bls12_381"] * 2, [C, C], [1, 1], b"o")[2]
    c.agg_signature = other.agg_signature
    out["wrong aggregate"] = c
    c = copy.deepcopy(agg)
    stray = next(i for i, cs in enumerate(agg.signatures)
                 if not cs.is_aggregate())
    bm = bytearray(agg.agg_signers)
    bm[stray // 8] |= 1 << (stray % 8)
    c.agg_signers = bytes(bm)
    out["stray bitmap bit"] = c
    c = copy.deepcopy(agg)
    c.signatures[lanes[3]].validator_address = b"\x33" * 20
    out["lane address"] = c
    ed = [i for i, v in enumerate(vals.validators)
          if v.pub_key.type() == "ed25519"
          and agg.signatures[i].block_id_flag == C]
    if ed:
        c = copy.deepcopy(agg)
        cs = c.signatures[ed[0]]
        c.signatures[ed[0]] = JC.CommitSig(X, cs.validator_address,
                                           cs.timestamp_ns, b"")
        out["lane on an Ed25519 validator"] = _with_bitmap(
            c, sorted(lanes + ed[:1]))
    return out


@pytest.mark.parametrize("fn", FNS)
def test_faulty_aggregates_fail_as_in_jax(case, fn):
    _, vals, _, agg = case
    for fault, c in _faults(vals, agg).items():
        j, t = both(fn, vals, c)
        assert j == t, fault
        assert j is not None, fault
    lanes = agg.aggregate_lanes()
    j, _ = both(fn, vals, _faults(vals, agg)["wrong aggregate"])
    assert j[0] == "ErrInvalidSignature" and j[2] == lanes[0]


def test_faulty_aggregates_trusting_and_batched(case):
    name, vals, _, agg = case
    good = make_commit(*SETS[name], name.encode(), height=4)[2]
    later = make_commit(*SETS[name], name.encode(), height=6)[2]
    for fault, c in _faults(vals, agg).items():
        j, t = both_trusting(vals, c)
        assert j == t, fault
    for fault, c in _faults(vals, later).items():
        j, t = both_batched(vals, [good, c])
        assert j == t, fault
        assert j[3:5] == (1, 6), fault


def test_bad_individual_lanes_in_a_mixed_set():
    """A bad Ed25519 lane and a bad BLS NIL lane beside a valid aggregate:
    the first bad lane in commit order is named."""
    vals, _, agg = make_commit(*SETS["mixed"], b"mixed")
    nil = [i for i, cs in enumerate(agg.signatures) if cs.block_id_flag == N]
    ed = [i for i, v in enumerate(vals.validators)
          if v.pub_key.type() == "ed25519"
          and agg.signatures[i].block_id_flag == C]
    for bad in (nil[0], ed[-1], nil[-1]):
        c = copy.deepcopy(agg)
        s = bytearray(c.signatures[bad].signature)
        s[5] ^= 1
        c.signatures[bad].signature = bytes(s)
        for fn in FNS:
            j, t = both(fn, vals, c)
            assert j == t, (bad, fn)
        j, t = both("VerifyCommit", vals, c)
        assert j[0] == "ErrInvalidSignature" and j[2] == bad


# ------------------------------------------------------- light, BLS chains

def _header_args(h):
    f = {x.name: getattr(h, x.name) for x in dataclasses.fields(JHeader)
         if x.name != "last_block_id"}
    b = h.last_block_id
    f["last_block_id"] = (b.hash, b.part_set_header.total,
                          b.part_set_header.hash)
    return f


def port_block(lb):
    vs = lb.validators.validators
    return convert.light_block_from_arrays(
        _header_args(lb.header), [v.pub_key.bytes() for v in vs],
        [v.voting_power for v in vs], commit_args(lb.commit),
        key_types=[v.pub_key.type() for v in vs])


@pytest.mark.parametrize("key_types", ["bls12_381", "mixed"])
def test_light_verification_of_a_bls_chain(key_types):
    kts = "bls12_381" if key_types == "bls12_381" else \
        ["bls12_381", "ed25519", "bls12_381"] * 3
    chain = make_light_chain(4, n_vals=9, chain_id=CHAIN, key_types=kts,
                             seed=b"lcb")
    assert all(lb.commit.has_aggregate() for lb in chain)
    pc = [port_block(lb) for lb in chain]
    now = chain[-1].header.time_ns + 10**9
    for jb, tb in zip(chain, pc):
        assert tb.commit.hash("cpu") == jb.commit.hash()
        assert tb.validate_basic(CHAIN, "cpu") == \
            jb.validate_basic(CHAIN) is None
    runs = [("verify_adjacent", 0, 1), ("verify_non_adjacent", 0, 3),
            ("verify", 1, 3)]
    for name, a, b in runs:
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
    # a wrong aggregate in the third header: both name item 1, height 3
    bad = copy.deepcopy(chain[2])
    bad.commit.agg_signature = chain[1].commit.agg_signature
    tbad = port_block(bad)
    j = outcome(JLV.verify_sequential_batched, CHAIN, chain[0],
                [chain[1], bad, chain[3]], PERIOD, now, backend="cpu")
    t = outcome(TLV.verify_sequential_batched, CHAIN, pc[0],
                [pc[1], tbad, pc[3]], PERIOD, now, device="cpu")
    assert j == t and j is not None
