"""The port's native sign-bytes encoder (``csrc/host/vote_sign_bytes.cpp``
through ``native.build_vote_sign_bytes``) against the JAX package's
encoder (``cometbft_tpu/crypto/_native_ed25519.build_vote_sign_bytes``)
and against ``Commit.vote_sign_bytes`` lane by lane, and the commit
rules over its rows against the JAX package's.

Cases: commit, nil and absent flags; negative, zero, whole-second and
sub-second timestamps at the varint edges; empty and 50-byte chain ids;
heights up to 2^63 - 1; random fields (hypothesis).  Rows and lengths
must be equal byte for byte; a verification must end the same way in
both packages.  An encoder that does not build raises; nothing falls back
to a per-lane loop."""

import copy
from fractions import Fraction

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from cometbft_tpu.crypto import _native_ed25519 as JN
from cometbft_tpu.crypto.keys import Ed25519PrivKey as JPriv
from cometbft_tpu.testing import make_light_chain
from cometbft_tpu.types import validation as JV
from cometbft_tpu.types.block_id import BlockID as JBlockID
from cometbft_tpu.types.block_id import PartSetHeader as JPSH
from cometbft_tpu.types.canonical import canonical_vote_sign_bytes
from cometbft_tpu.types.commit import Commit as JCommit
from cometbft_tpu.types.commit import CommitSig as JCommitSig
from cometbft_tpu_torch import convert, native
from cometbft_tpu_torch.ops import sha512 as tsha
from cometbft_tpu_torch.types import validation as TV
from cometbft_tpu_torch.types.block_id import BlockID as TBlockID
from cometbft_tpu_torch.types.block_id import PartSetHeader as TPSH
from cometbft_tpu_torch.types.commit import Commit as TCommit
from cometbft_tpu_torch.types.commit import CommitSig as TCommitSig

# the plain versions run on tensors of a few lanes: one intra-op thread is
# as fast, and leaves the cores to the other test workers
torch.set_num_threads(1)

pytestmark = pytest.mark.timeout(900)

PRECOMMIT = 2
TS_EDGES = [0, 1, 127, 128, 999_999_999, 1_000_000_000, 1_000_000_001,
            3 * 10**9, -1, -999_999_999, -10**9, -1_000_000_001,
            -5 * 10**9, 2**62, 2**63 - 1, -2**63,
            1_700_000_000_123_456_789]
CHAIN_IDS = ["", "c" * 50, "light-chain"]
HEIGHTS = [1, 2**31, 2**63 - 1]


def _twins(chain_id, height, round_, flags, tss):
    """The same commit in both packages (signatures empty)."""
    jbid = JBlockID(b"\x11" * 32, JPSH(3, b"\x22" * 32))
    tbid = TBlockID(b"\x11" * 32, TPSH(3, b"\x22" * 32))
    addr = [b"" if f == 1 else bytes([i % 251]) * 20
            for i, f in enumerate(flags)]
    jc = JCommit(height, round_, jbid, [JCommitSig(f, a, t, b"")
                                         for f, a, t in zip(flags, addr, tss)])
    tc = TCommit(height, round_, tbid, [TCommitSig(f, a, t, b"")
                                         for f, a, t in zip(flags, addr, tss)])
    return jc, tc


def _rows_agree(chain_id, jc, tc, flags, tss):
    ts = np.array(tss, np.int64)
    fl = np.array(flags, np.uint8)
    tmpl = tc.sign_bytes_templates(chain_id)
    assert tmpl == jc.sign_bytes_templates(chain_id)
    msgs, lens = native.build_vote_sign_bytes(*tmpl, ts, fl)
    jmsgs, jlens = JN.build_vote_sign_bytes(*tmpl, ts, fl)
    assert msgs.dtype == np.uint8 and lens.dtype == np.int64
    assert msgs.shape == jmsgs.shape == (
        len(tss), 5 + max(len(tmpl[0]), len(tmpl[1])) + 19 + len(tmpl[2]))
    assert np.array_equal(msgs, jmsgs) and np.array_equal(lens, jlens)
    for i in range(len(tss)):
        want = tc.vote_sign_bytes(chain_id, i)
        assert want == jc.vote_sign_bytes(chain_id, i)
        assert bytes(msgs[i, :lens[i]]) == want
        assert not msgs[i, lens[i]:].any()
    scope = np.arange(len(tss))[::2]
    m2, l2 = TV._dense_build_rows(chain_id, tc, ts, fl, scope)
    assert np.array_equal(m2, msgs[scope]) and np.array_equal(l2, lens[scope])


@pytest.mark.parametrize("chain_id", CHAIN_IDS, ids=len)
@pytest.mark.parametrize("height", HEIGHTS)
@pytest.mark.parametrize("round_", [0, 7])
def test_rows_match_jax_encoder_and_canonical(chain_id, height, round_):
    tss = TS_EDGES * 3
    flags = ([2, 3, 1] * len(tss))[:len(tss)]
    jc, tc = _twins(chain_id, height, round_, flags, tss)
    _rows_agree(chain_id, jc, tc, flags, tss)


def test_canonical_encoder_agrees_at_the_edges():
    bid = TBlockID(b"\x11" * 32, TPSH(3, b"\x22" * 32))
    jbid = JBlockID(b"\x11" * 32, JPSH(3, b"\x22" * 32))
    for ts in TS_EDGES:
        _, tc = _twins("x", 5, 1, [2, 3], [ts, ts])
        assert tc.vote_sign_bytes("x", 0) == canonical_vote_sign_bytes(
            "x", PRECOMMIT, 5, 1, jbid, ts)
        assert tc.vote_sign_bytes("x", 1) == canonical_vote_sign_bytes(
            "x", PRECOMMIT, 5, 1, JBlockID(), ts)
    assert bid == tc.block_id


def test_empty_and_mismatched_columns():
    tmpl = _twins("x", 1, 0, [2], [0])[1].sign_bytes_templates("x")
    msgs, lens = native.build_vote_sign_bytes(
        *tmpl, np.zeros(0, np.int64), np.zeros(0, np.uint8))
    assert msgs.shape[0] == 0 and lens.shape == (0,)
    with pytest.raises(ValueError):
        native.build_vote_sign_bytes(*tmpl, np.zeros(2, np.int64),
                                     np.zeros(3, np.uint8))


@settings(max_examples=60, deadline=None)
@given(chain_id=st.text(max_size=60),
       height=st.integers(min_value=0, max_value=2**63 - 1),
       round_=st.integers(min_value=0, max_value=2**31 - 1),
       lanes=st.lists(st.tuples(st.sampled_from([1, 2, 3]),
                                st.integers(min_value=-2**63,
                                            max_value=2**63 - 1)),
                      min_size=1, max_size=12))
def test_rows_match_on_random_fields(chain_id, height, round_, lanes):
    flags = [f for f, _ in lanes]
    tss = [t for _, t in lanes]
    jc, tc = _twins(chain_id, height, round_, flags, tss)
    _rows_agree(chain_id, jc, tc, flags, tss)


# ------------------------------------------------- the commit rules over it

SEED = b"rows"


def _signed_chain(n_vals, chain_id):
    lb = make_light_chain(1, n_vals=n_vals, seed=SEED, chain_id=chain_id)[0]
    privs = {JPriv.from_secret(SEED + b"%d" % i).pub_key().address():
             JPriv.from_secret(SEED + b"%d" % i) for i in range(n_vals)}
    return lb, privs


def _resign(commit, privs, chain_id, lanes):
    """Set lanes {i: (flag, timestamp)} and sign each over its bytes."""
    for i, (flag, ts) in lanes.items():
        cs = commit.signatures[i]
        cs.block_id_flag = flag
        cs.timestamp_ns = ts
        if flag == 1:
            cs.validator_address = b""
            cs.signature = b""
            continue
        bid = commit.block_id if flag == 2 else JBlockID()
        cs.signature = privs[cs.validator_address].sign(
            canonical_vote_sign_bytes(chain_id, PRECOMMIT, commit.height,
                                      commit.round, bid, ts))
    commit.__dict__.pop("_sb_encoders", None)
    commit.__dict__.pop("_dense_cols", None)


def _port(vals, commit):
    pubs, powers = vals.dense()
    n = commit.size()
    sigs = np.zeros((n, 64), np.uint8)
    for i, cs in enumerate(commit.signatures):
        sigs[i, :len(cs.signature)] = np.frombuffer(cs.signature, np.uint8)
    bid = commit.block_id
    return (convert.validator_set_from_arrays(pubs, powers),
            convert.commit_from_arrays(
                commit.height, commit.round, bid.hash,
                bid.part_set_header.total, bid.part_set_header.hash,
                [cs.block_id_flag for cs in commit.signatures],
                [cs.timestamp_ns for cs in commit.signatures],
                [cs.validator_address for cs in commit.signatures], sigs,
                sig_lens=[len(cs.signature) for cs in commit.signatures]))


def _outcome(fn, *args, **kw):
    try:
        fn(*args, **kw)
        return None
    except Exception as e:
        cause = getattr(e, "cause", None)
        return (type(e).__name__, getattr(e, "idx", None),
                getattr(e, "item", None),
                None if cause is None else type(cause).__name__,
                getattr(cause, "idx", None))


def _all_rules(chain_id, jvals, jc, tvals, tc):
    out = []
    for name in ("VerifyCommit", "VerifyCommitLight",
                 "VerifyCommitLightAllSignatures"):
        out.append((
            _outcome(getattr(JV, name), chain_id, jvals, jc.block_id,
                     jc.height, jc, backend="cpu"),
            _outcome(getattr(TV, name), chain_id, tvals, tc.block_id,
                     tc.height, tc, device="cpu")))
    for name in ("VerifyCommitLightTrusting",
                 "VerifyCommitLightTrustingAllSignatures"):
        out.append((
            _outcome(getattr(JV, name), chain_id, jvals, jc,
                     Fraction(1, 3), backend="cpu"),
            _outcome(getattr(TV, name), chain_id, tvals, tc,
                     Fraction(1, 3), device="cpu")))
    out.append((
        _outcome(JV.verify_commits_light_batched, chain_id, jvals,
                 [(jc.block_id, jc.height, jc)] * 2, backend="cpu"),
        _outcome(TV.verify_commits_light_batched, chain_id, tvals,
                 [(tc.block_id, tc.height, tc)] * 2, device="cpu")))
    return out


@pytest.mark.parametrize("chain_id", ["", "c" * 50], ids=len)
def test_commit_rules_over_mixed_lanes_match_jax(chain_id):
    lb, privs = _signed_chain(10, chain_id)
    c = copy.deepcopy(lb.commit)
    _resign(c, privs, chain_id, {0: (3, -1), 1: (2, 0), 2: (1, 0),
                                 3: (2, -3 * 10**9), 4: (3, 10**9),
                                 5: (2, 2**62 + 5)})
    tvals, tc = _port(lb.validators, c)
    res = _all_rules(chain_id, lb.validators, c, tvals, tc)
    for j, t in res:
        assert t == j
    assert res[0][0] is None                 # 8 of 10 lanes for the block
    # a bad signature on a nil lane (VerifyCommit checks nil lanes)
    bad = copy.deepcopy(c)
    sig = bytearray(bad.signatures[4].signature)
    sig[3] ^= 4
    bad.signatures[4].signature = bytes(sig)
    tvals, tc = _port(lb.validators, bad)
    res = _all_rules(chain_id, lb.validators, bad, tvals, tc)
    for j, t in res:
        assert t == j
    assert res[0][0] == ("ErrInvalidSignature", 4, None, None, None)


def test_all_nil_commit_with_a_stride_wider_than_its_blocks(monkeypatch):
    """Every lane a nil vote, short chain id: the rows' stride (sized for
    the commit prefix) is wider than one SHA-512 block while every
    lane's bytes fit in one.  The block count comes from the lengths, so
    the kernels see one block a lane, and the commit fails on power, as
    in the JAX package."""
    chain_id = "n"
    lb, privs = _signed_chain(6, chain_id)
    c = copy.deepcopy(lb.commit)
    _resign(c, privs, chain_id, {i: (3, 7 + i) for i in range(6)})
    tvals, tc = _port(lb.validators, c)
    ts_col = np.array([cs.timestamp_ns for cs in tc.signatures], np.int64)
    fl_col = np.full(6, 3, np.uint8)
    msgs, lens = TV._dense_build_rows(chain_id, tc, ts_col, fl_col,
                                      np.arange(6))
    assert 64 + msgs.shape[1] > 128 and 64 + int(lens.max()) + 17 <= 128
    seen = []
    real = tsha.host_pad

    def spy(m, ln, nb):
        seen.append((m.shape, nb))
        return real(m, ln, nb)
    monkeypatch.setattr(tsha, "host_pad", spy)
    j = _outcome(JV.VerifyCommit, chain_id, lb.validators, c.block_id, 1, c,
                 backend="cpu")
    t = _outcome(TV.VerifyCommit, chain_id, tvals, tc.block_id, 1, tc,
                 device="cpu")
    assert t == j == ("ErrNotEnoughVotingPower", None, None, None, None)
    assert seen == [((6, 64 + msgs.shape[1]), 1)]


def test_block_count_follows_lengths_not_stride():
    """The SHA-512 block count of a lane set is that of the longest
    lane's bytes, whatever the rows' stride."""
    for chain_id in ("", "c" * 50, "x" * 200):
        lb, _ = _signed_chain(4, chain_id)
        tvals, tc = _port(lb.validators, lb.commit)
        fl, ts, _, _ = tc.dense_columns()
        msgs, lens = TV._dense_build_rows(chain_id, tc, ts, fl,
                                          np.arange(4))
        per_lane = max(len(tc.vote_sign_bytes(chain_id, i))
                       for i in range(4))
        nb = tsha.max_blocks_for_len(64 + int(lens.max()))
        assert nb == tsha.max_blocks_for_len(64 + per_lane)
        hin = np.zeros((4, 64 + msgs.shape[1]), np.uint8)
        hin[:, 64:] = msgs
        blocks, active = tsha.host_pad(hin, 64 + lens, nb)
        assert blocks.shape == (4, nb, 32)
        loose = np.zeros((4, 64 + per_lane), np.uint8)
        for i in range(4):
            loose[i, 64:64 + lens[i]] = msgs[i, :lens[i]]
        b2, a2 = tsha.host_pad(loose, 64 + lens, nb)
        assert np.array_equal(blocks, b2) and np.array_equal(active, a2)


def test_failed_build_raises_and_nothing_falls_back(monkeypatch):
    lb, _ = _signed_chain(4, "light-chain")
    tvals, tc = _port(lb.validators, lb.commit)
    monkeypatch.setattr(native, "_VSB", [])
    monkeypatch.setattr(native, "_LIBS", {})
    monkeypatch.setattr(native, "FLAGS",
                        native.FLAGS + ["-fno-such-flag-for-this-test"])
    for fn, args in ((TV.VerifyCommit, (tc.block_id, 1, tc)),
                     (TV.VerifyCommitLight, (tc.block_id, 1, tc)),
                     (TV.VerifyCommitLightTrusting, (tc,)),
                     (TV.verify_commits_light_batched,
                      ([(tc.block_id, 1, tc)],))):
        with pytest.raises(native.NativeBuildError):
            fn("light-chain", tvals, *args, device="cpu")
