"""The slice as a whole: commit verification in the port against the JAX
package on the same commits.

Commits come from ``cometbft_tpu.testing.make_light_chain`` at 4 and 150
validators and cross into the port through ``cometbft_tpu_torch.convert``
(numpy arrays only).  The port runs on the CPU (its plain versions); the
JAX package runs with ``backend="cpu"``.  The outcome (accepted, or the
error class) and, for a bad signature, the lane index must be equal.
Mirrors ``tests/test_dense_verify.py``."""

import copy
from fractions import Fraction

import numpy as np
import pytest
import torch

from cometbft_tpu.testing import make_light_chain
from cometbft_tpu.types import validation as JV
from cometbft_tpu.types.commit import (BLOCK_ID_FLAG_ABSENT,
                                       BLOCK_ID_FLAG_NIL)
from cometbft_tpu.types.validator_set import ValidatorSet as JValidatorSet
from cometbft_tpu_torch import convert
from cometbft_tpu_torch.crypto import batch as tbatch
from cometbft_tpu_torch.crypto.keys import Ed25519PrivKey
from cometbft_tpu_torch.types import validation as TV

# the plain versions run on tensors of a few lanes: one intra-op thread is
# as fast, and leaves the cores to the other test workers
torch.set_num_threads(1)

pytestmark = pytest.mark.timeout(900)

CHAIN = "light-chain"


@pytest.fixture(scope="module", params=[4, 150])
def chain(request):
    return make_light_chain(1, n_vals=request.param)[0]


def port_vals(vals):
    pubs, powers = vals.dense()
    return convert.validator_set_from_arrays(pubs, powers)


def port_commit(commit):
    n = commit.size()
    sigs = np.zeros((n, 64), np.uint8)
    for i, cs in enumerate(commit.signatures):
        raw = cs.signature[:64]
        sigs[i, :len(raw)] = np.frombuffer(raw, np.uint8)
    bid = commit.block_id
    return convert.commit_from_arrays(
        commit.height, commit.round, bid.hash, bid.part_set_header.total,
        bid.part_set_header.hash,
        [cs.block_id_flag for cs in commit.signatures],
        [cs.timestamp_ns for cs in commit.signatures],
        [cs.validator_address for cs in commit.signatures], sigs,
        sig_lens=[len(cs.signature) for cs in commit.signatures])


def outcome(fn, *args, **kw):
    try:
        fn(*args, **kw)
        return None, None
    except Exception as e:              # compare the class names
        return type(e).__name__, getattr(e, "idx", None)


PAIRS = {
    "VerifyCommit": (JV.VerifyCommit, TV.VerifyCommit),
    "VerifyCommitLight": (JV.VerifyCommitLight, TV.VerifyCommitLight),
    "VerifyCommitLightAllSignatures": (JV.VerifyCommitLightAllSignatures,
                                       TV.VerifyCommitLightAllSignatures),
}


def both(name, vals, commit, height=None):
    jfn, tfn = PAIRS[name]
    height = commit.height if height is None else height
    pc = port_commit(commit)
    j = outcome(jfn, CHAIN, vals, commit.block_id, height, commit,
                backend="cpu")
    t = outcome(tfn, CHAIN, port_vals(vals), pc.block_id, height, pc,
                device="cpu")
    return j, t


def both_trusting(vals, commit, trust=Fraction(1, 3), all_sigs=False):
    if all_sigs:
        j = outcome(JV.VerifyCommitLightTrustingAllSignatures, CHAIN, vals,
                    commit, trust, backend="cpu")
        t = outcome(TV.VerifyCommitLightTrustingAllSignatures, CHAIN,
                    port_vals(vals), port_commit(commit), trust,
                    device="cpu")
    else:
        j = outcome(JV.VerifyCommitLightTrusting, CHAIN, vals, commit, trust,
                    backend="cpu")
        t = outcome(TV.VerifyCommitLightTrusting, CHAIN, port_vals(vals),
                    port_commit(commit), trust, device="cpu")
    return j, t


def test_conversion_keeps_order_and_sign_bytes(chain):
    vals, commit = chain.validators, chain.commit
    pv, pc = port_vals(vals), port_commit(commit)
    assert [v.address for v in pv.validators] == \
        [v.address for v in vals.validators]
    assert pv.total_voting_power() == vals.total_voting_power()
    for i in (0, commit.size() - 1):
        assert pc.vote_sign_bytes(CHAIN, i) == commit.vote_sign_bytes(CHAIN,
                                                                      i)


@pytest.mark.parametrize("name", list(PAIRS))
def test_valid_commit(chain, name):
    j, t = both(name, chain.validators, chain.commit)
    assert j == t == (None, None)


def test_valid_commit_trusting(chain):
    j, t = both_trusting(chain.validators, chain.commit)
    assert j == t == (None, None)


@pytest.mark.parametrize("name", list(PAIRS))
@pytest.mark.parametrize("where", ["first", "middle", "last"])
def test_bad_signature_lane(chain, name, where):
    c = copy.deepcopy(chain.commit)
    n = c.size()
    bad = {"first": 0, "middle": n // 2, "last": n - 1}[where]
    sig = bytearray(c.signatures[bad].signature)
    sig[9] ^= 0x10
    c.signatures[bad].signature = bytes(sig)
    j, t = both(name, chain.validators, c)
    assert j == t
    if name != "VerifyCommitLight":
        assert t == ("ErrInvalidSignature", bad)


def test_nil_and_absent_lanes(chain):
    c = copy.deepcopy(chain.commit)
    n = c.size()
    for i in (1, n - 2):
        c.signatures[i].block_id_flag = BLOCK_ID_FLAG_NIL
    c.signatures[2 % n].block_id_flag = BLOCK_ID_FLAG_ABSENT
    c.signatures[2 % n].signature = b""
    c.signatures[2 % n].validator_address = b""
    for name in PAIRS:
        j, t = both(name, chain.validators, c)
        assert j == t, name
    # the nil lanes signed the block, not nil: VerifyCommit checks them
    assert both("VerifyCommit", chain.validators, c)[1] == \
        ("ErrInvalidSignature", 1)


def test_not_enough_power(chain):
    c = copy.deepcopy(chain.commit)
    n = c.size()
    for i in range(n // 3, n):
        c.signatures[i].block_id_flag = BLOCK_ID_FLAG_ABSENT
        c.signatures[i].signature = b""
        c.signatures[i].validator_address = b""
    for name in PAIRS:
        j, t = both(name, chain.validators, c)
        assert j == t == ("ErrNotEnoughVotingPower", None), name
    j, t = both_trusting(chain.validators, c, Fraction(2, 3))
    assert j == t == ("ErrNotEnoughVotingPower", None)


def test_light_early_exit_skips_trailing_bad_signature(chain):
    c = copy.deepcopy(chain.commit)
    n = c.size()
    c.signatures[n - 1].signature = bytes(64)
    j, t = both("VerifyCommitLight", chain.validators, c)
    assert j == t == (None, None)
    j, t = both("VerifyCommit", chain.validators, c)
    assert j == t == ("ErrInvalidSignature", n - 1)
    j, t = both_trusting(chain.validators, c)
    assert j == t == (None, None)
    j, t = both_trusting(chain.validators, c, all_sigs=True)
    assert j == t == ("ErrInvalidSignature", n - 1)


def test_wrong_length_signature_is_a_bad_lane(chain):
    c = copy.deepcopy(chain.commit)
    c.signatures[0].signature = c.signatures[0].signature[:63]
    j, t = both("VerifyCommit", chain.validators, c)
    assert j == t == ("ErrInvalidSignature", 0)


def test_commit_basics(chain):
    j, t = both("VerifyCommit", chain.validators, chain.commit,
                height=chain.commit.height + 1)
    assert j == t == ("ErrInvalidCommit", None)


def test_trusting_subset_and_duplicates(chain):
    vals, commit = chain.validators, chain.commit
    n = vals.size()
    if n < 10:
        keep = vals.validators[1:]
    else:
        keep = vals.validators[::2]
    trusted = JValidatorSet([v.copy() for v in keep])
    j, t = both_trusting(trusted, commit)
    assert j == t
    c = copy.deepcopy(commit)
    c.signatures[1].validator_address = c.signatures[0].validator_address
    j, t = both_trusting(vals, c, Fraction(1, 1), all_sigs=True)
    assert j == t == ("ErrInvalidCommit", None)


def test_batch_verifier_object_path():
    privs = [Ed25519PrivKey.from_secret(b"bv%d" % i) for i in range(5)]
    bv = tbatch.create_batch_verifier("cpu")
    msgs = [b"m%d" % i * (i + 1) for i in range(5)]
    for p, m in zip(privs, msgs):
        bv.add(p.pub_key(), m, p.sign(m))
    assert bv.verify() == (True, [True] * 5)
    bv.add(privs[0].pub_key(), b"other", privs[0].sign(b"m0"))
    bv.add(privs[1].pub_key(), b"short", b"\x00" * 10)
    ok, oks = bv.verify()
    assert not ok and oks == [True] * 5 + [False, False]
    assert tbatch.create_batch_verifier("cpu").verify() == (False, [])
