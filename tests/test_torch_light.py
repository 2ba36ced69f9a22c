"""The light-client slice: header hashing and header verification in the
port against the JAX package on the same chains.

Chains come from ``cometbft_tpu.testing.make_light_chain`` (4 to 8
validators, up to 40 headers) and cross into the port through
``cometbft_tpu_torch.convert.light_block_from_arrays`` (numpy arrays and
field values only).  The port runs with ``device="cpu"`` (its plain
versions), the JAX package with ``backend="cpu"``.  Hashes must be
equal byte for byte; a verification must end the same way: accepted, or
the same error class, and for ``ErrBatchItemInvalid`` the same item,
height and bad lane."""

import copy
import dataclasses
from fractions import Fraction

import numpy as np
import pytest
import torch

from cometbft_tpu.crypto.keys import Ed25519PubKey as JPubKey
from cometbft_tpu.light import verifier as JLV
from cometbft_tpu.testing import make_light_chain
from cometbft_tpu.types.block_id import BlockID as JBlockID
from cometbft_tpu.types.block_id import PartSetHeader as JPartSetHeader
from cometbft_tpu.types.commit import Commit as JCommit
from cometbft_tpu.types.commit import CommitSig as JCommitSig
from cometbft_tpu.types.header import Data as JData
from cometbft_tpu.types.header import Header as JHeader
from cometbft_tpu.types.validator_set import Validator as JValidator
from cometbft_tpu.types.validator_set import ValidatorSet as JValidatorSet
from cometbft_tpu_torch import convert
from cometbft_tpu_torch.crypto import merkle as TM
from cometbft_tpu_torch.light import verifier as TLV
from cometbft_tpu_torch.ops import _build
from cometbft_tpu_torch.types.header import Data as TData

# the plain versions run on tensors of a few lanes: one intra-op thread is
# as fast, and leaves the cores to the other test workers
torch.set_num_threads(1)

pytestmark = pytest.mark.timeout(900)

CHAIN = "light-chain"
PERIOD = 14 * 24 * 3600 * 10**9           # trusting period, ns


@pytest.fixture(scope="module")
def chain():
    return make_light_chain(40, n_vals=7)


@pytest.fixture(scope="module")
def rotating():
    """A validator replaced every 2 blocks among 4: long skips lose the
    1/3 overlap."""
    return make_light_chain(30, n_vals=4, rotate_every=2, seed=b"rot")


def commit_args(c):
    n = c.size()
    sigs = np.zeros((n, 64), np.uint8)
    for i, cs in enumerate(c.signatures):
        raw = cs.signature[:64]
        sigs[i, :len(raw)] = np.frombuffer(raw, np.uint8)
    bid = c.block_id
    return dict(height=c.height, round_=c.round, block_hash=bid.hash,
                part_set_total=bid.part_set_header.total,
                part_set_hash=bid.part_set_header.hash,
                flags=[cs.block_id_flag for cs in c.signatures],
                timestamps_ns=[cs.timestamp_ns for cs in c.signatures],
                addresses=[cs.validator_address for cs in c.signatures],
                sigs=sigs, sig_lens=[len(cs.signature)
                                     for cs in c.signatures])


def header_args(h):
    f = {x.name: getattr(h, x.name) for x in dataclasses.fields(JHeader)
         if x.name != "last_block_id"}
    b = h.last_block_id
    f["last_block_id"] = (b.hash, b.part_set_header.total,
                          b.part_set_header.hash)
    return f


def port_block(lb, sets=None):
    """A JAX LightBlock in the port.  ``sets`` shares one port validator
    set per distinct JAX set, as a light client holds it (so the per-set
    device tables are built once)."""
    pubs, powers = lb.validators.dense()
    pb = convert.light_block_from_arrays(header_args(lb.header), pubs,
                                         powers, commit_args(lb.commit))
    if sets is not None:
        pb.validators = sets.setdefault(pubs.tobytes() + powers.tobytes(),
                                        pb.validators)
    return pb


@pytest.fixture(scope="module")
def port_chain(chain):
    sets = {}
    return [port_block(lb, sets) for lb in chain]


def outcome(fn, *args, **kw):
    try:
        fn(*args, **kw)
        return None
    except Exception as e:              # compare the class names and demux
        cause = getattr(e, "cause", None)
        return (type(e).__name__, getattr(e, "item", None),
                getattr(e, "height", None),
                type(cause).__name__ if cause is not None else None,
                getattr(cause, "idx", None))


def both(name, jtrusted, jnew, ttrusted, tnew, now, **kw):
    jfn, tfn = getattr(JLV, name), getattr(TLV, name)
    j = outcome(jfn, CHAIN, jtrusted, jnew, PERIOD, now, backend="cpu", **kw)
    t = outcome(tfn, CHAIN, ttrusted, tnew, PERIOD, now, device="cpu", **kw)
    return j, t


def now_after(chain):
    return chain[-1].header.time_ns + 10**9


# ---------------------------------------------------------------- hashing

def test_header_commit_and_validator_hashes_match_jax(chain, port_chain):
    for jb, tb in zip(chain, port_chain):
        assert tb.header.hash() == jb.header.hash()
        assert tb.header.encode() == jb.header.encode()
        assert tb.header.version_encode() == jb.header.version_encode()
        assert tb.header.validate_basic() == jb.header.validate_basic()
        assert tb.validators.hash("cpu") == jb.validators.hash() == \
            jb.header.validators_hash
        assert tb.commit.hash("cpu") == jb.commit.hash()
        assert tb.commit.validate_basic() == jb.commit.validate_basic() \
            is None
        assert tb.validate_basic(CHAIN, "cpu") == \
            jb.validate_basic(CHAIN) is None
    v = port_chain[3].validators.validators[2]
    jv = chain[3].validators.validators[2]
    assert v.simple_encode() == jv.simple_encode()
    assert port_chain[3].commit.signatures[1].encode() == \
        chain[3].commit.signatures[1].encode()


def test_incomplete_header_hashes_empty(port_chain):
    h = copy.deepcopy(port_chain[0].header)
    h.validators_hash = b""
    assert h.hash() == b""


def test_validate_basic_failures_match_jax(chain, port_chain):
    cases = []
    jb, tb = copy.deepcopy(chain[4]), copy.deepcopy(port_chain[4])
    jb.commit.signatures[2].validator_address = b"\x01" * 19
    tb.commit.signatures[2].validator_address = b"\x01" * 19
    cases.append((jb, tb))
    jb, tb = copy.deepcopy(chain[5]), copy.deepcopy(port_chain[5])
    jb.commit.signatures[0].block_id_flag = 9
    tb.commit.signatures[0].block_id_flag = 9
    cases.append((jb, tb))
    jb, tb = copy.deepcopy(chain[6]), copy.deepcopy(port_chain[6])
    jb.header.proposer_address = b"\x02" * 7
    tb.header.proposer_address = b"\x02" * 7
    cases.append((jb, tb))
    for jb, tb in cases:
        assert tb.validate_basic(CHAIN, "cpu") == jb.validate_basic(CHAIN)
        assert tb.validate_basic(CHAIN, "cpu") is not None
        assert tb.commit.validate_basic() == jb.commit.validate_basic()
        assert tb.header.validate_basic() == jb.header.validate_basic()
    assert port_chain[0].validate_basic("other", "cpu") == \
        chain[0].validate_basic("other")


def _random_set(n, seed):
    rng = np.random.default_rng(seed)
    pubs = np.frombuffer(rng.bytes(32 * n), np.uint8).reshape(n, 32)
    powers = rng.integers(1, 1 << 40, size=n).astype(np.int64)
    jvals = JValidatorSet([JValidator(JPubKey(pubs[i].tobytes()),
                                      int(powers[i])) for i in range(n)])
    return jvals, convert.validator_set_from_arrays(pubs, powers)


def test_large_validator_set_takes_the_kernel_route():
    """2,100 validators: the leaves (one block each) and the 12 levels
    above them (one fused tree call) go through the plain version of the
    kernel on the CPU."""
    jvals, tvals = _random_set(2100, 61)
    _build.reset_launches()
    assert tvals.hash("cpu") == jvals.hash()
    assert dict(_build.PLAIN_CALLS) == {"merkle_tree_leaves": 1}
    with pytest.raises(RuntimeError):         # device=None is CUDA
        tvals.hash()


def test_large_commit_takes_the_kernel_route():
    """2,100 CommitSigs (two blocks each, absent lanes one) through the
    kernel route, against the JAX commit hash."""
    jvals, _ = _random_set(2100, 62)
    rng = np.random.default_rng(63)
    sigs = []
    for i, v in enumerate(jvals.validators):
        if i % 9 == 4:
            sigs.append(JCommitSig.absent())
        else:
            sigs.append(JCommitSig(2 + (i % 7 == 0), v.address,
                                   int(rng.integers(0, 1 << 62)),
                                   rng.bytes(64)))
    jc = JCommit(8, 1, JBlockID(rng.bytes(32), JPartSetHeader(3,
                                                              rng.bytes(32))),
                 sigs)
    tc = convert.commit_from_arrays(**commit_args(jc))
    _build.reset_launches()
    assert tc.hash("cpu") == jc.hash()
    assert _build.PLAIN_CALLS["merkle_tree_leaves"] == 1
    assert tc.validate_basic() == jc.validate_basic() is None


@pytest.mark.parametrize("n_txs", [0, 5, 2100])
def test_data_hash_matches_jax(n_txs):
    rng = np.random.default_rng(64 + n_txs)
    txs = [rng.bytes(int(k)) for k in rng.integers(1, 400, size=n_txs)]
    assert TData(txs).hash("cpu") == JData(txs).hash()


# ------------------------------------------------------------ verification

def test_valid_chain(chain, port_chain):
    now = now_after(chain)
    for name, a, b, kw in [
            ("verify_adjacent", 0, 1, {}),
            ("verify_adjacent", 17, 18, {}),
            ("verify_non_adjacent", 0, 9, {}),
            ("verify_non_adjacent", 3, 4, {}),
            ("verify_non_adjacent", 2, 38,
             {"trust_level": Fraction(2, 3)}),
            ("verify", 0, 1, {}), ("verify", 5, 30, {})]:
        j, t = both(name, chain[a], chain[b], port_chain[a], port_chain[b],
                    now, **kw)
        assert j == t is None, (name, a, b)
    j = outcome(JLV.verify_sequential_batched, CHAIN, chain[0], chain[1:],
                PERIOD, now, backend="cpu")
    _build.reset_launches()
    t = outcome(TLV.verify_sequential_batched, CHAIN, port_chain[0],
                port_chain[1:], PERIOD, now, device="cpu")
    assert j == t is None
    # one validator set: one RLC verdict over the 39 headers' 195 light
    # lanes, and no per-lane pass
    assert _build.PLAIN_CALLS["ed25519_rlc_gather"] == 1
    assert not _build.PLAIN_CALLS["ed25519_verify_gather"]


def test_broken_linkage(chain, port_chain):
    now = now_after(chain)
    j, t = both("verify_adjacent", chain[0], chain[2], port_chain[0],
                port_chain[2], now)
    assert j == t == ("ErrInvalidHeader", None, None, None, None)
    gap = [1, 2, 3, 5, 6]
    j = outcome(JLV.verify_sequential_batched, CHAIN, chain[0],
                [chain[i] for i in gap], PERIOD, now, backend="cpu")
    t = outcome(TLV.verify_sequential_batched, CHAIN, port_chain[0],
                [port_chain[i] for i in gap], PERIOD, now, device="cpu")
    assert j == t == ("ErrInvalidHeader", None, None, None, None)
    # a header whose commit signs another header
    jb, tb = copy.deepcopy(chain[3]), copy.deepcopy(port_chain[3])
    jb.header.app_hash = tb.header.app_hash = b"\x33" * 32
    j, t = both("verify_adjacent", chain[2], jb, port_chain[2], tb, now)
    assert j == t == ("ErrInvalidHeader", None, None, None, None)
    # time going backwards, and from the future
    j, t = both("verify_non_adjacent", chain[9], chain[4], port_chain[9],
                port_chain[4], now)
    assert j == t == ("ErrInvalidHeader", None, None, None, None)
    j, t = both("verify_adjacent", chain[0], chain[1], port_chain[0],
                port_chain[1], chain[1].header.time_ns - 10**11)
    assert j == t == ("ErrInvalidHeader", None, None, None, None)


def test_forged_validator_set(chain, port_chain):
    now = now_after(chain)
    other = make_light_chain(2, n_vals=7, seed=b"forged")[1]
    jb, tb = copy.deepcopy(chain[1]), copy.deepcopy(port_chain[1])
    jb.validators = other.validators
    tb.validators = port_block(other).validators
    for name in ("verify_adjacent", "verify"):
        j, t = both(name, chain[0], jb, port_chain[0], tb, now)
        assert j == t == ("ErrInvalidHeader", None, None, None, None)
    j = outcome(JLV.verify_sequential_batched, CHAIN, chain[0],
                [chain[1], jb], PERIOD, now, backend="cpu")
    t = outcome(TLV.verify_sequential_batched, CHAIN, port_chain[0],
                [port_chain[1], tb], PERIOD, now, device="cpu")
    assert j == t == ("ErrInvalidHeader", None, None, None, None)


def test_expired_trusting_period(chain, port_chain):
    late = chain[0].header.time_ns + PERIOD
    for name, b in (("verify_adjacent", 1), ("verify_non_adjacent", 6)):
        j, t = both(name, chain[0], chain[b], port_chain[0], port_chain[b],
                    late)
        assert j == t == ("LightClientError", None, None, None, None)
    j = outcome(JLV.verify_sequential_batched, CHAIN, chain[0], chain[1:4],
                PERIOD, late, backend="cpu")
    t = outcome(TLV.verify_sequential_batched, CHAIN, port_chain[0],
                port_chain[1:4], PERIOD, late, device="cpu")
    assert j == t == ("LightClientError", None, None, None, None)


def test_rotated_set_cannot_be_trusted(rotating):
    sets = {}
    port = [port_block(lb, sets) for lb in rotating]
    now = now_after(rotating)
    j, t = both("verify_non_adjacent", rotating[0], rotating[24], port[0],
                port[24], now)
    assert j == t == ("ErrNewValSetCantBeTrusted", None, None, None, None)
    j, t = both("verify", rotating[0], rotating[2], port[0], port[2], now)
    assert j == t is None
    # a sequential sync crosses every rotation, one run per set
    j = outcome(JLV.verify_sequential_batched, CHAIN, rotating[0],
                rotating[1:], PERIOD, now, backend="cpu")
    t = outcome(TLV.verify_sequential_batched, CHAIN, port[0], port[1:],
                PERIOD, now, device="cpu")
    assert j == t is None


@pytest.mark.parametrize("bad_item,lane", [(9, 0), (9, 2), (0, 1),
                                           (18, 1)])
def test_corrupt_signature_in_a_batch(chain, port_chain, bad_item, lane):
    """A bad signature within the light scope of header ``bad_item + 2``
    (items count from the header after the trusted one)."""
    now = now_after(chain)
    jrun, trun = list(chain[1:20]), list(port_chain[1:20])
    jb, tb = copy.deepcopy(jrun[bad_item]), copy.deepcopy(trun[bad_item])
    for c in (jb.commit, tb.commit):
        sig = bytearray(c.signatures[lane].signature)
        sig[5] ^= 0x40
        c.signatures[lane].signature = bytes(sig)
    jrun[bad_item], trun[bad_item] = jb, tb
    j = outcome(JLV.verify_sequential_batched, CHAIN, chain[0], jrun,
                PERIOD, now, backend="cpu")
    t = outcome(TLV.verify_sequential_batched, CHAIN, port_chain[0], trun,
                PERIOD, now, device="cpu")
    assert j == t == ("ErrBatchItemInvalid", bad_item, bad_item + 2,
                      "ErrInvalidSignature", lane)


def test_batched_commits_not_enough_power(chain, port_chain):
    """Absent lanes that leave 2/3 unmet: the batch names the item
    before any dispatch."""
    from cometbft_tpu.types import validation as JV
    from cometbft_tpu_torch.types import validation as TV

    jc, tc = (copy.deepcopy(chain[7].commit),
              copy.deepcopy(port_chain[7].commit))
    for c in (jc, tc):
        for cs in c.signatures[2:]:
            cs.block_id_flag, cs.signature = 1, b""
            cs.validator_address = b""
    jitems = [(lb.commit.block_id, lb.height, lb.commit)
              for lb in chain[5:7]] + [(jc.block_id, jc.height, jc)]
    titems = [(lb.commit.block_id, lb.height, lb.commit)
              for lb in port_chain[5:7]] + [(tc.block_id, tc.height, tc)]
    j = outcome(JV.verify_commits_light_batched, CHAIN,
                chain[5].validators, jitems, backend="cpu")
    t = outcome(TV.verify_commits_light_batched, CHAIN,
                port_chain[5].validators, titems, device="cpu")
    assert j == t == ("ErrBatchItemInvalid", 2, 8,
                      "ErrNotEnoughVotingPower", None)
    n = TV.verify_commits_light_batched(CHAIN, port_chain[5].validators,
                                        titems[:2], device="cpu")
    assert n == JV.verify_commits_light_batched(
        CHAIN, chain[5].validators, jitems[:2], backend="cpu") == 10


def test_merkle_threshold_is_the_jax_packages():
    from cometbft_tpu.crypto import merkle as JM

    assert TM.MERKLE_KERNEL_MIN_LEAVES == JM._KERNEL_MIN_LEAVES
    assert TM._LEAF_KERNEL_MAX_LEN == JM._LEAF_KERNEL_MAX_LEN
    assert TM._PROOF_LEVEL_MIN == JM._PROOF_LEVEL_MIN


def test_aggregate_lanes_are_refused(port_chain, chain):
    """AGGREGATE-flag lanes without an aggregate signature: the commit
    hashes as in the JAX package (no aggregate leaf), the basic check
    names the missing signature, and a batch names the item."""
    from cometbft_tpu.types.commit import BLOCK_ID_FLAG_AGGREGATE as JAGG
    from cometbft_tpu_torch.types import validation as TV
    from cometbft_tpu_torch.types.commit import BLOCK_ID_FLAG_AGGREGATE

    lb = port_chain[2]
    c = copy.deepcopy(lb.commit)
    c.signatures[3].block_id_flag = BLOCK_ID_FLAG_AGGREGATE
    c.signatures[3].signature = b""
    jc = copy.deepcopy(chain[2].commit)
    jc.signatures[3].block_id_flag = JAGG
    jc.signatures[3].signature = b""
    assert c.hash("cpu") == jc.hash()
    assert c.validate_basic() == jc.validate_basic() == \
        "aggregate signature must be 96 bytes"
    items = [(port_chain[1].commit.block_id, 2, port_chain[1].commit),
             (c.block_id, 3, c)]
    with pytest.raises(TV.ErrBatchItemInvalid) as err:
        TV.verify_commits_light_batched(CHAIN, lb.validators, items,
                                        device="cpu")
    assert (err.value.item, err.value.height) == (1, 3)
    assert isinstance(err.value.cause, TV.ErrInvalidCommit)
