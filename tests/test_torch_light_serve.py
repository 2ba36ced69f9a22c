"""The port's light-serving tier (``cometbft_tpu_torch/light/serve.py``)
and its ``TreeCache`` against the JAX package's on the same inputs.

- ``TreeCache``: roots, every level and every proof at 1, 2, 63, 64,
  1,000 and 2,100 leaves (the recursive, native and kernel routes; the
  kernel's plain version at 2,100, ``device="cpu"``).
- The tier: both packages' tiers over stub stores of the same
  ``make_light_chain`` chains (carried into the port by the codec's
  bytes), the port's on ``device="cpu"``, the JAX one on
  ``backend="cpu"``: ``light_block``, ``light_blocks``, ``proofs`` and
  ``verify_commits`` return equal dicts, and ``stats()`` is equal after
  every call, over LRU and trust-period eviction, validator-set churn, a
  tampered anchor, a foreign fork's anchor, a wrong height, a non-commit
  payload, mixed validator sets in one request and the verdict memo.
  The port's verification runs on the device-owner thread
  (``patient=True``); the host oracle is patched to raise.
"""

import copy
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from cometbft_tpu.crypto import merkle as JM
from cometbft_tpu.light.serve import LightServeTier as JTier
from cometbft_tpu.rpc.json import jsonable as j_jsonable
from cometbft_tpu.testing import make_light_chain
from cometbft_tpu.types import codec as JC
from cometbft_tpu.types.vote import PRECOMMIT_TYPE as J_PRECOMMIT
from cometbft_tpu.types.vote import Vote as JVote
from cometbft_tpu_torch.crypto import _ed25519_py as ref
from cometbft_tpu_torch.crypto import batch as cbatch
from cometbft_tpu_torch.crypto import merkle as TM
from cometbft_tpu_torch.light.serve import LightServeTier as TTier
from cometbft_tpu_torch.ops import _build
from cometbft_tpu_torch.types import codec as TC

torch.set_num_threads(1)

pytestmark = pytest.mark.timeout(300)

CHAIN = "light-chain"
NS = 1_000_000_000


@pytest.fixture(autouse=True)
def no_host_verify(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("host oracle called on the serving path")

    monkeypatch.setattr(ref, "verify_zip215", refuse)


# --------------------------------------------------------------- TreeCache

@pytest.mark.parametrize("n", [0, 1, 2, 63, 64, 1000, 2100])
def test_tree_cache_equals_jax(n):
    rng = np.random.default_rng(n)
    items = [rng.bytes(int(rng.integers(0, 90))) for _ in range(n)]
    before = dict(_build.PLAIN_CALLS)
    t = TM.TreeCache.build(items, device="cpu")
    j = JM.TreeCache.build(items)
    assert t.total == j.total == n
    assert t.levels == j.levels
    assert t.root == j.root
    assert t.nbytes() == j.nbytes()
    assert [tuple(p) for p in t.proofs(range(n))] == \
        [tuple(p) for p in j.proofs(range(n))]
    if n:
        root, ref_proofs = TM.proofs_from_byte_slices_reference(items)
        assert t.root == root and t.proofs(range(n)) == ref_proofs
        for i in (0, n // 2, n - 1):
            assert t.proof(i).verify(root, items[i])
    kernel = _build.PLAIN_CALLS.get("merkle_tree_leaves", 0) - \
        before.get("merkle_tree_leaves", 0)
    assert kernel == (1 if n >= TM.MERKLE_KERNEL_MIN_LEAVES else 0)
    for bad in (-1, n):
        with pytest.raises(IndexError):
            t.proof(bad)


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is visible")
def test_kernel_route_and_tier_raise_without_a_card():
    items = [b"%d" % i for i in range(TM.MERKLE_KERNEL_MIN_LEAVES)]
    with pytest.raises(RuntimeError):
        TM.TreeCache.build(items)
    TM.TreeCache.build(items[:-1])          # the native route needs none
    with pytest.raises(RuntimeError):
        TTier(None, None, CHAIN)
    with pytest.raises(RuntimeError):
        TTier(None, None, CHAIN, device="cuda")


# ------------------------------------------------------------ stub stores

class StubBlockStore:
    """A block store view over a light chain (the JAX package's test
    stub): per-height tx lists are synthesized for the tx proofs."""

    def __init__(self, chain, txs_per_block=0):
        self.by_height = {lb.height: lb for lb in chain}
        self.txs = {lb.height: [b"tx-%d-%d" % (lb.height, i)
                                for i in range(txs_per_block)]
                    for lb in chain}
        self.loads = 0

    def base(self):
        return min(self.by_height)

    def height(self):
        return max(self.by_height)

    def load_block(self, h):
        lb = self.by_height.get(h)
        if lb is None:
            return None
        self.loads += 1
        return SimpleNamespace(header=lb.header,
                               data=SimpleNamespace(txs=self.txs[h]))

    def load_block_commit(self, h):
        lb = self.by_height.get(h)
        return lb.commit if lb is not None else None

    def load_block_meta(self, h):
        lb = self.by_height.get(h)
        if lb is None:
            return None
        return SimpleNamespace(block_id=lb.commit.block_id)

    def load_seen_commit(self):
        return None


class StubStateStore:
    def __init__(self, chain):
        self.by_height = {lb.height: lb.validators for lb in chain}

    def load_validators(self, h):
        return self.by_height.get(h)


def _port_chain(chain):
    return [TC.unpack(JC.pack(lb)) for lb in chain]


def _tiers(chain, *, txs_per_block=0, now_ns=None, **kw):
    """(port tier, JAX tier, port block store, JAX block store)."""
    if now_ns is None:
        def now_ns():
            return chain[-1].header.time_ns + 60 * NS
    pchain = _port_chain(chain)
    tbs = StubBlockStore(pchain, txs_per_block)
    jbs = StubBlockStore(chain, txs_per_block)
    t = TTier(tbs, StubStateStore(pchain), CHAIN, device="cpu",
              now_ns=now_ns, **kw)
    j = JTier(jbs, StubStateStore(chain), CHAIN, backend="cpu",
              now_ns=now_ns, **kw)
    return t, j, tbs, jbs


def _both(t, j, method, *args):
    """The same call on both tiers: equal results (or the same error
    class name, message and code) and equal stats afterwards."""
    outs = []
    for tier in (t, j):
        try:
            outs.append(("ok", getattr(tier, method)(*args)))
        except Exception as e:          # noqa: BLE001 — compared below
            outs.append(("err", type(e).__name__, str(e),
                         getattr(e, "code", None)))
    assert outs[0] == outs[1], (method, args)
    assert t.stats() == j.stats(), (method, args)
    return outs[0]


def _anchor(lb):
    return {"height": lb.height, "commit": j_jsonable(lb.commit)}


def _tampered(lb, lane=0):
    c = copy.deepcopy(lb.commit)
    sig = bytearray(c.signatures[lane].signature)
    sig[0] ^= 0xFF
    c.signatures[lane].signature = bytes(sig)
    return {"height": lb.height, "commit": j_jsonable(c)}


# ------------------------------------------------------------ light blocks

def test_light_blocks_lru_and_churn_equal_jax():
    chain = make_light_chain(10, n_vals=4, rotate_every=3)
    t, j, tbs, jbs = _tiers(chain, header_cache_size=4,
                            header_cache_bytes=9000)
    for h in list(range(1, 11)) + [10, 9, 1, 1, None, 0, "3", "x", 11]:
        _both(t, j, "light_block", h)
    assert tbs.loads == jbs.loads
    _both(t, j, "light_blocks", [1, 2, 99, 5, 5])
    _both(t, j, "light_blocks", "4,7, 9")
    _both(t, j, "light_blocks", [])
    _both(t, j, "light_blocks", list(range(1, 200)))
    _both(t, j, "light_blocks", ["a"])
    st = t.stats()
    assert st["evictions_lru"] > 0 and st["header_hits"] > 0


def test_trust_period_window_equal_jax():
    chain = make_light_chain(6, n_vals=4)
    clock = {"now": chain[-1].header.time_ns + NS}
    t, j, _, _ = _tiers(chain, now_ns=lambda: clock["now"],
                        trust_period_ns=4 * NS)
    for h in range(1, 7):
        _both(t, j, "light_block", h)
    clock["now"] += 2 * NS                  # heights 1..3 leave the window
    for h in range(1, 7):
        _both(t, j, "light_block", h)
    assert t.stats()["evictions_trust_period"] > 0


# ------------------------------------------------------------------ proofs

def test_proofs_equal_jax():
    chain = make_light_chain(5, n_vals=7, rotate_every=2)
    t, j, _, _ = _tiers(chain, txs_per_block=11, proof_cache_blocks=2,
                        max_proofs=9)
    for args in ((3, "tx", None), (3, "tx", [0, 10, 5]),
                 (3, "tx", "1, 2"), (4, "validator", None),
                 (2, "validator", 6), (5, "tx", [3]), (3, "tx", [4]),
                 (None, "validator", None), (1, "tx", [11]),
                 (1, "nope", None), (1, "tx", list(range(10))),
                 (1, "tx", "a,b"), (9, "tx", None)):
        out = _both(t, j, "proofs", *args)
        if out[0] == "ok" and args[1] == "validator":
            lb = chain[(args[0] or 5) - 1]
            assert out[1]["root"] == lb.header.validators_hash.hex()
    assert t.stats()["proof_hits"] > 0


# -------------------------------------------------------- anchor verifying

def test_verify_commits_equal_jax():
    chain = make_light_chain(8, n_vals=4, rotate_every=3)
    fork = make_light_chain(8, n_vals=4, rotate_every=3, fork_at=2,
                            fork_skew_ns=7 * NS)
    t, j, _, _ = _tiers(chain)
    vote = JVote(type=J_PRECOMMIT, height=2, round=0,
                 block_id=chain[1].commit.block_id, timestamp_ns=1,
                 validator_address=b"\x01" * 20, validator_index=0)
    cases = [
        # mixed validator sets in one request, one tampered anchor
        [_anchor(chain[0]), _tampered(chain[1]), _anchor(chain[2]),
         _anchor(chain[3]), _anchor(chain[6])],
        # the same again: the good anchors hit the memo
        [_anchor(chain[0]), _tampered(chain[1]), _anchor(chain[2]),
         _anchor(chain[3]), _anchor(chain[6])],
        # a bad lane in the middle of one set's run: earlier anchors are
        # proven by the batch, later ones re-batched
        [_anchor(chain[3]), _anchor(chain[4]), _tampered(chain[5], 2),
         _anchor(chain[5]), _anchor(chain[7])],
        # a foreign fork, a wrong height, a vote, an unknown height
        [_anchor(fork[4]), {"height": 2, "commit": j_jsonable(
            chain[2].commit)}, {"height": 2, "commit": j_jsonable(vote)},
         {"height": 99, "commit": j_jsonable(chain[0].commit)},
         _anchor(chain[1])],
    ]
    want = [[True, False, True, True, True], [True, False, True, True, True],
            [True, True, False, True, True],
            [False, False, False, False, True]]
    before = dict(cbatch.DISPATCHES)
    cached = []
    for anchors, oks in zip(cases, want):
        out = _both(t, j, "verify_commits", anchors)
        assert out[0] == "ok"
        assert [r["ok"] for r in out[1]["results"]] == oks
        cached.append([r.get("cached") for r in out[1]["results"]])
    assert cached[1] == [True, None, True, True, True]
    for bad in ([], "x", [{"height": 1}], [_anchor(chain[0])] * 200):
        _both(t, j, "verify_commits", bad)
    st = t.stats()
    assert st["verify_hits"] > 0 and st["anchors_bad"] > 0
    # every group went to the device (the plain versions here)
    assert sum(v - before.get(k, 0) for k, v in cbatch.DISPATCHES.items()
               ) > 0
