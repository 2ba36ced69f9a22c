"""The merkle SHA-256 kernels (K8) and the merkle routes of the port
against the JAX package, on the CPU.

The same numpy inputs go through ``jax.jit`` of
``cometbft_tpu.ops.sha256.sha256_blocks`` / ``merkle_inner_level`` and
through the port's wrappers on CPU tensors (their plain versions); trees
of every route size go through the port's ``hash_from_byte_slices_fast``
and ``proofs_from_byte_slices`` with ``device="cpu"`` and through the
JAX package's ``hash_from_byte_slices`` and ``proofs_from_byte_slices``.
Equality is exact (tolerance 0)."""

import hashlib

import jax
import numpy as np
import pytest
import torch

from cometbft_tpu.crypto import merkle as JM
from cometbft_tpu.ops import sha256 as JS
from cometbft_tpu_torch.crypto import merkle as TM
from cometbft_tpu_torch.ops import _build
from cometbft_tpu_torch.ops import sha256 as TS

# the plain versions run on tensors of a few lanes: one intra-op thread is
# as fast, and leaves the cores to the other test workers
torch.set_num_threads(1)

pytestmark = pytest.mark.timeout(900)


def _padded(rng, lens, nb):
    msgs = np.zeros((len(lens), max(max(lens), 1)), np.uint8)
    for i, k in enumerate(lens):
        msgs[i, :k] = np.frombuffer(rng.bytes(int(k)), np.uint8)
    return msgs, TS.host_pad(msgs, np.asarray(lens), nb)


@pytest.mark.parametrize("nb", [1, 2])
def test_sha256_blocks_matches_jax(nb):
    """Ragged lengths up to the block count, and active counts cut below
    and pushed past each lane's need (the mask semantics)."""
    rng = np.random.default_rng(80 + nb)
    lens = [int(x) for x in rng.integers(0, 64 * nb - 9 + 1, size=37)]
    lens[:3] = [0, 64 * nb - 9, 55]
    msgs, (blocks, active) = _padded(rng, lens, nb)
    active = active.copy()
    active[5:9] = [0, nb, -2, nb + 3]
    want = np.asarray(jax.jit(JS.sha256_blocks)(blocks, active))
    got = TS.sha256_blocks(torch.from_numpy(blocks.view(np.int32)),
                           torch.from_numpy(active))
    assert got.dtype == torch.uint8 and got.shape == (37, 32)
    assert np.array_equal(got.numpy().astype(np.int32), want)
    words = TS.sha256_leaf_words(torch.from_numpy(blocks.view(np.int32)),
                                 torch.from_numpy(active))
    assert np.array_equal(TS.words_to_bytes(words.numpy()), got.numpy())
    for i in [0, 1, 2, 3, 10, 36]:
        assert got[i].numpy().tobytes() == hashlib.sha256(
            msgs[i, :lens[i]].tobytes()).digest()


@pytest.mark.parametrize("b", [1, 5, 64])
def test_merkle_inner_level_matches_jax(b):
    rng = np.random.default_rng(90 + b)
    left = np.frombuffer(rng.bytes(32 * b), np.uint32).reshape(b, 8).copy()
    right = np.frombuffer(rng.bytes(32 * b), np.uint32).reshape(b, 8).copy()
    left[0] = 0xFFFFFFFF          # every byte that shifts across words
    want = np.asarray(jax.jit(JS.merkle_inner_level)(left, right))
    got = TS.merkle_inner_level(torch.from_numpy(left.view(np.int32)),
                                torch.from_numpy(right.view(np.int32)))
    assert np.array_equal(got.numpy().view(np.uint32), want)
    lb, rb = TS.words_to_bytes(left), TS.words_to_bytes(right)
    assert TS.words_to_bytes(got.numpy())[0].tobytes() == hashlib.sha256(
        b"\x01" + lb[0].tobytes() + rb[0].tobytes()).digest()


@pytest.mark.parametrize("n", [1, 2, 3, 7, 64, 255, 257, 300])
def test_merkle_tree_matches_jax(n):
    """The whole-tree wrapper's plain version (every level above the
    leaves, into one buffer) against ``jax.jit`` of
    ``merkle_inner_level`` level by level (pairs padded to one shape, the
    odd tail promoted) and against hashlib."""
    rng = np.random.default_rng(170 + n)
    leaves = np.frombuffer(rng.bytes(32 * n), np.uint32).reshape(n, 8).copy()
    rows = TS.tree_rows(n)
    buf = torch.zeros((rows, 8), dtype=torch.int32)
    buf[:n] = torch.from_numpy(leaves.view(np.int32))
    got = TS.merkle_tree(buf, n).numpy().view(np.uint32)
    inner = jax.jit(JS.merkle_inner_level)
    lv, want = leaves, [leaves]
    while len(lv) > 1:
        m = len(lv) // 2
        pad = np.zeros((256, 8), np.uint32)
        left, right = pad.copy(), pad.copy()
        left[:m], right[:m] = lv[0:2 * m:2], lv[1:2 * m:2]
        lv = np.concatenate([np.asarray(inner(left, right))[:m],
                             lv[2 * m:]])
        want.append(lv)
    assert np.array_equal(got, np.concatenate(want))
    hl = [TS.words_to_bytes(r).tobytes() for r in leaves]
    while len(hl) > 1:
        hl = [hashlib.sha256(b"\x01" + hl[2 * i] + hl[2 * i + 1]).digest()
              for i in range(len(hl) // 2)] + hl[len(hl) - len(hl) % 2:]
    assert TS.words_to_bytes(got[-1]).tobytes() == hl[0]


@pytest.mark.parametrize("n,nb", [(1, 1), (2, 2), (7, 1), (64, 2),
                                  (257, 2)])
def test_merkle_tree_leaves_matches_jax(n, nb):
    """The fused tree call's plain version (the leaves' digest words, then
    every level above them, in one buffer) against ``jax.jit`` of
    ``sha256_blocks`` on the padded leaves, then of
    ``merkle_inner_level`` level by level (pairs padded to one shape, the
    odd tail promoted); ragged leaves, and active counts cut to 0 and
    pushed past the block count."""
    rng = np.random.default_rng(190 + n)
    lens = [int(x) for x in rng.integers(1, 64 * nb - 9 + 1, size=n)]
    _, (blocks, active) = _padded(rng, lens, nb)
    active = active.copy()
    active[n // 2] = 0
    active[n - 1] = nb + 2
    got = TS.merkle_tree_leaves(torch.from_numpy(blocks.view(np.int32)),
                                torch.from_numpy(active))
    assert got.shape == (TS.tree_rows(n), 8)
    leaves = TS.bytes_to_words(np.asarray(jax.jit(JS.sha256_blocks)(
        blocks, active)).astype(np.uint8))
    inner = jax.jit(JS.merkle_inner_level)
    lv, want = leaves, [leaves]
    while len(lv) > 1:
        m = len(lv) // 2
        pad = np.zeros((256, 8), np.uint32)
        left, right = pad.copy(), pad.copy()
        left[:m], right[:m] = lv[0:2 * m:2], lv[1:2 * m:2]
        lv = np.concatenate([np.asarray(inner(left, right))[:m],
                             lv[2 * m:]])
        want.append(lv)
    assert np.array_equal(got.numpy().view(np.uint32), np.concatenate(want))


def test_merkle_level_promotes_the_odd_tail():
    rng = np.random.default_rng(95)
    kids = torch.from_numpy(np.frombuffer(rng.bytes(32 * 7), np.int32)
                            .reshape(7, 8).copy())
    par = TS.merkle_level(kids)
    assert par.shape == (4, 8)
    assert torch.equal(par[3], kids[6])
    assert torch.equal(par[:3], TS.merkle_inner_level(kids[0:6:2].clone(),
                                                      kids[1:6:2].clone()))


def test_packers_match_jax():
    rng = np.random.default_rng(96)
    lens = np.array([0, 1, 55, 56, 63, 64, 118, 119], np.int64)
    msgs = np.zeros((8, 119), np.uint8)
    for i, k in enumerate(lens):
        msgs[i, :k] = np.frombuffer(rng.bytes(int(k)), np.uint8)
    for nb in (2, 3):
        want, act_want = JS.host_pad(msgs, lens, nb)
        got, act = TS.host_pad(msgs, lens, nb)
        assert np.array_equal(got, want) and np.array_equal(act, act_want)
    assert [TS.max_blocks_for_len(k) for k in range(130)] == \
        [JS.max_blocks_for_len(k) for k in range(130)]
    assert np.array_equal(TS.K, JS.K) and np.array_equal(TS.IV, JS.IV)
    d = np.frombuffer(rng.bytes(96), np.uint8).reshape(3, 32)
    assert np.array_equal(TS.bytes_to_words(d), JS.bytes_to_words(d))
    w = TS.bytes_to_words(d)
    assert np.array_equal(TS.words_to_bytes(w), JS.words_to_bytes(w))


def _items(n, seed, lo=0, hi=119):
    rng = np.random.default_rng(seed)
    return [rng.bytes(int(k)) for k in rng.integers(lo, hi, size=n)]


# (case id, leaves, expected route): "recursive" below 64, "levels"
# (hashlib level loop) below 2,048, "kernel" from 2,048
TREES = [(f"{n} leaves", dict(n=n, seed=n), route) for n, route in [
    (1, "recursive"), (2, "recursive"), (3, "recursive"), (63, "recursive"),
    (64, "levels"), (65, "levels"), (2047, "levels"), (2048, "kernel"),
    (2049, "kernel"), (5000, "kernel")]] + [
    ("2048 leaves of 118 bytes", dict(n=2048, seed=7, lo=118, hi=119),
     "kernel"),
    ("2048 leaves, one of 119 bytes", dict(n=2048, seed=8, lo=0, hi=119,
                                           long_at=1000), "kernel-hashlib"),
    ("2100 leaves of 119-300 bytes", dict(n=2100, seed=9, lo=119, hi=300),
     "kernel-hashlib"),
    ("70 leaves of 300 bytes", dict(n=70, seed=10, lo=300, hi=301),
     "levels"),
]


@pytest.mark.parametrize("spec,route", [t[1:] for t in TREES],
                         ids=[t[0] for t in TREES])
def test_tree_roots_and_proofs_match_jax(spec, route):
    spec = dict(spec)
    long_at = spec.pop("long_at", None)
    items = _items(**spec)
    if long_at is not None:
        items[long_at] = b"\x07" * 119
    n = len(items)
    _build.reset_launches()
    root = TM.hash_from_byte_slices_fast(items, device="cpu")
    assert root == JM.hash_from_byte_slices(items)
    troot, tproofs = TM.proofs_from_byte_slices(items, device="cpu")
    jroot, jproofs = JM.proofs_from_byte_slices(items)
    assert troot == jroot == root
    assert [tuple(p) for p in tproofs] == [tuple(p) for p in jproofs]
    assert not _build.LAUNCHES
    want = {"recursive": {}, "levels": {},
            "kernel": {"merkle_tree_leaves": 2},
            "kernel-hashlib": {"merkle_tree": 2}}[route]
    assert dict(_build.PLAIN_CALLS) == want
    for i in {0, n // 2, n - 1}:
        assert tproofs[i].verify(root, items[i])
        assert tproofs[i].compute_root() == root
    assert not tproofs[n - 1].verify(root, items[n - 1] + b"!")


def test_empty_tree():
    assert TM.hash_from_byte_slices_fast([], device="cpu") == \
        JM.hash_from_byte_slices([]) == hashlib.sha256(b"").digest()


def test_kernel_route_without_a_card_raises():
    """``device=None`` is CUDA: at 2,048 leaves it raises where there is
    no card, and below 2,048 leaves the device is never read."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: this checks the refusal")
    items = _items(2048, 11)
    with pytest.raises(RuntimeError):
        TM.hash_from_byte_slices_fast(items)
    with pytest.raises(RuntimeError):
        TM.proofs_from_byte_slices(items)
    _build.reset_launches()
    assert TM.hash_from_byte_slices_fast(items[:2047]) == \
        JM.hash_from_byte_slices(items[:2047])
    assert not _build.LAUNCHES and not _build.PLAIN_CALLS
