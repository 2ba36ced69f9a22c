"""The host kernel harness (``tests/torch_kernels_host_fixtures.py``) on
the hash kernels: SHA-512 mod L, SHA-256 leaves, one merkle level, the
tree, and the tree with its leaves, each against its plain PyTorch
version and hashlib, exactly."""

import hashlib

import numpy as np
import pytest
import torch

from cometbft_tpu_torch.ops import sha256, sha512

from torch_kernels_host_fixtures import L, harness, needs_gxx  # noqa: F401

# the plain versions run on tensors of a few lanes: one intra-op thread is
# as fast, and leaves the cores to the other test workers
torch.set_num_threads(1)

pytestmark = [pytest.mark.timeout(900), needs_gxx]


def test_sha512_scalar_matches_plain_and_hashlib(harness):
    rng = np.random.default_rng(32)
    lens = np.array([0, 1, 111, 112, 127, 128, 17, 239], np.int64)
    msgs = np.zeros((len(lens), 240), np.uint8)
    for i, k in enumerate(lens):
        msgs[i, :k] = np.frombuffer(rng.bytes(int(k)), np.uint8)
    blocks, active = sha512.host_pad(msgs, lens, 2)
    b = len(lens)
    got = harness("sha", [b, 2], {"blocks": blocks, "active": active},
                  {"h": (np.uint8, (b, 32))})["h"]
    plain = sha512._sha512_scalar_plain(
        torch.from_numpy(blocks.view(np.int32).copy()),
        torch.from_numpy(active.copy()))
    assert np.array_equal(got, plain.numpy())
    for i, k in enumerate(lens):
        want = int.from_bytes(hashlib.sha512(msgs[i, :k].tobytes()).digest(),
                              "little") % L
        assert int.from_bytes(got[i].tobytes(), "little") == want


@pytest.mark.parametrize("words", [0, 1], ids=["bytes", "words"])
def test_sha256_leaves_match_plain_and_hashlib(harness, words):
    """Ragged one- and two-block leaves (55/56 and 119/120 bytes straddle
    the block edges), active counts outside [0, NB] acting as the mask's
    nearest end, at a lane count that leaves a partial thread block.  The
    kernel's digest words are held against both public wrappers' plain
    versions: ``sha256_blocks`` (bytes) and ``sha256_leaf_words``."""
    rng = np.random.default_rng(39)
    lens = np.array([0, 1, 55, 56, 63, 64, 100, 119] * 20 + [7, 9, 3],
                    np.int64)
    b, nb = len(lens), 2
    msgs = np.zeros((b, 120), np.uint8)
    for i, k in enumerate(lens):
        msgs[i, :k] = np.frombuffer(rng.bytes(int(k)), np.uint8)
    blocks, active = sha256.host_pad(msgs, lens, nb)
    active[-3:] = [-1, 0, 5]
    out = harness("sha256", [b, nb], {"blocks": blocks, "active": active},
                  {"out": (np.uint32, (b, 8))})["out"]
    got = sha256.words_to_bytes(out)
    args = (torch.from_numpy(blocks.view(np.int32).copy()),
            torch.from_numpy(active.copy()))
    if words:
        plain = sha256.sha256_leaf_words(*args).numpy()
        assert np.array_equal(out.view(np.int32), plain)
        plain = sha256.words_to_bytes(plain)
    else:
        plain = sha256.sha256_blocks(*args).numpy()
    assert np.array_equal(got, plain)
    empty = hashlib.sha256(b"").digest()
    for i, k in enumerate(lens[:-3]):
        assert got[i].tobytes() == hashlib.sha256(
            msgs[i, :k].tobytes()).digest()
    # active -1 and 0 leave the initial state; 5 runs both blocks
    iv = sha256.words_to_bytes(sha256.IV)
    assert got[-3].tobytes() == got[-2].tobytes() == iv.tobytes()
    assert got[-1].tobytes() != empty


@pytest.mark.parametrize("n", [1, 2, 3, 255, 256, 257, 600])
def test_merkle_tree_matches_plain_and_hashlib(harness, n):
    """Every level of trees around the kernel's runs of 256 children (one
    block, one block plus one child, three blocks and a second launch),
    against the plain level loop and against hashlib's level order."""
    from cometbft_tpu_torch.crypto import merkle

    rng = np.random.default_rng(50 + n)
    leaves = np.frombuffer(rng.bytes(32 * n), np.uint8).reshape(n, 32)
    words = sha256.bytes_to_words(leaves)
    rows = sha256.tree_rows(n)
    got = harness("merkle_tree", [n], {"leaves": words},
                  {"levels": (np.uint32, (rows, 8))})["levels"]
    buf = torch.zeros((rows, 8), dtype=torch.int32)
    buf[:n] = torch.from_numpy(words.view(np.int32))
    plain = sha256.merkle_tree(buf, n)
    assert np.array_equal(got.view(np.int32), plain.numpy())
    lv = [leaves[i].tobytes() for i in range(n)]
    want = []
    while True:
        want += lv
        if len(lv) == 1:
            break
        lv = [merkle.inner_hash(lv[2 * i], lv[2 * i + 1])
              for i in range(len(lv) // 2)] + lv[len(lv) - len(lv) % 2:]
    assert [r.tobytes() for r in sha256.words_to_bytes(got)] == want


@pytest.mark.parametrize("n", [2, 7, 257])
def test_merkle_level_matches_plain_and_hashlib(harness, n):
    rng = np.random.default_rng(40 + n)
    children = np.frombuffer(rng.bytes(32 * n), np.uint8).reshape(n, 32)
    words = sha256.bytes_to_words(children)
    m = (n + 1) // 2
    got = harness("merkle", [n], {"children": words},
                  {"parents": (np.uint32, (m, 8))})["parents"]
    plain = sha256.merkle_level(torch.from_numpy(words.view(np.int32)))
    assert np.array_equal(got.view(np.int32), plain.numpy())
    parents = sha256.words_to_bytes(got)
    for i in range(n // 2):
        assert parents[i].tobytes() == hashlib.sha256(
            b"\x01" + children[2 * i].tobytes()
            + children[2 * i + 1].tobytes()).digest()
    if n & 1:
        assert parents[-1].tobytes() == children[-1].tobytes()


@pytest.mark.parametrize("nb", ["1", "2", "mixed"])
@pytest.mark.parametrize("n", [1, 2, 255, 256, 257, 600])
def test_merkle_tree_leaves_matches_plain_and_hashlib(harness, n, nb):
    """The tree with its leaves in one call: the first launch hashes a run
    of 256 leaves a block (a thread a leaf) into the shared memory its
    subtree is built in, and writes them to the head of the level
    buffer.  One-block leaves (0x00 || up to 54
    bytes), two-block leaves (55 to 118 bytes), and a mix of both with
    active counts cut to 1, 0 and -1 and pushed past NB; every level
    against the plain version (the leaves' plain version, then the
    tree's) and hashlib's level order (the leaves' digests under the
    mask for the cut counts)."""
    from cometbft_tpu_torch.crypto import merkle

    rng = np.random.default_rng(130 + n)
    lo, hi = {"1": (0, 55), "2": (55, 119), "mixed": (0, 119)}[nb]
    items = [rng.bytes(int(k)) for k in rng.integers(lo, hi, size=n)]
    blocks, active = merkle._leaf_blocks(items)
    if nb == "mixed":
        active = active.copy()
        for i, a in zip(range(0, n, 7), (1, 0, -1, 3)):
            active[i] = a
    n_blocks = blocks.shape[1]
    rows = sha256.tree_rows(n)
    got = harness("merkle_tree_leaves", [n, n_blocks],
                  {"blocks": blocks, "active": active},
                  {"levels": (np.uint32, (rows, 8))})["levels"]
    plain = sha256.merkle_tree_leaves(
        torch.from_numpy(blocks.view(np.int32).copy()),
        torch.from_numpy(active))
    assert np.array_equal(got.view(np.int32), plain.numpy())
    # a leaf whose count covers its blocks is hashlib's digest, a count of
    # 0 or less the initial state; a count cut or pushed past its need
    # hashes other blocks and is held against the plain version alone
    iv = sha256.words_to_bytes(sha256.IV).tobytes()
    lv = []
    for i, it in enumerate(items):
        used = min(max(int(active[i]), 0), n_blocks)
        need = sha256.max_blocks_for_len(len(it) + 1)
        lv.append(iv if used == 0 else
                  merkle.leaf_hash(it) if used == need else
                  sha256.words_to_bytes(got[i]).tobytes())
    assert [sha256.words_to_bytes(r).tobytes() for r in got[:n]] == lv
    want = []
    while True:
        want += lv
        if len(lv) == 1:
            break
        lv = [merkle.inner_hash(lv[2 * i], lv[2 * i + 1])
              for i in range(len(lv) // 2)] + lv[len(lv) - len(lv) % 2:]
    assert [r.tobytes() for r in sha256.words_to_bytes(got)] == want
