"""RFC-6962-style merkle trees and proofs.

Counterpart of ``cometbft_tpu/crypto/merkle.py`` (reference:
``crypto/merkle/``): leaf and inner domain separation (0x00 / 0x01
prefixes), split at the largest power of two strictly below n, the empty
tree hashes to SHA-256 of the empty string.  Validator-set, commit,
header and data hashes go through here.

Large trees are built in level order: adjacent nodes pair left to right
and an odd tail node is promoted unchanged, which gives the same tree as
the recursive split.  Routing by leaf count, as in the JAX package:

- below 64 leaves, the recursive hashlib function;
- from 64 up to ``MERKLE_KERNEL_MIN_LEAVES``, the native C++ tree
  (``native.merkle_root``, ``merkle_levels``: ``csrc/host/kvstore.cpp``,
  the JAX package's route here), which beat the hashlib level loop
  2-3x at 64 to 2,047 leaves on the H100's host (``chip_smoke.py``
  phase 14 (d): 1.5 against 4.6 ms for every level of 2,047 leaves,
  0.87 ms for the root alone);
- at ``MERKLE_KERNEL_MIN_LEAVES`` leaves or more, the SHA-256 kernels of
  ``ops/sha256.py`` on ``device``: one ``merkle_tree_leaves`` call over
  the padded leaves hashes them and builds every level above them (items
  longer than ``_LEAF_KERNEL_MAX_LEN`` bytes have their leaves hashed
  with hashlib instead, then one ``merkle_tree`` call builds the
  levels).  The levels stay on the device in one
  buffer and cross to the host once: the root, or every level when
  proofs are built.  ``device=None`` is the first of the plan's devices
  (``crypto/plan.py:resolve_devices``) and raises without a card:
  under a device set the tree is not sharded, as the JAX package's
  live tree is not; ``"cpu"`` runs the plain versions.

For provable key-value stores (the kvstore app's app hash): :func:`kv_leaf`
binds the key into the leaf, and :class:`ValueOp` proves a (key, value)
against a root (``crypto/merkle/proof_value.go``); its serialized
:class:`ProofOp` is the JAX package's, byte for byte.
"""

from __future__ import annotations

import hashlib
from itertools import count, repeat
from operator import itemgetter
from typing import NamedTuple

import numpy as np
import torch

from .. import native as _native
from ..ops import sha256 as _s
from . import plan as _plan

__all__ = ["LEAF_PREFIX", "INNER_PREFIX", "MERKLE_KERNEL_MIN_LEAVES",
           "leaf_hash", "inner_hash", "hash_from_byte_slices",
           "hash_from_byte_slices_fast", "Proof",
           "proofs_from_byte_slices", "proofs_from_byte_slices_reference",
           "ProofOp", "ProofOpError", "kv_leaf", "ValueOp"]

LEAF_PREFIX = b"\x00"
INNER_PREFIX = b"\x01"

MERKLE_KERNEL_MIN_LEAVES = 2048  # leaves from which the kernels hash
_PROOF_LEVEL_MIN = 64            # below: the recursive reference path
_LEAF_KERNEL_MAX_LEN = 118       # 0x00 + item + 9 bytes of padding fit
                                 # two SHA-256 blocks


def _sha(b: bytes) -> bytes:
    return hashlib.sha256(b).digest()


def leaf_hash(leaf: bytes) -> bytes:
    return _sha(LEAF_PREFIX + leaf)


def inner_hash(left: bytes, right: bytes) -> bytes:
    return _sha(INNER_PREFIX + left + right)


def _split_point(n: int) -> int:
    """Largest power of two strictly less than n (n >= 2)."""
    k = 1
    while k * 2 < n:
        k *= 2
    return k


def hash_from_byte_slices(items: list[bytes]) -> bytes:
    n = len(items)
    if n == 0:
        return _sha(b"")
    if n == 1:
        return leaf_hash(items[0])
    k = _split_point(n)
    return inner_hash(hash_from_byte_slices(items[:k]),
                      hash_from_byte_slices(items[k:]))


def hash_from_byte_slices_fast(items: list[bytes], device=None) -> bytes:
    """The root of :func:`hash_from_byte_slices`, routed by leaf count
    (module docstring); ``device`` is read only on the kernel route."""
    n = len(items)
    if n < _PROOF_LEVEL_MIN:
        return hash_from_byte_slices(items)
    if n < MERKLE_KERNEL_MIN_LEAVES:
        return _native.merkle_root(items)
    buf = _kernel_levels(items, _plan.resolve_devices(device)[0])
    return _s.words_to_bytes(buf[-1:].cpu().numpy())[0].tobytes()


# ------------------------------------------------------- level-order core
# The ancestor of leaf i at level l is node i >> l in every level
# (promotion keeps floor-halving indices), so aunt paths are index
# arithmetic over the levels: sibling (i >> l) ^ 1, absent exactly when
# it falls off the level's width.

def _level_widths(n: int) -> list[int]:
    widths = [n]
    while n > 1:
        n = (n + 1) // 2
        widths.append(n)
    return widths


def _levels_hashlib(items: list[bytes]) -> list[list[bytes]]:
    """Every tree level with hashlib, leaves first (the tests' plain
    version of the native tree)."""
    lv = [_sha(LEAF_PREFIX + it) for it in items]
    levels = [lv]
    while len(lv) > 1:
        m = len(lv) // 2
        nxt = [_sha(INNER_PREFIX + lv[2 * i] + lv[2 * i + 1])
               for i in range(m)]
        if len(lv) & 1:
            nxt.append(lv[-1])
        levels.append(nxt)
        lv = nxt
    return levels


def _leaf_blocks(items: list[bytes]):
    """Host padding of the leaf messages 0x00 || item: (blocks (n, NB, 16)
    uint32, active (n,) int32), NB = 1 or 2.  ``host_pad`` refuses a
    block count below any row's need, so every active count lies in
    [1, NB] before it is uploaded."""
    n = len(items)
    lens = np.fromiter(map(len, items), np.int64, n)
    maxlen = int(lens.max())
    msgs = np.zeros((n, maxlen + 1), np.uint8)
    flat = np.frombuffer(b"".join(items), np.uint8)
    starts = np.repeat(np.cumsum(lens) - lens, lens)
    msgs[np.repeat(np.arange(n), lens),
         np.arange(flat.size) - starts + 1] = flat
    return _s.host_pad(msgs, lens + 1, _s.max_blocks_for_len(maxlen + 1))


def _kernel_levels(items: list[bytes], dev: torch.device) -> torch.Tensor:
    """Every level of the tree as digest words in one (nodes, 8) int32
    tensor on ``dev``, leaves first, the root last, each level in its
    slice: one call for the leaves and the levels above them, or, for
    leaves hashed on the host, one tree call for the levels."""
    n = len(items)
    if max(map(len, items)) <= _LEAF_KERNEL_MAX_LEN:
        blocks, active = _leaf_blocks(items)
        return _s.merkle_tree_leaves(
            torch.from_numpy(blocks.view(np.int32)).to(dev),
            torch.from_numpy(active).to(dev))
    buf = torch.empty((_s.tree_rows(n), 8), dtype=torch.int32, device=dev)
    leaves = b"".join(_sha(LEAF_PREFIX + it) for it in items)
    words = _s.bytes_to_words(np.frombuffer(leaves, np.uint8).reshape(n, 32))
    buf[:n].copy_(torch.from_numpy(words.view(np.int32)))
    return _s.merkle_tree(buf, n)


def _levels_kernel(items: list[bytes], dev) -> list[list[bytes]]:
    raw = _s.words_to_bytes(_kernel_levels(items, dev).cpu().numpy())
    raw = raw.tobytes()
    levels, pos = [], 0
    for w in _level_widths(len(items)):
        end = pos + 32 * w
        levels.append([raw[i:i + 32] for i in range(pos, end, 32)])
        pos = end
    return levels


class Proof(NamedTuple):
    """Merkle inclusion proof (crypto/merkle/proof.go semantics); aunts
    bottom-up (deepest first)."""

    total: int
    index: int
    leaf_hash: bytes
    aunts: tuple[bytes, ...] = ()

    def compute_root(self) -> bytes | None:
        return _compute_from_aunts(self.index, self.total, self.leaf_hash,
                                   self.aunts)

    def verify(self, root: bytes, leaf: bytes) -> bool:
        if self.total < 0 or self.index < 0 or self.index >= self.total:
            return False
        if leaf_hash(leaf) != self.leaf_hash:
            return False
        computed = self.compute_root()
        return computed is not None and computed == root


def _compute_from_aunts(index: int, total: int, leaf: bytes,
                        aunts) -> bytes | None:
    if total == 0 or index >= total:
        return None
    if total == 1:
        return leaf if not aunts else None
    if not aunts:
        return None
    k = _split_point(total)
    if index < k:
        left = _compute_from_aunts(index, k, leaf, aunts[:-1])
        return None if left is None else inner_hash(left, aunts[-1])
    right = _compute_from_aunts(index - k, total - k, leaf, aunts[:-1])
    return None if right is None else inner_hash(aunts[-1], right)


def proofs_from_byte_slices_reference(items: list[bytes]
                                      ) -> tuple[bytes, list[Proof]]:
    """Recursive builder (crypto/merkle/proof.go shape): root and one
    inclusion proof per item.  The route below 64 leaves, and the oracle
    the level-order builder is held against."""
    total = len(items)
    leaves = [leaf_hash(it) for it in items]

    def build(lo: int, hi: int) -> tuple[bytes, dict[int, list[bytes]]]:
        n = hi - lo
        if n == 0:
            return _sha(b""), {}
        if n == 1:
            return leaves[lo], {lo: []}
        k = _split_point(n)
        lroot, lpaths = build(lo, lo + k)
        rroot, rpaths = build(lo + k, hi)
        paths = {}
        for i, p in lpaths.items():
            paths[i] = p + [rroot]
        for i, p in rpaths.items():
            paths[i] = p + [lroot]
        return inner_hash(lroot, rroot), paths

    root, paths = build(0, total)
    proofs = [Proof(total=total, index=i, leaf_hash=leaves[i],
                    aunts=tuple(paths[i])) for i in range(total)]
    return root, proofs


def _proofs_from_levels(levels: list[list[bytes]], total: int
                        ) -> tuple[bytes, list[Proof]]:
    """All aunt paths from the levels with no re-hashing: per level one
    vectorized sibling-index computation and one ``itemgetter`` gather.
    Aunts come out bottom-up (deepest first)."""
    root = levels[-1][0]
    if total == 1:
        return root, [Proof(1, 0, levels[0][0], ())]
    idx = np.arange(total)
    cols = []           # per level: that level's aunt of each leaf
    starts = []         # per level: first leaf whose sibling is promoted
    for lvl_i in range(len(levels) - 1):
        nodes = levels[lvl_i]
        w = len(nodes)
        run = 1 << lvl_i
        # the only missing sibling is that of the promoted odd tail
        # (ancestor w - 1 with (w - 1) ^ 1 == w): a run of trailing leaves
        start = ((w - 1) << lvl_i) if ((w - 1) ^ 1) >= w else total
        if run >= 32:
            # deep levels: the aunt is constant over runs of 2^l leaves
            col = []
            for j in range(w):
                sib = j ^ 1
                col.extend((nodes[sib] if sib < w else None,) * run)
            cols.append(col[:total])
        else:
            sib = (idx >> lvl_i) ^ 1
            np.minimum(sib, w - 1, out=sib)
            cols.append(itemgetter(*sib.tolist())(nodes))
        starts.append(start)
    min_start = min(starts, default=total)
    leaves = levels[0]
    nlv = len(cols)
    proofs = list(map(Proof._make,
                      zip(repeat(total, min_start), count(), leaves,
                          zip(*cols))))
    for i in range(min_start, total):    # leaves under a promoted node
        aunts = tuple(cols[k][i] for k in range(nlv) if i < starts[k])
        proofs.append(Proof(total, i, leaves[i], aunts))
    return root, proofs


def proofs_from_byte_slices(items: list[bytes], device=None
                            ) -> tuple[bytes, list[Proof]]:
    """Root and one inclusion proof per item, routed by leaf count as
    :func:`hash_from_byte_slices_fast`; equal to
    :func:`proofs_from_byte_slices_reference` on every route."""
    total = len(items)
    if total < _PROOF_LEVEL_MIN:
        return proofs_from_byte_slices_reference(items)
    if total < MERKLE_KERNEL_MIN_LEAVES:
        levels = _native.merkle_levels(items)
    else:
        levels = _levels_kernel(items, _plan.resolve_devices(device)[0])
    return _proofs_from_levels(levels, total)


# ------------------------------------------------------------- proof ops
# (crypto/merkle/proof_op.go and proof_value.go: each op turns its input
# into the next layer's expected value)

class ProofOp(NamedTuple):
    """A serialized proof step: type tag, key and opaque payload."""

    type: str
    key: bytes
    data: bytes


class ProofOpError(Exception):
    pass


def kv_leaf(key: bytes, value: bytes) -> bytes:
    """Leaf encoding of a provable key-value store: the key is bound into
    the leaf with the value's hash, so a prover cannot relabel a proven
    value under another key."""
    return len(key).to_bytes(4, "big") + key + _sha(value)


class ValueOp:
    """Proves (key, value) against a store root: the leaf is
    ``kv_leaf(key, value)``, then the merkle path in ``proof``."""

    TYPE = "simple:v"

    def __init__(self, key: bytes, proof: Proof):
        self.key = key
        self.proof = proof

    def run(self, args: list[bytes]) -> list[bytes]:
        if len(args) != 1:
            raise ProofOpError(f"ValueOp wants 1 arg, got {len(args)}")
        if leaf_hash(kv_leaf(self.key, args[0])) != self.proof.leaf_hash:
            raise ProofOpError("key/value does not match proof leaf")
        root = self.proof.compute_root()
        if root is None:
            raise ProofOpError("invalid merkle path")
        return [root]

    def proof_op(self) -> ProofOp:
        from ..types import _msgpack

        return ProofOp(self.TYPE, self.key, _msgpack.packb(
            {"t": self.proof.total, "i": self.proof.index,
             "l": self.proof.leaf_hash, "a": self.proof.aunts}))

    @classmethod
    def decode(cls, op: ProofOp) -> "ValueOp":
        from ..types import _msgpack

        d = _msgpack.unpackb(op.data)
        return cls(op.key, Proof(d["t"], d["i"], d["l"], tuple(d["a"])))
