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

:class:`TreeCache` keeps every level of one tree (built on the same
routes, ``device`` read only at 2,048 leaves or more) and gathers
inclusion proofs for any leaf indexes from them with no re-hashing: the
light-serving tier's per-block proof cache (``light/serve.py``).

For provable key-value stores (the kvstore app's app hash): :func:`kv_leaf`
binds the key into the leaf, and :class:`ValueOp` proves a (key, value)
against a root (``crypto/merkle/proof_value.go``); its serialized
:class:`ProofOp` is the JAX package's, byte for byte.
:class:`ProofOperators` decodes a chain of serialized ops through the
decoders that :func:`register_proof_op` registers and verifies a value
at a key path against a root (``crypto/merkle/proof_op.go``).
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
           "TreeCache", "ProofOp", "ProofOpError", "kv_leaf", "ValueOp",
           "register_proof_op", "ProofOperators"]

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


def _levels(items: list[bytes], device) -> list[list[bytes]]:
    """Every level of a tree of one leaf or more, leaves first, routed
    by leaf count (module docstring); ``device`` is read only on the
    kernel route."""
    n = len(items)
    if n < _PROOF_LEVEL_MIN:
        return _levels_hashlib(items)
    if n < MERKLE_KERNEL_MIN_LEAVES:
        return _native.merkle_levels(items)
    return _levels_kernel(items, _plan.resolve_devices(device)[0])


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


def _aunts(levels: list[list[bytes]], index: int) -> tuple[bytes, ...]:
    """Aunts of leaf ``index``, bottom-up: its ancestor at level l is node
    index >> l, whose sibling (index >> l) ^ 1 is absent exactly where
    it falls off the level's width (a promoted odd tail)."""
    return tuple(nodes[sib] for lvl_i, nodes in enumerate(levels[:-1])
                 if (sib := (index >> lvl_i) ^ 1) < len(nodes))


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
    proofs = list(map(Proof._make,
                      zip(repeat(total, min_start), count(), leaves,
                          zip(*cols))))
    for i in range(min_start, total):    # leaves under a promoted node
        proofs.append(Proof(total, i, leaves[i], _aunts(levels, i)))
    return root, proofs


def proofs_from_byte_slices(items: list[bytes], device=None
                            ) -> tuple[bytes, list[Proof]]:
    """Root and one inclusion proof per item, routed by leaf count as
    :func:`hash_from_byte_slices_fast`; equal to
    :func:`proofs_from_byte_slices_reference` on every route."""
    total = len(items)
    if total < _PROOF_LEVEL_MIN:
        return proofs_from_byte_slices_reference(items)
    return _proofs_from_levels(_levels(items, device), total)


class TreeCache:
    """Every level of one tree, built once, then inclusion proofs for any
    leaf indexes by index arithmetic over the levels, with no re-hashing
    (the light-serving seam: a block's tx or validator tree is built on
    the first proof request, and every later request is a gather).
    Proofs equal :func:`proofs_from_byte_slices_reference`'s (aunts
    bottom-up, promoted odd-tail nodes skipped)."""

    __slots__ = ("levels", "total")

    def __init__(self, levels: list[list[bytes]], total: int):
        self.levels = levels
        self.total = total

    @classmethod
    def build(cls, items: list[bytes], device=None) -> "TreeCache":
        """The levels of ``items``' tree, routed by leaf count as
        :func:`proofs_from_byte_slices`: hashlib below 64 leaves, the
        native tree up to ``MERKLE_KERNEL_MIN_LEAVES``, from there one
        ``merkle_tree_leaves`` call on ``device`` (None: the plan's first
        device, raising without a card; ``"cpu"``: the plain version)."""
        if not items:
            return cls([[_sha(b"")]], 0)
        return cls(_levels(items, device), len(items))

    @property
    def root(self) -> bytes:
        return self.levels[-1][0]

    def nbytes(self) -> int:
        """Retained size: 32 bytes a node over every level."""
        return 32 * sum(len(lv) for lv in self.levels)

    def proof(self, index: int) -> Proof:
        """Inclusion proof of leaf ``index`` (IndexError out of range)."""
        total = self.total
        if not 0 <= index < total:
            raise IndexError(f"leaf {index} out of range (total {total})")
        return Proof(total, index, self.levels[0][index],
                     _aunts(self.levels, index))

    def proofs(self, indexes) -> list[Proof]:
        return [self.proof(i) for i in indexes]


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


_OP_DECODERS = {ValueOp.TYPE: ValueOp.decode}


def register_proof_op(type_: str, decoder) -> None:
    """proof_op.go ProofRuntime.RegisterOpDecoder."""
    _OP_DECODERS[type_] = decoder


class ProofOperators:
    """An ordered op chain: :meth:`verify` runs each op over the previous
    op's output, consuming key path segments right to left
    (proof_op.go ProofOperators.Verify)."""

    def __init__(self, ops: list):
        self.ops = ops

    @classmethod
    def decode(cls, ops: list[ProofOp]) -> "ProofOperators":
        decoded = []
        for op in ops:
            dec = _OP_DECODERS.get(op.type)
            if dec is None:
                raise ProofOpError(f"unregistered proof op {op.type!r}")
            decoded.append(dec(op))
        return cls(decoded)

    def verify(self, root: bytes, keypath: list[bytes],
               value: bytes) -> None:
        """Raises ProofOpError unless the chain proves ``value`` at
        ``keypath`` under ``root``."""
        if not self.ops:
            raise ProofOpError("empty proof op chain")
        args = [value]
        keys = list(keypath)
        for op in self.ops:
            if getattr(op, "key", b""):
                if not keys:
                    raise ProofOpError("keypath exhausted")
                if keys[-1] != op.key:
                    raise ProofOpError(
                        f"key mismatch: {keys[-1]!r} != {op.key!r}")
                keys.pop()
            args = op.run(args)
        if keys:
            raise ProofOpError(f"keypath not fully consumed: {keys!r}")
        if args != [root]:
            raise ProofOpError("computed root does not match")
