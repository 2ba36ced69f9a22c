"""Batched SHA-256 for merkle trees: host packers, kernel wrappers and
plain versions.

Counterpart of ``cometbft_tpu/ops/sha256.py``.  ``K``, ``IV``,
``host_pad``, ``max_blocks_for_len``, ``words_to_bytes`` and
``bytes_to_words`` are the port's own copies of the JAX package's numpy
packers, so both packages hash the same ``(B, NB, 16)`` big-endian
32-bit words.  Two functions, each a wrapper that dispatches on the
device of its tensors (plain PyTorch version on the CPU, hand-written
kernel on CUDA, no fallback between the two):

- :func:`sha256_leaf_words`: digest words of host-padded leaves with
  per-lane active-block counts (kernel ``sha256_leaves``,
  ``csrc/sha256.cu``); :func:`sha256_blocks` is the same as digest
  bytes, the JAX package's boundary type;
- :func:`merkle_inner_level`: one RFC-6962 tree level,
  ``SHA-256(0x01 || left || right)`` per parent, in digest words (kernel
  ``merkle_level``).  :func:`merkle_level` is the same kernel over a
  whole level of children, the odd tail node promoted unchanged;
- :func:`merkle_tree`: every level of a tree above its leaves, in one
  C call (kernel ``merkle_tree``: blocks that each build a subtree in
  shared memory), into the one level buffer of the merkle tree
  (``crypto/merkle.py``); its plain version is the loop of
  :func:`merkle_level`'s;
- :func:`merkle_tree_leaves`: the leaves' digests and every level above
  them in one C call (kernel ``merkle_tree_leaves``: the first launch
  hashes a block's run of leaves straight into the shared memory its
  subtree is built in); its plain version is the leaves' plain version,
  then the tree's.  The merkle tree's route from 2,048 leaves.

The plain versions hold each 32-bit word in int64 masked with
``0xFFFFFFFF`` (PyTorch's uint32 lacks shifts and rotates on the CPU in
several versions); the kernels use native ``uint32_t``.  Hash blocks and
digest words cross the wrappers as int32 tensors holding the uint32 bit
patterns.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import _build

__all__ = ["K", "IV", "host_pad", "max_blocks_for_len", "words_to_bytes",
           "bytes_to_words", "sha256_blocks", "sha256_leaf_words",
           "merkle_inner_level", "merkle_level", "tree_rows", "merkle_tree",
           "merkle_tree_leaves"]


def _primes(n: int):
    ps, c = [], 2
    while len(ps) < n:
        if all(c % q for q in ps if q * q <= c):
            ps.append(c)
        c += 1
    return ps


def _icbrt(x: int) -> int:
    r = int(round(x ** (1 / 3)))
    while r * r * r > x:
        r -= 1
    while (r + 1) ** 3 <= x:
        r += 1
    return r


_M32 = (1 << 32) - 1
K = np.array([_icbrt(p << 96) & _M32 for p in _primes(64)], dtype=np.uint32)
IV = np.array([math.isqrt(p << 64) & _M32 for p in _primes(8)],
              dtype=np.uint32)
# the second block of every 65-byte inner message: byte 65 of the
# message (byte 1 of this block) is the 0x80 terminator, the last word
# the bit length 520; word 0 also carries the last byte of ``right``
INNER_BIT_LEN = 65 * 8


def max_blocks_for_len(msg_len: int) -> int:
    """Blocks needed for a message of msg_len bytes (incl. 9-byte padding)."""
    return (msg_len + 9 + 63) // 64


def host_pad(msgs: np.ndarray, lens: np.ndarray, nb: int):
    """Host-side SHA-256 padding into fixed (B, nb, 16) uint32 blocks.

    msgs: (B, L) uint8 (rows zero-filled past their length);
    lens: (B,) actual byte lengths;  nb: block count >= per-row need.
    Returns (blocks (B, nb, 16) uint32, active (B,) int32).
    """
    msgs = np.asarray(msgs, dtype=np.uint8)
    lens = np.asarray(lens, dtype=np.int64)
    bsz, pad_len = msgs.shape[0], nb * 64
    if int((lens + 9).max(initial=0)) > pad_len:
        raise ValueError("block count too small for the longest message")
    buf = np.zeros((bsz, pad_len), np.uint8)
    buf[:, :msgs.shape[1]] = msgs
    col = np.arange(pad_len)
    buf[col[None, :] >= lens[:, None]] = 0
    buf[np.arange(bsz), lens] = 0x80
    active = ((lens + 9 + 63) // 64).astype(np.int64)
    bitlen = lens * 8
    for k in range(8):
        buf[np.arange(bsz), active * 64 - 1 - k] = (bitlen >> (8 * k)) & 255
    words = buf.reshape(bsz, nb, 16, 4)
    blocks = ((words[..., 0].astype(np.uint32) << 24)
              | (words[..., 1].astype(np.uint32) << 16)
              | (words[..., 2].astype(np.uint32) << 8)
              | words[..., 3].astype(np.uint32))
    return blocks, active.astype(np.int32)


def words_to_bytes(words: np.ndarray) -> np.ndarray:
    """(…, 8) uint32 big-endian digest words -> (…, 32) uint8 bytes."""
    w = np.ascontiguousarray(np.asarray(words).astype(np.uint32, copy=False))
    return w.astype(">u4").view(np.uint8).reshape(w.shape[:-1] + (32,))


def bytes_to_words(b: np.ndarray) -> np.ndarray:
    """(…, 32) uint8 digest bytes -> (…, 8) uint32 big-endian words."""
    a = np.ascontiguousarray(np.asarray(b, np.uint8))
    return a.view(">u4").astype(np.uint32).reshape(a.shape[:-1] + (8,))


# ------------------------------------------------------------ plain versions

def _ror(x, n: int):
    return ((x >> n) | (x << (32 - n))) & _M32


def _compress(state, w16):
    """One compression; ``state`` 8 and ``w16`` 16 int64 tensors of 32-bit
    words.  Returns the new state (the feed-forward added)."""
    w = list(w16)
    for t in range(16, 64):
        s0 = _ror(w[t - 15], 7) ^ _ror(w[t - 15], 18) ^ (w[t - 15] >> 3)
        s1 = _ror(w[t - 2], 17) ^ _ror(w[t - 2], 19) ^ (w[t - 2] >> 10)
        w.append((w[t - 16] + s0 + w[t - 7] + s1) & _M32)
    a, b, c, d, e, f, g, h = state
    for t in range(64):
        s1 = _ror(e, 6) ^ _ror(e, 11) ^ _ror(e, 25)
        ch = (e & f) ^ (~e & _M32 & g)
        t1 = h + s1 + ch + int(K[t]) + w[t]
        s0 = _ror(a, 2) ^ _ror(a, 13) ^ _ror(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        h, g, f, e, d, c, b, a = (g, f, e, (d + t1) & _M32, c, b, a,
                                  (t1 + s0 + maj) & _M32)
    return [(s + n) & _M32 for s, n in zip(state, (a, b, c, d, e, f, g, h))]


def _iv_state(bsz: int, device):
    return [torch.full((bsz,), int(v), dtype=torch.int64, device=device)
            for v in IV]


def _leaf_state_plain(blocks, active):
    """(B, 8) int64 digest words of host-padded blocks; block j of lane b
    counts only where j < active[b] (the JAX package's mask)."""
    words = blocks.to(torch.int64) & _M32
    act = active.to(torch.int64)
    bsz, nb = words.shape[0], words.shape[1]
    state = _iv_state(bsz, words.device)
    for j in range(nb):
        new = _compress(state, [words[:, j, i] for i in range(16)])
        live = j < act
        state = [torch.where(live, n, s) for s, n in zip(state, new)]
    return torch.stack(state, 1)


def _state_to_bytes(state):
    """(B, 8) int64 words -> (B, 32) uint8 big-endian digest bytes."""
    shifts = torch.tensor([24, 16, 8, 0], dtype=torch.int64,
                          device=state.device)
    return ((state[:, :, None] >> shifts) & 255).reshape(
        state.shape[0], 32).to(torch.uint8)


def _as_int32(words):
    """int64 words in [0, 2^32) -> int32 tensors of the same bits."""
    return torch.where(words >= 1 << 31, words - (1 << 32),
                       words).to(torch.int32)


def _inner_plain(left, right):
    """(B, 8) int64 parent words of (B, 8) int64 children: the two blocks
    of 0x01 || left || right, assembled by shifts as in the JAX package."""
    b0 = [0x01000000 | (left[:, 0] >> 8)]
    b0 += [((left[:, i - 1] & 0xFF) << 24) | (left[:, i] >> 8)
           for i in range(1, 8)]
    b0.append(((left[:, 7] & 0xFF) << 24) | (right[:, 0] >> 8))
    b0 += [((right[:, i - 1] & 0xFF) << 24) | (right[:, i] >> 8)
           for i in range(1, 8)]
    zero = torch.zeros_like(left[:, 0])
    b1 = [((right[:, 7] & 0xFF) << 24) | 0x00800000] + [zero] * 14
    b1.append(zero + INNER_BIT_LEN)
    state = _compress(_iv_state(left.shape[0], left.device), b0)
    return torch.stack(_compress(state, b1), 1)


def _merkle_level_plain(children):
    """(ceil(n/2), 8) int32 parent level of (n, 8) int32 children."""
    n = children.shape[0]
    words = children.to(torch.int64) & _M32
    m = n // 2
    parents = _as_int32(_inner_plain(words[0:2 * m:2], words[1:2 * m:2]))
    if n & 1:
        parents = torch.cat([parents, children[n - 1:]])
    return parents


def _merkle_tree_plain(levels, n):
    """Every level above the ``n`` leaves at the head of ``levels``,
    written into its slices: the level loop."""
    start, w = 0, n
    while w > 1:
        p = (w + 1) // 2
        levels[start + w:start + w + p] = _merkle_level_plain(
            levels[start:start + w])
        start, w = start + w, p
    return levels


# ------------------------------------------------------------------ wrappers

def _check_blocks(blocks, active) -> None:
    b = blocks.shape[0]
    _build.check_arg(blocks, "blocks", torch.int32, (b, None, 16))
    _build.check_arg(active, "active", torch.int32, (b,))
    if blocks.device != active.device:
        raise ValueError("blocks and active lie on different devices")


def _out_arg(out, b: int, device):
    """A caller's (b, 8) int32 output tensor, checked, or a new one."""
    if out is None:
        return torch.empty((b, 8), dtype=torch.int32, device=device)
    _build.check_arg(out, "out", torch.int32, (b, 8))
    if out.device != device:
        raise ValueError("out lies on another device than the input")
    return out


def sha256_leaf_words(blocks: torch.Tensor, active: torch.Tensor,
                      out: torch.Tensor | None = None) -> torch.Tensor:
    """SHA-256 of host-padded leaves as (B, 8) int32 big-endian digest
    words, the form :func:`merkle_level` takes, into ``out`` when given (a
    contiguous (B, 8) int32 tensor; the tree passes a slice of its level
    buffer).

    blocks (B, NB, 16) int32 big-endian words (``host_pad`` output viewed
    as int32), active (B,) int32 real blocks per lane: block j counts
    where j < active, so a count outside [0, NB] acts as the nearest end,
    as in the JAX package.  CUDA kernel ``sha256_leaves``."""
    _check_blocks(blocks, active)
    b, nb = blocks.shape[0], blocks.shape[1]
    out = _out_arg(out, b, blocks.device)
    if blocks.device.type == "cpu":
        _build.PLAIN_CALLS["sha256_leaves"] += 1
        return out.copy_(_as_int32(_leaf_state_plain(blocks, active)))
    if b:
        _build.launch("sha256_leaves", blocks, blocks.data_ptr(),
                      active.data_ptr(), b, nb, out.data_ptr())
    return out


def sha256_blocks(blocks: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """:func:`sha256_leaf_words` at the JAX package's boundary: (B, 32)
    uint8 digest bytes.  Replaces ``cometbft_tpu/ops/sha256.py:115``."""
    words = sha256_leaf_words(blocks, active)
    return _state_to_bytes(words.to(torch.int64) & _M32)


def merkle_level(children: torch.Tensor, out: torch.Tensor | None = None
                 ) -> torch.Tensor:
    """One merkle level: (n, 8) int32 child digest words -> (ceil(n/2), 8)
    parents, ``SHA-256(0x01 || children[2i] || children[2i+1])``, with an
    odd tail child promoted unchanged.  ``out``, when given, is a
    contiguous (ceil(n/2), 8) int32 tensor the kernel writes into (the
    tree keeps all its levels in one buffer).  CUDA kernel
    ``merkle_level``."""
    n = children.shape[0]
    _build.check_arg(children, "children", torch.int32, (n, 8))
    out = _out_arg(out, (n + 1) // 2, children.device)
    if children.device.type == "cpu":
        _build.PLAIN_CALLS["merkle_level"] += 1
        return out.copy_(_merkle_level_plain(children))
    if n:
        _build.launch("merkle_level", children, children.data_ptr(), n,
                      out.data_ptr())
    return out


def tree_rows(n: int) -> int:
    """Rows of the level buffer of a tree of ``n`` leaves: the sum of its
    level widths (the leaves, then ceil-halvings down to the root)."""
    rows, w = n, n
    while w > 1:
        w = (w + 1) // 2
        rows += w
    return rows


def merkle_tree(levels: torch.Tensor, n: int) -> torch.Tensor:
    """Every level of a merkle tree of ``n`` leaves: ``levels`` is a
    contiguous (``tree_rows(n)``, 8) int32 tensor whose first ``n`` rows
    hold the leaves' digest words; each level above them is written into
    the rows after the one below (parents
    ``SHA-256(0x01 || children[2i] || children[2i+1])``, an odd tail child
    promoted unchanged), the root last.  Returns ``levels``.  CUDA kernel
    ``merkle_tree``, one C call of two launches up to 65,536 leaves."""
    _build.check_arg(levels, "levels", torch.int32, (tree_rows(n), 8))
    if levels.device.type == "cpu":
        _build.PLAIN_CALLS["merkle_tree"] += 1
        return _merkle_tree_plain(levels, n)
    if n > 1:
        _build.launch("merkle_tree", levels, levels.data_ptr(), n)
    return levels


def merkle_tree_leaves(blocks: torch.Tensor, active: torch.Tensor,
                       levels: torch.Tensor | None = None) -> torch.Tensor:
    """Every level of the merkle tree over host-padded leaves, the leaves'
    digest words too: :func:`sha256_leaf_words` into the first ``B`` rows
    of ``levels``, then :func:`merkle_tree` (arguments as theirs;
    ``levels``, when given, a contiguous (``tree_rows(B)``, 8) int32
    tensor on the leaves' device, else a new one).  Returns ``levels``.
    CUDA kernel ``merkle_tree_leaves``: one C call, whose first launch
    hashes the leaves into the shared memory its subtrees are built in
    (two launches up to 65,536 leaves)."""
    _check_blocks(blocks, active)
    b, nb = blocks.shape[0], blocks.shape[1]
    rows = tree_rows(b)
    if levels is None:
        levels = torch.empty((rows, 8), dtype=torch.int32,
                             device=blocks.device)
    _build.check_arg(levels, "levels", torch.int32, (rows, 8))
    if levels.device != blocks.device:
        raise ValueError("levels lies on another device than the leaves")
    if blocks.device.type == "cpu":
        _build.PLAIN_CALLS["merkle_tree_leaves"] += 1
        levels[:b] = _as_int32(_leaf_state_plain(blocks, active))
        return _merkle_tree_plain(levels, b)
    if b:
        _build.launch("merkle_tree_leaves", blocks, blocks.data_ptr(),
                      active.data_ptr(), nb, b, levels.data_ptr())
    return levels


def merkle_inner_level(left: torch.Tensor,
                       right: torch.Tensor) -> torch.Tensor:
    """One merkle tree level at the JAX package's boundary: left/right
    (B, 8) int32 child digest words -> (B, 8) parent words.  Replaces
    ``cometbft_tpu/ops/sha256.py:135``; the children are interleaved into
    one level and go through :func:`merkle_level`."""
    b = left.shape[0]
    _build.check_arg(left, "left", torch.int32, (b, 8))
    _build.check_arg(right, "right", torch.int32, (b, 8))
    return merkle_level(torch.stack([left, right], 1).reshape(2 * b, 8))
