"""SHA-512 over host-padded blocks: the host packer and the plain version.

Counterpart of ``cometbft_tpu/ops/sha512.py``.  ``host_pad`` and
``max_blocks_for_len`` are the port's own copies of the JAX package's
numpy packers, so both packages hash the same ``(B, NB, 32)`` big-endian
32-bit words.  ``sha512_blocks`` is the plain PyTorch version of the
digest; the CUDA kernels compute it with native 64-bit words
(``csrc/ed25519.cuh:sha512_lane``), and so does the plain version: each
64-bit word is an int64 tensor holding its bit pattern, additions wrap
mod 2^64 as two's-complement integers do (on the CPU and on the card),
a left shift drops the bits past 63 and a right shift is masked to a
logical one.  A one-lane check of the plain versions is mostly operator
calls, and a word in one tensor takes half the calls of a word in two
halves.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["host_pad", "max_blocks_for_len", "sha512_blocks", "sha512_scalar",
           "K64", "IV64"]


def _primes(n: int):
    ps, c = [], 2
    while len(ps) < n:
        if all(c % q for q in ps if q * q <= c):
            ps.append(c)
        c += 1
    return ps


def _icbrt(x: int) -> int:
    """floor(cbrt(x)) by Newton's method on integers, from a power of two
    at or above the root (a float guess of a 67-bit root is off by
    millions and took seconds to walk one unit at a time)."""
    if x < 2:
        return x
    r = 1 << -(-x.bit_length() // 3)
    while True:
        y = (2 * r + x // (r * r)) // 3
        if y >= r:
            return r
        r = y


_M64 = (1 << 64) - 1
K64 = [_icbrt(p << 192) & _M64 for p in _primes(80)]
IV64 = [math.isqrt(p << 128) & _M64 for p in _primes(8)]
_M32 = 0xFFFFFFFF


def max_blocks_for_len(msg_len: int) -> int:
    """Blocks needed for a message of msg_len bytes (incl. 17-byte padding)."""
    return (msg_len + 17 + 127) // 128


def host_pad(msgs: np.ndarray, lens: np.ndarray, nb: int):
    """Host-side SHA-512 padding into fixed (B, nb, 32) uint32 blocks.

    msgs: (B, L) uint8 (rows zero-filled past their length; L may exceed
    nb * 128 where the rows' stride is wider than their lengths);
    lens: (B,) actual byte lengths;  nb: block count >= per-row need.
    Returns (blocks (B, nb, 32) uint32, active (B,) int32).
    """
    msgs = np.asarray(msgs, dtype=np.uint8)
    lens = np.asarray(lens, dtype=np.int64)
    bsz, pad_len = msgs.shape[0], nb * 128
    if int((lens + 17).max(initial=0)) > pad_len:
        raise ValueError("block count too small for the longest message")
    buf = np.zeros((bsz, pad_len), np.uint8)
    width = min(msgs.shape[1], pad_len)
    buf[:, :width] = msgs[:, :width]
    col = np.arange(pad_len)
    buf[col[None, :] >= lens[:, None]] = 0
    buf[np.arange(bsz), lens] = 0x80
    active = ((lens + 17 + 127) // 128).astype(np.int64)
    bitlen = lens * 8
    for k in range(8):
        buf[np.arange(bsz), active * 128 - 1 - k] = (bitlen >> (8 * k)) & 255
    words = buf.reshape(bsz, nb, 32, 4)
    blocks = ((words[..., 0].astype(np.uint32) << 24)
              | (words[..., 1].astype(np.uint32) << 16)
              | (words[..., 2].astype(np.uint32) << 8)
              | words[..., 3].astype(np.uint32))
    return blocks, active.astype(np.int32)


def _s64(v: int) -> int:
    """An unsigned 64-bit value as the int64 with its bit pattern."""
    return v - (1 << 64) if v >= 1 << 63 else v


def _ror(x, n: int):
    return ((x >> n) & ((1 << (64 - n)) - 1)) | (x << (64 - n))


def _shr(x, n: int):
    return (x >> n) & ((1 << (64 - n)) - 1)


def _compress(state, w16, k):
    """One compression; state and w16 are lists of (B,) int64 words, k
    the round constants as an int64 tensor."""
    w = list(w16)
    for t in range(16, 80):
        a, b = w[t - 15], w[t - 2]
        s0 = _ror(a, 1) ^ _ror(a, 8) ^ _shr(a, 7)
        s1 = _ror(b, 19) ^ _ror(b, 61) ^ _shr(b, 6)
        w.append(w[t - 16] + s0 + w[t - 7] + s1)
    a, b, c, d, e, f, g, h = state
    for t in range(80):
        ch = (e & f) ^ (~e & g)
        maj = (a & b) ^ (a & c) ^ (b & c)
        t1 = h + (_ror(e, 14) ^ _ror(e, 18) ^ _ror(e, 41)) + ch + k[t] + w[t]
        t2 = (_ror(a, 28) ^ _ror(a, 34) ^ _ror(a, 39)) + maj
        h, g, f, e, d, c, b, a = g, f, e, d + t1, c, b, a, t1 + t2
    return [s + n for s, n in zip(state, (a, b, c, d, e, f, g, h))]


_K_T: dict = {}


def sha512_blocks(blocks: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """Plain batched SHA-512.

    blocks: (B, NB, 32) big-endian 32-bit words (any integer dtype; int32
    holds the uint32 bit pattern); active: (B,) real blocks per lane, the
    rest masked.  Returns the digests as (B, 64) int64 bytes."""
    words = blocks.to(torch.int64) & _M32
    w64 = (words[..., 0::2] << 32) | words[..., 1::2]       # (B, NB, 16)
    act = active.to(torch.int64)
    bsz, nb = w64.shape[0], w64.shape[1]
    dev = w64.device
    k = _K_T.get(dev)
    if k is None:
        k = _K_T[dev] = torch.tensor([_s64(v) for v in K64],
                                     dtype=torch.int64, device=dev)
    state = [torch.full((bsz,), _s64(v), dtype=torch.int64, device=dev)
             for v in IV64]
    for j in range(nb):
        new = _compress(state, w64[:, j].T.unbind(0), k)
        live = j < act
        state = [torch.where(live, n, s) for s, n in zip(state, new)]
    out = []
    for word in state:
        for sh in range(56, -8, -8):
            out.append((word >> sh) & 255)
    return torch.stack(out, 1)


def _sha512_scalar_plain(blocks, active):
    from . import scalar

    return scalar.limbs_to_bytes32(scalar.reduce512(
        sha512_blocks(blocks, active))).to(torch.uint8)


def sha512_scalar(blocks: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """h = SHA-512(R || A || M) mod L per lane, as (B, 32) uint8 bytes.

    blocks (B, NB, 32) int32, active (B,) int32.  Replaces the hash and
    ``reduce512`` stage of the TPU verify programs
    (``cometbft_tpu/ops/sha512.py:165``, ``ops/scalar.py:67``); CUDA
    kernel ``sha512_scalar``."""
    from . import _build

    b = blocks.shape[0]
    _build.check_arg(blocks, "blocks", torch.int32, (b, None, 32))
    _build.check_arg(active, "active", torch.int32, (b,))
    _build.check_index((active, blocks.shape[1] + 1, "active"))
    return _sha512_scalar(blocks, active)


def _sha512_scalar(blocks, active):
    """:func:`sha512_scalar` on arguments already checked."""
    from . import _build

    b = blocks.shape[0]
    if blocks.device.type == "cpu":
        _build.PLAIN_CALLS["sha512_scalar"] += 1
        return _sha512_scalar_plain(blocks, active)
    h = torch.empty((b, 32), dtype=torch.uint8, device=blocks.device)
    if b:
        _build.launch("sha512_scalar", blocks, blocks.data_ptr(),
                      active.data_ptr(), b, blocks.shape[1], h.data_ptr())
    return h
