"""SHA-512 over host-padded blocks: the host packer and the plain version.

Counterpart of ``cometbft_tpu/ops/sha512.py``.  ``host_pad`` and
``max_blocks_for_len`` are the port's own copies of the JAX package's
numpy packers, so both packages hash the same ``(B, NB, 32)`` big-endian
32-bit words.  ``sha512_blocks`` is the plain PyTorch version of the
digest; the CUDA kernels compute it with native 64-bit words
(``csrc/ed25519.cuh:sha512_lane``).  Here each 64-bit word is a pair of
int64 tensors holding its high and low 32 bits, so every addition is
exact and no signed shift ever overflows.
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


def _add(*xs):
    hi = sum(x[0] for x in xs)
    lo = sum(x[1] for x in xs)
    hi = hi + (lo >> 32)
    return hi & _M32, lo & _M32


def _ror(x, n: int):
    hi, lo = x
    if n >= 32:
        hi, lo, n = lo, hi, n - 32
    if n == 0:
        return hi, lo
    return (((hi >> n) | (lo << (32 - n))) & _M32,
            ((lo >> n) | (hi << (32 - n))) & _M32)


def _shr(x, n: int):
    hi, lo = x
    return hi >> n, ((lo >> n) | (hi << (32 - n))) & _M32


def _xor(*xs):
    hi, lo = xs[0]
    for x in xs[1:]:
        hi, lo = hi ^ x[0], lo ^ x[1]
    return hi, lo


def _compress(state, w16):
    """One compression; state and w16 are lists of (hi, lo) pairs."""
    w = list(w16)
    for t in range(16, 80):
        s0 = _xor(_ror(w[t - 15], 1), _ror(w[t - 15], 8), _shr(w[t - 15], 7))
        s1 = _xor(_ror(w[t - 2], 19), _ror(w[t - 2], 61), _shr(w[t - 2], 6))
        w.append(_add(w[t - 16], s0, w[t - 7], s1))
    a, b, c, d, e, f, g, h = state
    for t in range(80):
        k = (K64[t] >> 32, K64[t] & _M32)
        ch = ((e[0] & f[0]) ^ (~e[0] & _M32 & g[0]),
              (e[1] & f[1]) ^ (~e[1] & _M32 & g[1]))
        maj = ((a[0] & b[0]) ^ (a[0] & c[0]) ^ (b[0] & c[0]),
               (a[1] & b[1]) ^ (a[1] & c[1]) ^ (b[1] & c[1]))
        t1 = _add(h, _xor(_ror(e, 14), _ror(e, 18), _ror(e, 41)), ch, k, w[t])
        t2 = _add(_xor(_ror(a, 28), _ror(a, 34), _ror(a, 39)), maj)
        h, g, f, e, d, c, b, a = g, f, e, _add(d, t1), c, b, a, _add(t1, t2)
    return [_add(s, n) for s, n in zip(state, (a, b, c, d, e, f, g, h))]


def sha512_blocks(blocks: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """Plain batched SHA-512.

    blocks: (B, NB, 32) big-endian 32-bit words (any integer dtype; int32
    holds the uint32 bit pattern); active: (B,) real blocks per lane, the
    rest masked.  Returns the digests as (B, 64) int64 bytes."""
    words = blocks.to(torch.int64) & _M32
    act = active.to(torch.int64)
    bsz, nb = words.shape[0], words.shape[1]
    state = [(torch.full((bsz,), v >> 32, dtype=torch.int64,
                         device=words.device),
              torch.full((bsz,), v & _M32, dtype=torch.int64,
                         device=words.device)) for v in IV64]
    for j in range(nb):
        w16 = [(words[:, j, 2 * i], words[:, j, 2 * i + 1])
               for i in range(16)]
        new = _compress(state, w16)
        live = j < act
        state = [(torch.where(live, n[0], s[0]), torch.where(live, n[1], s[1]))
                 for s, n in zip(state, new)]
    out = []
    for hi, lo in state:
        for word in (hi, lo):
            for sh in (24, 16, 8, 0):
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
