"""Masked sum of BLS12-381 G1 points: host packers, the kernel wrapper and
its plain version.

Counterpart of ``cometbft_tpu/ops/blsg1.py``.  ``NLIMB``, ``LB``,
``P_INT``, ``limbs_from_int``, ``int_from_limbs``, ``limbs_from_xy`` and
``xy_from_projective`` are the port's own copies of the JAX package's
boundary helpers: points cross as ``(R, 2, 32)`` int32 canonical affine
12-bit limbs, the mask as ``(R,)`` int32 (nonzero selects the row), the
sum as ``(3, 32)`` int32 canonical projective 12-bit limbs, and the host
inverts Z once.

The arithmetic is the JAX package's, formula for formula: Montgomery
multiplication with R = 2^384, the complete projective addition for
a = 0 short-Weierstrass curves (Renes-Costello-Batina 2015, Algorithm 7,
b3 = 12), deselected rows as the identity (0 : R mod p : 0), rows padded
with identity rows to a power of two, and a halving tree that adds row
``i + h`` to row ``i`` at each level.  With the same order and canonical
field values at every step, the projective output equals the JAX
package's exactly.

- :func:`aggregate_g1_masked` takes the JAX boundary;
- :func:`g1_masked_sum` takes the kernel's own table layout, ``(R, 2,
  12)`` int32 words (little-endian 32-bit words of the canonical
  coordinates, :func:`words_from_limbs`), which the per-valset device
  table of ``crypto/blsagg.py`` keeps on the card so that a call uploads
  only the mask.  On CUDA tensors it runs ``csrc/blsg1.cu`` (one C
  call: blocks of at most ``FOLD_ROWS`` rows fold residue classes of the
  table in shared memory, two launches up to 2^16 rows); on CPU tensors
  the plain version below.

The plain version holds field elements as 24 limbs of 16 bits in int64
(products of two limbs and their column sums stay far below 2^63); the
kernel uses 12 words of 32 bits.  Both are fully reduced after every
operation, so both give the same canonical values.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build

__all__ = ["NLIMB", "LB", "P_INT", "limbs_from_int", "int_from_limbs",
           "limbs_from_xy", "xy_from_projective", "words_from_limbs",
           "aggregate_g1_masked", "g1_masked_sum", "NWORD", "R2_INT",
           "ONE_M_INT", "B3_M_INT", "N0_WORD"]

NLIMB = 32                       # 12-bit limbs at the boundary
LB = 12
MASK = (1 << LB) - 1
NWORD = 12                       # 32-bit words in the kernel
FOLD_ROWS = 256                  # rows a block of the kernel folds (G1_ROWS)

# y^2 = x^3 + 4 over F_p
P_INT = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB  # noqa: E501
_R = 1 << 384                    # Montgomery radix, the JAX package's too
R2_INT = _R * _R % P_INT         # to-Montgomery multiplier
ONE_M_INT = _R % P_INT           # 1 in Montgomery form
B3_M_INT = 12 * _R % P_INT       # b3 = 3b = 12, Montgomery form
N0_WORD = (-pow(P_INT, -1, 1 << 32)) % (1 << 32)   # -p^-1 mod 2^32


def limbs_from_int(v: int) -> np.ndarray:
    return np.array([(v >> (LB * i)) & MASK for i in range(NLIMB)],
                    np.int32)


def int_from_limbs(limbs) -> int:
    v = 0
    for i, x in enumerate(np.asarray(limbs).tolist()):
        v += int(x) << (LB * i)
    return v


def limbs_from_xy(xy: bytes) -> np.ndarray:
    """(2, 32) int32 limbs from a 96-byte canonical affine x||y point
    (the ``crypto/bls12381.pk_to_affine`` output)."""
    if len(xy) != 96:
        raise ValueError("affine point must be 96 bytes")
    x = int.from_bytes(xy[:48], "big")
    y = int.from_bytes(xy[48:], "big")
    return np.stack([limbs_from_int(x), limbs_from_int(y)])


def xy_from_projective(out) -> bytes | None:
    """Host-side return trip: projective (3, 32) canonical limbs ->
    96-byte affine x||y, or None for the point at infinity."""
    out = np.asarray(out)
    x, y, z = (int_from_limbs(out[i]) for i in range(3))
    if z == 0:
        return None
    zi = pow(z, P_INT - 2, P_INT)
    return ((x * zi % P_INT).to_bytes(48, "big")
            + (y * zi % P_INT).to_bytes(48, "big"))


# ------------------------------------------------------------- limb layouts
# 32 limbs of 12 bits = 24 limbs of 16 bits = 12 words of 32 bits = 384
# bits; four 12-bit limbs are three 16-bit limbs, two 16-bit limbs a word.

def _limbs12_to_16(l12):
    """(..., 32) 12-bit limbs -> (..., 24) int64 16-bit limbs."""
    g = l12.to(torch.int64).reshape(*l12.shape[:-1], 8, 4)
    v = g[..., 0] | (g[..., 1] << 12) | (g[..., 2] << 24) | (g[..., 3] << 36)
    return torch.stack([(v >> s) & 0xFFFF for s in (0, 16, 32)],
                       -1).reshape(*l12.shape[:-1], 24)


def _limbs16_to_12(l16):
    """(..., 24) 16-bit limbs -> (..., 32) int32 12-bit limbs."""
    g = l16.to(torch.int64).reshape(*l16.shape[:-1], 8, 3)
    v = g[..., 0] | (g[..., 1] << 16) | (g[..., 2] << 32)
    return torch.stack([(v >> s) & MASK for s in (0, 12, 24, 36)],
                       -1).reshape(*l16.shape[:-1], NLIMB).to(torch.int32)


def _words_to_16(words):
    """(..., 12) int32 words (uint32 bits) -> (..., 24) int64 16-bit limbs."""
    w = words.to(torch.int64) & 0xFFFFFFFF
    return torch.stack([w & 0xFFFF, w >> 16], -1).reshape(
        *words.shape[:-1], 24)


def words_from_limbs(l12):
    """(..., 32) int32 12-bit limbs -> (..., 12) int32 words, the kernel's
    layout (each int32 holds the bits of a little-endian uint32 word)."""
    g = _limbs12_to_16(l12).reshape(*l12.shape[:-1], NWORD, 2)
    w = g[..., 0] | (g[..., 1] << 16)
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)


# ------------------------------------------------------------ plain version
# Field elements: (..., 24) int64 16-bit limbs, fully reduced (< p).

def _limbs16(v: int) -> list:
    return [(v >> (16 * i)) & 0xFFFF for i in range(24)]


_N16 = (-pow(P_INT, -1, 1 << 16)) % (1 << 16)


def _const(v: int, like):
    return torch.tensor(_limbs16(v), dtype=torch.int64, device=like.device)


def _carry(x):
    """Propagate carries (arithmetic shifts, so negative limbs borrow);
    returns the 16-bit limbs and the carry out of the top limb."""
    outs = []
    cr = torch.zeros(x.shape[:-1], dtype=torch.int64, device=x.device)
    for i in range(24):
        t = x[..., i] + cr
        outs.append(t & 0xFFFF)
        cr = t >> 16
    return torch.stack(outs, -1), cr


def _reduce(x):
    """x mod p for 0 <= x < 2p given as (possibly unnormalised) limbs."""
    x, _ = _carry(x)
    d, cr = _carry(x - _const(P_INT, x))
    return torch.where((cr < 0)[..., None], x, d)


def _fadd(a, b):
    return _reduce(a + b)


def _fsub(a, b):
    return _reduce(a - b + _const(P_INT, a))


def _fmul(a, b):
    """Montgomery product a * b * 2^-384 mod p: schoolbook columns, then
    24 reduction steps, each clearing the lowest live 16-bit column."""
    shape = torch.broadcast_shapes(a.shape[:-1], b.shape[:-1])
    c = torch.zeros(shape + (48,), dtype=torch.int64, device=a.device)
    for i in range(24):
        c[..., i:i + 24] += a[..., i:i + 1] * b
    p = _const(P_INT, c)
    for i in range(24):
        m = ((c[..., i] & 0xFFFF) * _N16) & 0xFFFF
        c[..., i:i + 24] += m[..., None] * p
        c[..., i + 1] += c[..., i] >> 16
    return _reduce(c[..., 24:])


def _padd(p1, p2):
    """RCB15 Algorithm 7 (a = 0, b3 = 12), as ``blsg1.py:_padd`` of the
    JAX package: complete, so identity rows, doublings and cancellations
    take the same formulas."""
    x1, y1, z1 = p1
    x2, y2, z2 = p2
    b3 = _const(B3_M_INT, x1)
    t0 = _fmul(x1, x2)
    t1 = _fmul(y1, y2)
    t2 = _fmul(z1, z2)
    t3 = _fsub(_fmul(_fadd(x1, y1), _fadd(x2, y2)), _fadd(t0, t1))
    t4 = _fsub(_fmul(_fadd(y1, z1), _fadd(y2, z2)), _fadd(t1, t2))
    xz = _fsub(_fmul(_fadd(x1, z1), _fadd(x2, z2)), _fadd(t0, t2))
    t0 = _fadd(_fadd(t0, t0), t0)             # 3 X1X2
    t2 = _fmul(b3, t2)                        # b3 Z1Z2
    z3 = _fadd(t1, t2)
    t1 = _fsub(t1, t2)
    yz = _fmul(b3, xz)                        # b3 (X1Z2 + X2Z1)
    x3 = _fsub(_fmul(t3, t1), _fmul(t4, yz))
    y3 = _fadd(_fmul(yz, t0), _fmul(t1, z3))
    z3 = _fadd(_fmul(z3, t4), _fmul(t0, t3))
    return x3, y3, z3


def _sum_plain(x16, y16, mask):
    """(R, 24) canonical affine coordinates and (R,) mask -> (3, 24)
    canonical projective limbs of the masked sum."""
    sel = (mask != 0)[:, None]
    one_m = _const(ONE_M_INT, x16)
    r2 = _const(R2_INT, x16)
    zero = torch.zeros_like(one_m)
    x = torch.where(sel, _fmul(x16, r2), zero)
    y = torch.where(sel, _fmul(y16, r2), one_m)
    z = torch.where(sel, one_m, zero)
    n = x.shape[0]
    pow2 = 1 << max(0, (n - 1).bit_length())
    if pow2 != n:                          # identity rows up to a power of 2
        pad = pow2 - n
        x = torch.cat([x, zero.expand(pad, 24)])
        y = torch.cat([y, one_m.expand(pad, 24)])
        z = torch.cat([z, zero.expand(pad, 24)])
        n = pow2
    while n > 1:
        h = n // 2
        x, y, z = _padd((x[:h], y[:h], z[:h]), (x[h:], y[h:], z[h:]))
        n = h
    one = _const(1, x)
    return torch.stack([_fmul(x[0], one), _fmul(y[0], one),
                        _fmul(z[0], one)])


def _masked_sum_plain(words, mask):
    """The plain version at the kernel's boundary: (R, 2, 12) int32 words
    and (R,) int32 mask -> (3, 32) int32 canonical projective limbs."""
    l16 = _words_to_16(words)
    return _limbs16_to_12(_sum_plain(l16[:, 0], l16[:, 1], mask))


# ------------------------------------------------------------------ wrappers

def aggregate_g1_masked(points: torch.Tensor,
                        mask: torch.Tensor) -> torch.Tensor:
    """Masked G1 sum at the JAX package's boundary: ``points`` (R, 2, 32)
    int32 canonical affine 12-bit limbs (:func:`limbs_from_xy`), ``mask``
    (R,) int32, nonzero selects the row.  Returns (3, 32) int32 canonical
    projective limbs (:func:`xy_from_projective` finishes on the host).
    Replaces ``cometbft_tpu/ops/blsg1.py:169``; the points are repacked
    into words and go through :func:`g1_masked_sum`."""
    r = points.shape[0]
    _build.check_arg(points, "points", torch.int32, (r, 2, NLIMB))
    return g1_masked_sum(words_from_limbs(points), mask)


def g1_masked_sum(words: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked G1 sum over a table in the kernel's layout: ``words`` (R, 2,
    12) int32 (canonical affine x, y as little-endian uint32 words,
    :func:`words_from_limbs`), ``mask`` (R,) int32.  Returns (3, 32) int32
    canonical projective 12-bit limbs.  CUDA kernel
    ``aggregate_g1_masked`` (``csrc/blsg1.cu``), one C call of one launch
    up to ``FOLD_ROWS`` padded rows, two up to 2^16, counted once."""
    r = words.shape[0]
    _build.check_arg(words, "words", torch.int32, (r, 2, NWORD))
    _build.check_arg(mask, "mask", torch.int32, (r,))
    if words.device != mask.device:
        raise ValueError("words and mask lie on different devices")
    if words.device.type == "cpu":
        _build.PLAIN_CALLS["aggregate_g1_masked"] += 1
        return _masked_sum_plain(words, mask)
    pow2 = 1 << max(0, (r - 1).bit_length())
    rows = _scratch_rows(pow2)
    scratch = torch.empty((rows, 3, NWORD), dtype=torch.int32,
                          device=words.device)
    out = torch.empty((3, NLIMB), dtype=torch.int32, device=words.device)
    _build.launch("aggregate_g1_masked", words, words.data_ptr(),
                  mask.data_ptr(), r, pow2, scratch.data_ptr(), rows,
                  out.data_ptr())
    return out


def _scratch_rows(n2: int) -> int:
    """Projective points the kernel's first launch writes for ``n2``
    padded rows: its ``L = log2 n2`` levels split evenly over
    ``ceil(L / log2 FOLD_ROWS)`` launches, the first taking the fewest;
    none for one launch (``csrc/blsg1.cu:aggregate_g1_masked_launch``)."""
    levels, lmax = n2.bit_length() - 1, FOLD_ROWS.bit_length() - 1
    if levels <= lmax:
        return 0
    return n2 >> (levels // -(-levels // lmax))
