"""Arithmetic mod L (the Ed25519 group order), plain PyTorch.

Counterpart of ``cometbft_tpu/ops/scalar.py``.  The JAX package reduces
to some representative below 2^256 in 13-bit limbs; the port reduces
fully below L with ref10's ``sc_reduce`` schedule over 21-bit signed
limbs held in int64 (``_sc_reduce``), so values compare exactly.  The
verification equation is cofactored, so any representative verifies
the same: compare h mod L between the packages, never digits.

Scalars are int64 tensors ``(n, k)`` of 21-bit limbs, lanes first.  A
reduced scalar has 12 limbs; the last holds up to 22 bits, because L
exceeds 2^252.  ``csrc/ed25519.cuh`` implements the same functions per
thread.
"""

from __future__ import annotations

import torch

__all__ = ["L_INT", "LIMB_BITS", "MU", "bytes_to_limbs", "bytes32_to_limbs",
           "lt_l", "reduce512", "limbs_to_bytes32", "nibbles", "nibbles_k",
           "mul_mod_l", "sum_mod_l", "int_from_limbs"]

L_INT = 2**252 + 27742317777372353535851937790883648493
LIMB_BITS = 21
_MASK = (1 << LIMB_BITS) - 1
NS = 12                               # limbs of a reduced scalar
Z_LIMBS = 7                           # limbs of a 128-bit coefficient


def _signed_digits(x: int, n: int) -> list[int]:
    """x as n signed base-2^21 digits in [-2^20, 2^20)."""
    out = []
    for _ in range(n):
        d = x & _MASK
        if d >= 1 << (LIMB_BITS - 1):
            d -= 1 << LIMB_BITS
        out.append(d)
        x = (x - d) >> LIMB_BITS
    if x != 0:
        raise ValueError("value does not fit the digits")
    return out


# 2^252 = -(L - 2^252) mod L, as six signed 21-bit digits: a limb k >= 12
# folds into limbs k-12 .. k-7 with these weights (ref10's 666643, ...)
MU = _signed_digits(-(L_INT - 2**252), 6)
_L_LIMBS = [(L_INT >> (LIMB_BITS * i)) & _MASK for i in range(13)]


def int_from_limbs(limbs) -> int:
    return sum(int(v) << (LIMB_BITS * i) for i, v in enumerate(limbs))


def bytes_to_limbs(b: torch.Tensor, nlimbs: int) -> torch.Tensor:
    """(n, nbytes) little-endian byte values -> (n, nlimbs) 21-bit limbs;
    the last limb takes every remaining bit (29 of them for 64 bytes)."""
    b = b.to(torch.int64)
    nbytes = b.shape[1]
    out = []
    for i in range(nlimbs):
        o = LIMB_BITS * i
        last = i == nlimbs - 1
        acc = torch.zeros_like(b[:, 0])
        end = nbytes if last else min((o + LIMB_BITS + 7) // 8, nbytes)
        for j in range(o // 8, end):
            s = 8 * j - o
            acc = acc | (b[:, j] << s if s >= 0 else b[:, j] >> -s)
        out.append(acc if last else acc & _MASK)
    return torch.stack(out, 1)


def bytes32_to_limbs(b: torch.Tensor) -> torch.Tensor:
    """(n, 32) bytes -> (n, 13) limbs of the full 256-bit value."""
    return bytes_to_limbs(b, 13)


def lt_l(x: torch.Tensor) -> torch.Tensor:
    """(n,) bool: a 13-limb canonical value is < L (S canonicity)."""
    lt = torch.zeros(x.shape[0], dtype=torch.bool, device=x.device)
    for i in range(13):
        li = _L_LIMBS[i]
        lt = torch.where(x[:, i] < li, True, torch.where(x[:, i] > li,
                                                         False, lt))
    return lt


def _fold(s: list, k: int) -> None:
    for j, m in enumerate(MU):
        s[k - 12 + j] = s[k - 12 + j] + s[k] * m
    s[k] = torch.zeros_like(s[k])


def _carry_round(s: list, i: int) -> None:
    c = (s[i] + (1 << (LIMB_BITS - 1))) >> LIMB_BITS
    s[i + 1] = s[i + 1] + c
    s[i] = s[i] - c * (1 << LIMB_BITS)


def _carry_floor(s: list, i: int) -> None:
    c = s[i] >> LIMB_BITS
    s[i + 1] = s[i + 1] + c
    s[i] = s[i] - c * (1 << LIMB_BITS)


def _sc_reduce(x24: torch.Tensor) -> torch.Tensor:
    """ref10 ``sc_reduce``: (n, 24) limbs of a value < 2^512 (limbs below
    2^21, the top one below 2^29) -> (n, 12) limbs of the value mod L."""
    s = list(x24.unbind(1))
    for k in range(23, 17, -1):
        _fold(s, k)
    for i in range(6, 17, 2):
        _carry_round(s, i)
    for i in range(7, 16, 2):
        _carry_round(s, i)
    for k in range(17, 11, -1):
        _fold(s, k)
    for i in range(0, 11, 2):
        _carry_round(s, i)
    for i in range(1, 12, 2):
        _carry_round(s, i)
    _fold(s, 12)
    for i in range(12):
        _carry_floor(s, i)
    _fold(s, 12)
    for i in range(11):
        _carry_floor(s, i)
    return torch.stack(s[:NS], 1)


def _normalize(cols: torch.Tensor, nout: int) -> torch.Tensor:
    """Sequential floor carry of nonnegative columns into nout limbs."""
    c = torch.zeros_like(cols[:, 0])
    out = []
    for i in range(nout):
        t = (cols[:, i] if i < cols.shape[1] else 0) + c
        out.append(t & _MASK)
        c = t >> LIMB_BITS
    return torch.stack(out, 1)


def reduce512(digest: torch.Tensor) -> torch.Tensor:
    """(n, 64) little-endian digest bytes -> (n, 12) limbs of h mod L."""
    return _sc_reduce(bytes_to_limbs(digest, 24))


def limbs_to_bytes32(x: torch.Tensor) -> torch.Tensor:
    """(n, 12) reduced limbs -> (n, 32) int64 bytes."""
    out = []
    for k in range(32):
        acc = torch.zeros_like(x[:, 0])
        for i in range(x.shape[1]):
            o = LIMB_BITS * i
            if o + LIMB_BITS <= 8 * k or o >= 8 * k + 8:
                continue
            s = o - 8 * k
            acc = acc | (x[:, i] << s if s >= 0 else x[:, i] >> -s)
        out.append(acc & 255)
    return torch.stack(out, 1)


def nibbles_k(b32: torch.Tensor, ndigits: int) -> torch.Tensor:
    """(n, >= ndigits/2) little-endian bytes -> (n, ndigits) radix-16
    digits, least significant first."""
    b = b32.to(torch.int64)[:, :(ndigits + 1) // 2]
    return torch.stack([b & 15, b >> 4], 2).reshape(b.shape[0], -1)[
        :, :ndigits]


def nibbles(x: torch.Tensor) -> torch.Tensor:
    """(n, 12) reduced limbs -> (n, 64) digits, least significant first."""
    return nibbles_k(limbs_to_bytes32(x), 64)


def mul_mod_l(x: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """(n, <= 13) limbs (value < 2^256) times (n, 7) limbs (< 2^147) ->
    (n, 12) limbs of the product mod L.  Columns stay below 7 * 2^42."""
    nx, nz = x.shape[1], z.shape[1]
    cols = torch.zeros(x.shape[0], nx + nz - 1, dtype=torch.int64,
                       device=x.device)
    for i in range(nz):
        cols[:, i:i + nx] += z[:, i:i + 1] * x
    return _sc_reduce(_normalize(cols, 24))


def sum_mod_l(x: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Sum (n, 12) reduced scalars over lanes -> (12,) limbs mod L.
    Column sums stay exact below 2^42 lanes."""
    if axis != 0:
        raise ValueError("lanes are axis 0")
    cols = x.sum(0, keepdim=True)
    return _sc_reduce(_normalize(cols, 24))[0]
