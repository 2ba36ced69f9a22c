"""Twisted-Edwards (a = -1) point formulas over ``ops.fe``, plain PyTorch.

Counterpart of ``cometbft_tpu/ops/group.py:make_group``: the same
extended-coordinate hwcd-2008 formulas, the same cached and niels forms,
the same permissive ZIP-215 decoding.  ``csrc/ed25519.cuh`` carries the
same formulas, with the same signs, as ``__device__`` functions, and
also spread over the four threads of a quad.

Representations (each component a ``(10, n)`` limb tensor):
- extended: ``(X, Y, Z, T)``  with x = X/Z, y = Y/Z, T = XY/Z
- cached:   ``(Y+X, Y-X, 2Z, 2dT)``   (general addition operand)
- niels:    ``(Y+X, Y-X, 2dXY)``      (affine table entry, Z = 1)
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import fe

__all__ = ["Ext", "Cached", "Niels", "identity", "cache", "neg_ext", "dbl",
           "add_cached", "add_niels", "add_cc", "decompress_zip215",
           "mul_by_cofactor", "is_identity"]

P, D = fe.P_INT, fe.D_INT
D2_INT = 2 * D % P
INV2_INT = pow(2, P - 2, P)
INV2D_INT = pow(D2_INT, P - 2, P)


class Ext(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    t: torch.Tensor


class Cached(NamedTuple):
    ypx: torch.Tensor
    ymx: torch.Tensor
    z2: torch.Tensor
    t2d: torch.Tensor


class Niels(NamedTuple):
    ypx: torch.Tensor
    ymx: torch.Tensor
    t2d: torch.Tensor


def _bcast(x: int, n: int, device) -> torch.Tensor:
    return fe.const(x, device).expand(fe.NL, n).clone()


def identity(n: int, device) -> Ext:
    zero, one = _bcast(0, n, device), _bcast(1, n, device)
    return Ext(zero, one, one.clone(), zero.clone())


def cache(p: Ext) -> Cached:
    return Cached(fe.add(p.y, p.x), fe.sub(p.y, p.x), fe.add(p.z, p.z),
                  fe.mul(p.t, fe.const(D2_INT, p.t.device)))


def neg_ext(p: Ext) -> Ext:
    return Ext(fe.neg(p.x), p.y, p.z, fe.neg(p.t))


# The independent products of each formula go through one fe.mul_many
# call, and its independent sums and differences through one
# fe.carry_many: the same limbs lane by lane, a fraction of the operator
# calls.

def dbl(p: Ext) -> Ext:
    xy = fe.add(p.x, p.y)
    a, b, zz, xy2 = fe.mul_many(((p.x, p.x), (p.y, p.y), (p.z, p.z),
                                 (xy, xy)))
    c, h, g = fe.carry_many((zz + zz, a + b, a - b))
    e, ff = fe.carry_many((h - xy2, c + g))
    return Ext(*fe.mul_many(((e, ff), (g, h), (ff, g), (e, h))))


def _finish(a, b, c, d) -> Ext:
    e, ff, g, h = fe.carry_many((b - a, d - c, d + c, b + a))
    return Ext(*fe.mul_many(((e, ff), (g, h), (ff, g), (e, h))))


def add_cached(p: Ext, q: Cached) -> Ext:
    ymx, ypx = fe.carry_many((p.y - p.x, p.y + p.x))
    return _finish(*fe.mul_many(((ymx, q.ymx), (ypx, q.ypx),
                                 (p.t, q.t2d), (p.z, q.z2))))


def add_niels(p: Ext, q: Niels) -> Ext:
    ymx, ypx, z2 = fe.carry_many((p.y - p.x, p.y + p.x, p.z + p.z))
    a, b, c = fe.mul_many(((ymx, q.ymx), (ypx, q.ypx), (p.t, q.t2d)))
    return _finish(a, b, c, z2)


def add_cc(p: Cached, q: Cached) -> Cached:
    """Cached + cached -> cached, for the RLC lane trees: recovers the
    add_cached operands through the constant factors 1/(2d) and 1/2.
    Complete (the unified formula), so identity padding is harmless."""
    dev = p.ypx.device
    a = fe.mul(p.ymx, q.ymx)
    b = fe.mul(p.ypx, q.ypx)
    c = fe.mul(fe.mul(p.t2d, q.t2d), fe.const(INV2D_INT, dev))
    d = fe.mul(fe.mul(p.z2, q.z2), fe.const(INV2_INT, dev))
    r = _finish(a, b, c, d)
    return cache(r)


def decompress_zip215(enc: torch.Tensor):
    """ZIP-215 (permissive) decoding of ``(n, 32)`` encodings: y >= p is
    accepted, x = 0 with the sign bit set is accepted, small- and
    mixed-order points are fine; the only failure is a non-square x^2.
    Returns ``(Ext, ok)``; failed rows hold arithmetic-safe garbage."""
    dev = enc.device
    n = enc.shape[0]
    sign = (enc[:, 31].to(torch.int64) >> 7) & 1
    y = fe.from_bytes32(enc)
    one = _bcast(1, n, dev)
    yy = fe.square(y)
    u = fe.sub(yy, one)
    v = fe.add(fe.mul(yy, fe.const(D, dev)), one)
    x, ok = fe.sqrt_ratio(u, v)
    x = fe.freeze(x)
    flip = (x[0] & 1) != sign
    x = fe.select(flip, fe.neg(x), x)
    return Ext(x, y, one, fe.mul(x, y)), ok


def mul_by_cofactor(p: Ext) -> Ext:
    for _ in range(3):
        p = dbl(p)
    return p


def is_identity(p: Ext):
    """Projective identity test: X == 0 and Y == Z (mod p)."""
    return fe.is_zero(p.x) & fe.eq(p.y, p.z)
