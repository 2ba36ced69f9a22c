"""GF(2^255 - 19) arithmetic in plain PyTorch: the port's field layer.

Counterpart of ``cometbft_tpu/ops/fe_lm.py``.  The JAX package holds an
element as 20 limbs of 13 bits because the TPU's vector units have no
64-bit products; the port uses the ref10 representation instead: 10
signed limbs of alternately 26 and 25 bits (bit offsets ``OFFSETS``),
multiplied as 32 x 32 -> 64-bit products.  The CUDA kernels
(``csrc/ed25519.cuh``) use the same representation with their own carry
schedule (rounded carries, no carry after an addition), so they compute
the same values mod p, not the same limbs.

Elements are int64 tensors of shape ``(10, n)``: limbs on axis 0, lanes
on axis 1 (the layout the CUDA side has per thread).  "Carried" limbs lie
in ``(-2^w - 64, 2^w + 64)`` for limb width ``w``; every operation takes
and returns carried limbs, which bounds every product column below 2^61.
"""

from __future__ import annotations

import torch

__all__ = ["P_INT", "D_INT", "WIDTHS", "OFFSETS", "limbs_from_int",
           "int_from_limbs", "const", "add", "sub", "neg", "mul", "square",
           "freeze", "is_zero", "eq", "select", "from_bytes32", "pow22523",
           "sqrt_ratio", "invert", "MUL_COUNT"]

P_INT = 2**255 - 19
D_INT = (-121665 * pow(121666, P_INT - 2, P_INT)) % P_INT
SQRT_M1_INT = pow(2, (P_INT - 1) // 4, P_INT)

WIDTHS = (26, 25, 26, 25, 26, 25, 26, 25, 26, 25)
OFFSETS = (0, 26, 51, 77, 102, 128, 153, 179, 204, 230)
NL = 10


def limbs_from_int(x: int) -> list[int]:
    """Canonical limbs of ``x mod p``."""
    x %= P_INT
    return [(x >> o) & ((1 << w) - 1) for o, w in zip(OFFSETS, WIDTHS)]


def int_from_limbs(limbs) -> int:
    """Value of (possibly loose, signed) limbs, reduced mod p."""
    return sum(int(v) << o for v, o in zip(limbs, OFFSETS)) % P_INT


def _coef(i: int, j: int) -> int:
    """Weight of the product limb_i * limb_j in column (i + j) mod 10:
    a power of two for the bit-offset mismatch of odd limbs, times 19
    where the product wraps past 2^255."""
    k = (i + j) % NL
    wrap = i + j >= NL
    shift = OFFSETS[i] + OFFSETS[j] - OFFSETS[k] - (255 if wrap else 0)
    assert shift in (0, 1)
    return (1 << shift) * (19 if wrap else 1)


# column k gathers a[i] * b[(k - i) mod 10] * COEF_T[k][i]
_J = [[(k - i) % NL for i in range(NL)] for k in range(NL)]
_COEF_T = [[_coef(i, (k - i) % NL) for i in range(NL)] for k in range(NL)]
_P_LIMBS = [(1 << w) - 1 for w in WIDTHS]
_P_LIMBS[0] -= 18                                   # p = 2^255 - 19
_P2 = [2 * v for v in _P_LIMBS]
assert sum(v << o for v, o in zip(_P_LIMBS, OFFSETS)) == P_INT

_CONSTS: dict = {}


def _tensors(device):
    """Per-device constant tensors (built once per device)."""
    key = ("_t", str(device))
    t = _CONSTS.get(key)
    if t is None:
        i64 = dict(dtype=torch.int64, device=device)
        t = {
            "shift": torch.tensor(WIDTHS, **i64).view(NL, 1),
            "mask": torch.tensor([(1 << w) - 1 for w in WIDTHS],
                                 **i64).view(NL, 1),
            "j": torch.tensor(_J, dtype=torch.long, device=device),
            "coef": torch.tensor(_COEF_T, **i64).view(NL, NL, 1),
            "p2": torch.tensor(_P2, **i64).view(NL, 1),
        }
        _CONSTS[key] = t
    return t


def const(x: int, device) -> torch.Tensor:
    """Python int -> (10, 1) canonical limb column (broadcasts over lanes)."""
    key = (x % P_INT, str(device))
    c = _CONSTS.get(key)
    if c is None:
        c = torch.tensor(limbs_from_int(x), dtype=torch.int64,
                         device=device).view(NL, 1)
        _CONSTS[key] = c
    return c


def _carry(h: torch.Tensor, passes: int) -> torch.Tensor:
    """Parallel floor carries: every limb keeps its low ``w`` bits and
    hands the rest to the next limb; limb 9's carry re-enters limb 0
    times 19 (2^255 = 19 mod p)."""
    t = _tensors(h.device)
    for _ in range(passes):
        c = h >> t["shift"]
        h = (h & t["mask"]) + torch.cat([c[NL - 1:] * 19, c[:NL - 1]], 0)
    return h


def add(a, b):
    return _carry(a + b, 1)


def sub(a, b):
    return _carry(a - b, 1)


def neg(a):
    return _carry(-a, 1)


class _MulCount:
    """Lane field multiplications performed by the plain version
    (squarings included; one call over n lanes counts n), for the
    operation counts behind the kernels' bounds."""

    n = 0


MUL_COUNT = _MulCount


def mul(a, b):
    """100 limb products into 10 columns, then three carry passes: the
    columns stay below 10 * 38 * 2^(26 + 26) < 2^61."""
    n = max(a.shape[1], b.shape[1])
    MUL_COUNT.n += n
    t = _tensors(a.device)
    a = a.expand(NL, n)
    b = b.expand(NL, n)
    bj = b[t["j"]]                                   # (10 k, 10 i, n)
    h = (a.unsqueeze(0) * bj * t["coef"]).sum(1)
    return _carry(h, 3)


def square(a):
    return mul(a, a)


def select(mask, a, b):
    """mask (n,) bool -> limbs of ``a`` where true, else ``b``."""
    return torch.where(mask.unsqueeze(0), a, b)


def _seq_carry(x: torch.Tensor) -> torch.Tensor:
    """One sequential carry chain 0..9 with the x19 wrap into limb 0."""
    limbs = list(x.unbind(0))
    for i in range(NL - 1):
        c = limbs[i] >> WIDTHS[i]
        limbs[i] = limbs[i] & ((1 << WIDTHS[i]) - 1)
        limbs[i + 1] = limbs[i + 1] + c
    c = limbs[NL - 1] >> WIDTHS[NL - 1]
    limbs[NL - 1] = limbs[NL - 1] & ((1 << WIDTHS[NL - 1]) - 1)
    limbs[0] = limbs[0] + 19 * c
    return torch.stack(limbs, 0)


def freeze(a: torch.Tensor) -> torch.Tensor:
    """Carried limbs -> the canonical limbs of the value mod p: add 2p so
    every limb is positive, three sequential chains bring the value
    below 2^255 with every limb in range, then subtract p once if
    value + 19 reaches 2^255."""
    t = _tensors(a.device)
    x = a + t["p2"]
    for _ in range(3):
        x = _seq_carry(x)
    limbs = list(x.unbind(0))
    q = (limbs[0] + 19) >> WIDTHS[0]
    for i in range(1, NL):
        q = (limbs[i] + q) >> WIDTHS[i]
    limbs[0] = limbs[0] + 19 * q
    for i in range(NL - 1):
        c = limbs[i] >> WIDTHS[i]
        limbs[i] = limbs[i] & ((1 << WIDTHS[i]) - 1)
        limbs[i + 1] = limbs[i + 1] + c
    limbs[NL - 1] = limbs[NL - 1] & ((1 << WIDTHS[NL - 1]) - 1)
    return torch.stack(limbs, 0)


def is_zero(a):
    return (freeze(a) == 0).all(0)


def eq(a, b):
    return is_zero(sub(a, b))


def from_bytes32(bt: torch.Tensor) -> torch.Tensor:
    """(n, 32) little-endian byte values -> (10, n) limbs of the raw
    255-bit value (bit 255 dropped; not reduced mod p, which ZIP-215
    decoding allows)."""
    bt = bt.to(torch.int64)
    limbs = []
    for o, w in zip(OFFSETS, WIDTHS):
        acc = torch.zeros_like(bt[:, 0])
        for j in range(o // 8, min((o + w + 7) // 8, 32)):
            byte = bt[:, j] & 127 if j == 31 else bt[:, j]
            s = 8 * j - o
            acc = acc | (byte << s if s >= 0 else byte >> -s)
        limbs.append(acc & ((1 << w) - 1))
    return torch.stack(limbs, 0)


def _sq_n(a, n: int):
    for _ in range(n):
        a = square(a)
    return a


def _pow_chain(z):
    """ref10's addition chain: returns (z^(2^250 - 1), z^11)."""
    z2 = square(z)
    z9 = mul(z, _sq_n(z2, 2))
    z11 = mul(z2, z9)
    z_5_0 = mul(z9, square(z11))
    z_10_0 = mul(_sq_n(z_5_0, 5), z_5_0)
    z_20_0 = mul(_sq_n(z_10_0, 10), z_10_0)
    z_40_0 = mul(_sq_n(z_20_0, 20), z_20_0)
    z_50_0 = mul(_sq_n(z_40_0, 10), z_10_0)
    z_100_0 = mul(_sq_n(z_50_0, 50), z_50_0)
    z_200_0 = mul(_sq_n(z_100_0, 100), z_100_0)
    z_250_0 = mul(_sq_n(z_200_0, 50), z_50_0)
    return z_250_0, z11


def pow22523(z):
    """z^((p - 5) / 8)."""
    z_250_0, _ = _pow_chain(z)
    return mul(_sq_n(z_250_0, 2), z)


def invert(z):
    """z^(p - 2)."""
    z_250_0, z11 = _pow_chain(z)
    return mul(_sq_n(z_250_0, 5), z11)


def sqrt_ratio(u, v):
    """(x, ok): x^2 = u / v when ok (RFC 8032 decompression step)."""
    dev = u.device
    v3 = mul(square(v), v)
    uv3 = mul(u, v3)
    uv7 = mul(uv3, square(square(v)))
    x = mul(uv3, pow22523(uv7))
    vxx = mul(v, square(x))
    ok_direct = eq(vxx, u)
    ok_flip = eq(vxx, neg(u))
    x = select(ok_direct, x, mul(x, const(SQRT_M1_INT, dev)))
    return x, ok_direct | ok_flip
