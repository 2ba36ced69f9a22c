"""Per-lane Ed25519 ZIP-215 verification: wrappers, kernels and plain versions.

Counterpart of ``cometbft_tpu/ops/ed25519.py``.  Per signature lane:

    S < L,  A and R decode (ZIP-215, permissive),
    [8]([S]B - [h]A - R) == identity,   h = SHA-512(R || A || M) mod L

with one interleaved Straus ladder: 64 windows of 4 bits, 4 doublings per
window, one niels addition from the constant [j]B table and one cached
addition from the lane's [j](-A) table.

Each public function dispatches on the device of its tensors: on the CPU
it runs the plain PyTorch version (``_*_plain``), on CUDA it launches
the hand-written kernel (``csrc/ed25519_tables.cu``,
``csrc/ed25519_verify.cu``) or raises; there is no fallback between the
two.  Interfaces: bytes are ``uint8`` tensors, hash blocks ``int32``
holding the big-endian 32-bit words of ``sha512.host_pad``, indices and
active counts ``int32``.  The per-validator table is ``(N, 16, 4, 10)``
int32: for each validator, 16 cached entries [j](-A), each the
components (Y+X, Y-X, 2Z, 2dT) in the carried limbs of ``ops/fe.py``.
"""

from __future__ import annotations

import functools

import torch

from . import _build, fe, group, scalar, sha512
from .group import Cached, Ext, Niels

__all__ = ["prepare_pubkey_tables", "verify_padded", "verify_padded_gather",
           "base_niels_rows", "base_comb_rows", "base_niels_table",
           "tables_canonical"]


def _niels_rows(pt) -> list:
    """Niels limbs (Y+X, Y-X, 2dXY) of [j]pt, j = 0..15 (j = 0 is the
    identity), from the oracle's extended point ``pt``."""
    from ..crypto import _ed25519_py as ref

    p = fe.P_INT
    rows, acc = [], ref.IDENTITY
    for _ in range(16):
        zi = pow(acc[2], p - 2, p)
        x, y = acc[0] * zi % p, acc[1] * zi % p
        rows.append([fe.limbs_from_int(y + x), fe.limbs_from_int(y - x),
                     fe.limbs_from_int(2 * fe.D_INT * x * y)])
        acc = ref.pt_add(acc, pt)
    return rows


def base_niels_rows() -> list:
    """Niels limbs of [j]B, j = 0..15: the plain versions' table and the
    kernels' constant one."""
    from ..crypto import _ed25519_py as ref

    return _niels_rows(ref.BASE)


@functools.lru_cache(maxsize=1)
def base_comb_rows() -> list:
    """Niels limbs of [16^w j]B, w = 0..63, j = 0..15: the fixed-base
    comb of the RLC verdict, which adds one entry per 4-bit window of a
    scalar (``csrc/ed25519_rlc.cu``)."""
    from ..crypto import _ed25519_py as ref

    rows, pt = [], ref.BASE
    for _ in range(64):
        rows.append(_niels_rows(pt))
        for _ in range(4):
            pt = ref.pt_add(pt, pt)
    return rows


_BASE_TABLES: dict = {}


def base_niels_table(device) -> torch.Tensor:
    """(16, 3, 10) int64 tensor of :func:`base_niels_rows` on ``device``."""
    t = _BASE_TABLES.get(str(device))
    if t is None:
        t = torch.tensor(base_niels_rows(), dtype=torch.int64, device=device)
        _BASE_TABLES[str(device)] = t
    return t


# ------------------------------------------------------------ plain versions

def _inference(fn):
    """Run a plain version under ``torch.inference_mode`` (a quarter
    fewer dispatcher steps an operator call, which is what a one-lane
    check pays for) and hand back ordinary tensors, cloned outside it,
    so a caller may still update them in place."""

    @functools.wraps(fn)
    def run(*args):
        with torch.inference_mode():
            out = fn(*args)
        if isinstance(out, tuple):
            return tuple(o.clone() for o in out)
        return out.clone()

    return run


def _build_neg_table(p: Ext) -> torch.Tensor:
    """[j](-P), j = 0..15, for every lane -> (n, 16, 4, 10) int64: the
    chain identity, -P, [2](-P), then 13 cached additions."""
    n = p.x.shape[1]
    neg = group.neg_ext(p)
    c1 = group.cache(neg)
    acc = group.dbl(neg)
    ents = [group.cache(group.identity(n, p.x.device)), c1,
            group.cache(acc)]
    for _ in range(3, 16):
        acc = group.add_cached(acc, c1)
        ents.append(group.cache(acc))
    # (16, 4, 10, n) -> (n, 16, 4, 10)
    return torch.stack([torch.stack(list(c), 0) for c in ents], 0).permute(
        3, 0, 1, 2)


@_inference
def _prepare_plain(pub: torch.Tensor):
    if pub.shape[0] == 0:                 # an empty shard: no rows
        return (torch.empty((0, 16, 4, 10), dtype=torch.int32,
                            device=pub.device),
                torch.empty((0,), dtype=torch.bool, device=pub.device))
    a, ok = group.decompress_zip215(pub)
    return _build_neg_table(a).to(torch.int32).contiguous(), ok


def _entry(tab: torch.Tensor, digit: torch.Tensor) -> Cached:
    """(n, 16, 4, 10) lane tables + (n,) digits -> cached (10, n) each."""
    e = tab[torch.arange(tab.shape[0], device=tab.device), digit]
    e = e.to(torch.int64).permute(1, 2, 0)           # (4, 10, n)
    return Cached(e[0], e[1], e[2], e[3])


def _base_entry(digit: torch.Tensor) -> Niels:
    e = base_niels_table(digit.device)[digit].permute(1, 2, 0)
    return Niels(e[0], e[1], e[2])


@_inference
def _verify_core_plain(lane_tab, lane_ok, rb, sb, blocks, active):
    b = rb.shape[0]
    if b == 0:                            # an empty shard: no verdicts
        return torch.empty((0,), dtype=torch.bool, device=rb.device)
    r, ok_r = group.decompress_zip215(rb)
    ok_s = scalar.lt_l(scalar.bytes32_to_limbs(sb))
    s_dig = scalar.nibbles_k(sb, 64)
    h_dig = scalar.nibbles(scalar.reduce512(
        sha512.sha512_blocks(blocks, active)))
    acc = group.identity(b, rb.device)
    for w in range(63, -1, -1):
        for _ in range(4):
            acc = group.dbl(acc)
        acc = group.add_niels(acc, _base_entry(s_dig[:, w]))
        acc = group.add_cached(acc, _entry(lane_tab, h_dig[:, w]))
    acc = group.add_cached(acc, group.cache(group.neg_ext(r)))
    acc = group.mul_by_cofactor(acc)
    return lane_ok & ok_r & ok_s & group.is_identity(acc)


def _verify_gather_plain(tab, ok_a, idx, rb, sb, blocks, active):
    idx = idx.long()
    return _verify_core_plain(tab[idx], ok_a[idx], rb, sb, blocks, active)


# ------------------------------------------------------------------ wrappers

def prepare_pubkey_tables(pub: torch.Tensor):
    """Per-validator decode of A and its [j](-A) table, cacheable across
    commits.  pub (N, 32) uint8 -> (tab (N, 16, 4, 10) int32, ok (N,)
    bool).  Replaces ``cometbft_tpu/ops/ed25519.py:112``; CUDA kernel
    ``ed25519_tables``, at the RLC lane stage's validators a block
    (``ops/rlc.py:lane_block``)."""
    from . import rlc

    _build.check_arg(pub, "pub", torch.uint8, (None, 32))
    if pub.device.type == "cpu":
        _build.PLAIN_CALLS["ed25519_tables"] += 1
        return _prepare_plain(pub)
    n = pub.shape[0]
    tab = torch.empty((n, 16, 4, 10), dtype=torch.int32, device=pub.device)
    ok = torch.empty((n,), dtype=torch.bool, device=pub.device)
    if n:
        _build.launch("ed25519_tables", pub, pub.data_ptr(), n,
                      rlc.lane_block(n), tab.data_ptr(), ok.data_ptr())
    return tab, ok


def verify_padded_gather(tab, ok_a, idx, rb, sb, blocks, active):
    """Per-lane verdicts through a cached validator-set table: ``tab`` and
    ``ok_a`` are :func:`prepare_pubkey_tables` output, ``idx`` (B,) int32
    picks each lane's validator row; rb/sb (B, 32) uint8 signature halves,
    blocks (B, NB, 32) int32 padded R || A || M, active (B,) int32.
    Returns (B,) bool.  Replaces ``cometbft_tpu/ops/ed25519.py:170``;
    CUDA kernel ``ed25519_verify_gather``."""
    _build.check_arg(tab, "tab", torch.int32, (None, 16, 4, 10))
    _build.check_arg(ok_a, "ok_a", torch.bool, (tab.shape[0],))
    _check_lanes(idx, tab.shape[0], rb, sb, blocks, active)
    return _verify_gather(tab, ok_a, idx, rb, sb, blocks, active)


def _check_lanes(idx, n_rows, rb, sb, blocks, active) -> None:
    """The per-lane arguments' types, shapes and layout, and every index
    in range: ``idx`` below ``n_rows`` table rows, ``active`` at most the
    block count (one synchronisation on the card, so a sharded batch is
    checked whole, once)."""
    b = idx.shape[0]
    _build.check_arg(idx, "idx", torch.int32, (b,))
    _build.check_arg(rb, "rb", torch.uint8, (b, 32))
    _build.check_arg(sb, "sb", torch.uint8, (b, 32))
    _build.check_arg(blocks, "blocks", torch.int32, (b, None, 32))
    _build.check_arg(active, "active", torch.int32, (b,))
    _build.check_index((idx, n_rows, "idx"),
                       (active, blocks.shape[1] + 1, "active"))


def _verify_gather(tab, ok_a, idx, rb, sb, blocks, active):
    """:func:`verify_padded_gather` on arguments already checked (a lane
    shard of a batch checked whole, ``parallel/mesh.py``)."""
    b = idx.shape[0]
    if idx.device.type == "cpu":
        _build.PLAIN_CALLS["ed25519_verify_gather"] += 1
        return _verify_gather_plain(tab, ok_a, idx, rb, sb, blocks, active)
    out = torch.empty((b,), dtype=torch.bool, device=idx.device)
    if b:
        _build.launch("ed25519_verify_gather", idx, tab.data_ptr(),
                      ok_a.data_ptr(), idx.data_ptr(), rb.data_ptr(),
                      sb.data_ptr(), blocks.data_ptr(), active.data_ptr(),
                      b, blocks.shape[1], out.data_ptr())
    return out


def verify_padded(pub, rb, sb, blocks, active):
    """Uncached per-lane verdicts (``cometbft_tpu/ops/ed25519.py:157``):
    the table kernel over the lanes' own keys, then the gather kernel
    over the identity index."""
    tab, ok = prepare_pubkey_tables(pub)
    idx = torch.arange(pub.shape[0], dtype=torch.int32, device=pub.device)
    return verify_padded_gather(tab, ok, idx, rb, sb, blocks, active)


def tables_canonical(tab: torch.Tensor) -> torch.Tensor:
    """(N, 16, 4, 10) table limbs -> the same shape in canonical limbs
    (every field element reduced mod p), for exact comparisons."""
    n = tab.shape[0]
    flat = tab.to(torch.int64).reshape(-1, 10).T      # (10, N*64)
    return fe.freeze(flat).T.reshape(n, 16, 4, 10).to(torch.int32)
