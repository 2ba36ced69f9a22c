"""Random-linear-combination (RLC) batch verification: wrapper, kernel and
plain version.

Counterpart of ``cometbft_tpu/ops/rlc.py``.  The whole batch is verified
with one cofactored equation

    [8]( [sum z_i s_i] B  -  sum [z_i h_i] A_i  -  sum [z_i] R_i ) == O

with independent 128-bit coefficients z_i from the host CSPRNG.  The
doublings are paid once per batch: each 4-bit window's lane
contributions (one table entry per lane) collapse through a tree of
cached-coordinate additions, and one width-1 ladder walks the window
sums.  z_i has 128 bits, so the R sums cover only the low 32 windows.

Padding lanes carry z = 0 and add the identity to every sum; their lane
checks (decode, S < L) never veto the batch, even when they hold garbage.
Active all-zero coefficient rows are bumped to 1 on the host, so z != 0
is exactly the active mask.  The verdict is all-or-nothing: on a reject
the caller localizes with the per-lane kernel (``ops/ed25519.py``).

On CUDA tensors :func:`verify_batch_rlc_gather` launches the
``sha512_scalar`` kernel for h, then ``csrc/ed25519_rlc.cu`` (five
launches on one stream, counted as one launch of ``ed25519_rlc_gather``);
on CPU tensors it runs the plain version below.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build, group, scalar, sha512
from .ed25519 import _base_entry, _build_neg_table, prepare_pubkey_tables
from .group import Cached

__all__ = ["host_rlc_coeffs", "verify_batch_rlc", "verify_batch_rlc_gather"]

WINDOWS_A, WINDOWS_R = 64, 32
_RLC_THREADS = 128          # lanes per block of the window-sum kernel


def host_rlc_coeffs(n: int, active_mask=None, rng_bytes=None) -> np.ndarray:
    """(n, 16) uint8 little-endian 128-bit coefficients.

    Inactive (padding) lanes get z = 0, active all-zero rows become 1.
    ``rng_bytes`` (16 n bytes) pins them for tests; otherwise they come
    from the OS CSPRNG, because an adversary who chose the signatures
    must not predict them.  The same ``rng_bytes`` give the same
    integers as ``cometbft_tpu/ops/rlc.py:host_rlc_coeffs``."""
    if rng_bytes is None:
        import secrets

        rng_bytes = secrets.token_bytes(16 * n)
    z = np.frombuffer(rng_bytes, np.uint8).reshape(n, 16).copy()
    if active_mask is not None:
        act = np.asarray(active_mask, bool)
        z[~act] = 0
    else:
        act = np.ones((n,), bool)
    z[(z.sum(axis=1) == 0) & act, 0] = 1
    return z


def _tree_sum(ents: Cached) -> Cached:
    """add_cc tree over the lane axis of (10, lanes, windows) components
    -> per-window sums (10, windows).  Lanes pad to a power of two with
    identity entries."""
    nl, nw = ents.ypx.shape[1], ents.ypx.shape[2]
    p2 = 1 << max(nl - 1, 0).bit_length()
    if p2 != nl:
        idc = group.cache(group.identity((p2 - nl) * nw, ents.ypx.device))
        ents = Cached(*[torch.cat([c, i.reshape(10, p2 - nl, nw)], 1)
                        for c, i in zip(ents, idc)])
        nl = p2
    while nl > 1:
        h = nl // 2
        left = Cached(*[c[:, :h].reshape(10, -1) for c in ents])
        right = Cached(*[c[:, h:].reshape(10, -1) for c in ents])
        ents = Cached(*[c.reshape(10, h, nw)
                        for c in group.add_cc(left, right)])
        nl = h
    return Cached(*[c[:, 0] for c in ents])


def _window_entries(tab: torch.Tensor, digits: torch.Tensor) -> Cached:
    """(B, 16, 4, 10) tables + (B, W) digits -> (10, B, W) components."""
    b, w = digits.shape
    e = tab[torch.arange(b, device=tab.device)[:, None], digits]  # (B,W,4,10)
    e = e.to(torch.int64).permute(2, 3, 0, 1)                      # (4,10,B,W)
    return Cached(e[0], e[1], e[2], e[3])


def _rlc_sums_plain(tab, ok_a, idx, rb, sb, blocks, active, z):
    """The lane stage and the window fold: (sum_a, sum_r) cached window
    sums of (10, 64) and (10, 32), the (12,) limbs of sum z*s mod L, and
    the AND of the active lanes' checks."""
    idx = idx.long()
    lane_tab, lane_ok = tab[idx], ok_a[idx]
    r, ok_r = group.decompress_zip215(rb)
    r_tab = _build_neg_table(r)
    s13 = scalar.bytes32_to_limbs(sb)
    ok_s = scalar.lt_l(s13)
    h = scalar.reduce512(sha512.sha512_blocks(blocks, active))
    z7 = scalar.bytes_to_limbs(z, 7)
    zh_dig = scalar.nibbles(scalar.mul_mod_l(h, z7))
    zs_sum = scalar.sum_mod_l(scalar.mul_mod_l(s13, z7))
    z_dig = scalar.nibbles_k(z, WINDOWS_R)
    active_lane = (z != 0).any(1)
    lanes_ok = ((lane_ok & ok_r & ok_s) | ~active_lane).all()
    sum_a = _tree_sum(_window_entries(lane_tab, zh_dig))
    sum_r = _tree_sum(_window_entries(r_tab, z_dig))
    return sum_a, sum_r, zs_sum, lanes_ok


def _rlc_plain(tab, ok_a, idx, rb, sb, blocks, active, z):
    sum_a, sum_r, zs_sum, lanes_ok = _rlc_sums_plain(
        tab, ok_a, idx, rb, sb, blocks, active, z)
    sum_dig = scalar.nibbles(zs_sum[None])[0]
    acc = group.identity(1, rb.device)
    for w in range(63, -1, -1):
        for _ in range(4):
            acc = group.dbl(acc)
        acc = group.add_niels(acc, _base_entry(sum_dig[w:w + 1]))
        acc = group.add_cached(acc, Cached(*[c[:, w:w + 1] for c in sum_a]))
        if w < WINDOWS_R:
            acc = group.add_cached(acc, Cached(*[c[:, w:w + 1]
                                                 for c in sum_r]))
    acc = group.mul_by_cofactor(acc)
    return lanes_ok & group.is_identity(acc)[0]


def verify_batch_rlc_gather(tab, ok_a, idx, rb, sb, blocks, active, z):
    """One RLC verdict (0-d bool tensor) through a cached validator-set
    table.  Arguments as ``ed25519.verify_padded_gather`` plus z (B, 16)
    uint8 from :func:`host_rlc_coeffs`.  Replaces
    ``cometbft_tpu/ops/rlc.py:221``; CUDA kernel ``ed25519_rlc_gather``."""
    b = idx.shape[0]
    _build.check_arg(tab, "tab", torch.int32, (None, 16, 4, 10))
    _build.check_arg(ok_a, "ok_a", torch.bool, (tab.shape[0],))
    _build.check_arg(idx, "idx", torch.int32, (b,))
    _build.check_arg(rb, "rb", torch.uint8, (b, 32))
    _build.check_arg(sb, "sb", torch.uint8, (b, 32))
    _build.check_arg(blocks, "blocks", torch.int32, (b, None, 32))
    _build.check_arg(active, "active", torch.int32, (b,))
    _build.check_arg(z, "z", torch.uint8, (b, 16))
    _build.check_index((idx, tab.shape[0], "idx"),
                       (active, blocks.shape[1] + 1, "active"))
    if idx.device.type == "cpu":
        _build.PLAIN_CALLS["ed25519_rlc_gather"] += 1
        return _rlc_plain(tab, ok_a, idx, rb, sb, blocks, active, z)
    dev = idx.device
    h = sha512._sha512_scalar(blocks, active)
    nblk = max(1, -(-b // _RLC_THREADS))

    def empty(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=dev)

    rtab = empty((b, 16, 4, 10), torch.int32)
    zh = empty((b, 32), torch.uint8)
    zs = empty((b, 12), torch.int32)
    lane_ok = empty((b,), torch.uint8)
    partials = empty((WINDOWS_A + WINDOWS_R, nblk, 40), torch.int32)
    sums = empty((WINDOWS_A + WINDOWS_R, 40), torch.int32)
    zs_sum = empty((32,), torch.uint8)
    all_ok = empty((1,), torch.uint8)
    out = torch.full((), b == 0, dtype=torch.bool, device=dev)
    fn = _build.load("ed25519_rlc_gather")
    if b:
        _build.LAUNCHES["ed25519_rlc_gather"] += 1
        _build.check(fn(tab.data_ptr(), ok_a.data_ptr(), idx.data_ptr(),
                        rb.data_ptr(), sb.data_ptr(), h.data_ptr(),
                        z.data_ptr(), b, rtab.data_ptr(), zh.data_ptr(),
                        zs.data_ptr(), lane_ok.data_ptr(),
                        partials.data_ptr(), sums.data_ptr(),
                        zs_sum.data_ptr(), all_ok.data_ptr(),
                        out.data_ptr(), _build.stream_of(idx)),
                     "ed25519_rlc_gather")
    return out


def verify_batch_rlc(pub, rb, sb, blocks, active, z):
    """Uncached RLC verdict (``cometbft_tpu/ops/rlc.py:207``): the table
    kernel over the lanes' own keys, then the RLC kernel."""
    tab, ok = prepare_pubkey_tables(pub)
    idx = torch.arange(pub.shape[0], dtype=torch.int32, device=pub.device)
    return verify_batch_rlc_gather(tab, ok, idx, rb, sb, blocks, active, z)
