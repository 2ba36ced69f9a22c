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

On CUDA tensors :func:`verify_batch_rlc_gather` launches
``csrc/ed25519_rlc.cu`` (six launches on one stream, counted as one
launch of ``ed25519_rlc_gather``), whose lane stage hashes each lane (h =
SHA-512 mod L) beside the decode of its R, so h never leaves the card's
registers; on CPU tensors it runs the plain version below.  The lane
stage takes
``lane_block(B)`` lanes a block of 64 threads: 16 (a quad writes one
lane's table, the decode on half a warp) below ``QUAD_LANES_BELOW``
lanes, where the stage cannot fill the card, else 32 (a quad writes
two); ``scripts/rlc_lane_layouts.py`` measures the crossover.

The lane-sharded verdict (:func:`make_verify_batch_rlc_sharded`, K7)
splits the lanes over a device set: each distinct device runs the lane
stage and the window fold once over all of its shards' lanes (kernel
``ed25519_rlc_sums``, one C call a device), each shard writing its slot
of stacked outputs, and :func:`rlc_combine` (kernel
``ed25519_rlc_combine``) adds the shards' window sums in shard order,
sums their z*s mod L, ANDs their lane checks and runs the one ladder.
Only 96 points, 32 bytes and one flag per shard cross between devices.
:func:`rlc_sums_gather` is the same kernel over one shard.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ..parallel.mesh import replicate, split_by_device
from . import _build, group, scalar, sha512
from .ed25519 import (_base_entry, _build_neg_table, _check_lanes,
                      prepare_pubkey_tables)
from .group import Cached

__all__ = ["host_rlc_coeffs", "verify_batch_rlc", "verify_batch_rlc_gather",
           "RlcSums", "rlc_sums_buffers", "rlc_sums_gather", "rlc_combine",
           "make_verify_batch_rlc_sharded", "lane_block", "QUAD_LANES_BELOW"]

WINDOWS_A, WINDOWS_R = 64, 32
WINDOWS = WINDOWS_A + WINDOWS_R
_RLC_BLOCK_LANES = 1024     # lanes per block of the window-sum kernel
# lane counts below which the lane stage runs 16 lanes a block (a quad a
# table), measured on the H100 (scripts/rlc_lane_layouts.py: 16 lanes a
# block ahead up to 8,000 lanes, 32 at 10,000)
QUAD_LANES_BELOW = 8000


def lane_block(b: int) -> int:
    """Lanes a block of the lane stage takes for a call over ``b``
    lanes: 16 below ``QUAD_LANES_BELOW``, else 32."""
    return 16 if b < QUAD_LANES_BELOW else 32


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
    the AND of the active lanes' checks.  No lanes: the identity, 0 and
    True, as the kernel writes for an empty shard."""
    if idx.shape[0] == 0:
        ident = group.cache(group.identity(WINDOWS, rb.device))
        return (Cached(*[c[:, :WINDOWS_A] for c in ident]),
                Cached(*[c[:, WINDOWS_A:] for c in ident]),
                torch.zeros(scalar.NS, dtype=torch.int64, device=rb.device),
                torch.ones((), dtype=torch.bool, device=rb.device))
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


def _rlc_ladder_plain(sum_a: Cached, sum_r: Cached, zs_sum) -> torch.Tensor:
    """The width-1 ladder over the window sums and the cofactored
    identity test (``cometbft_tpu/ops/rlc.py:170 _rlc_ladder``)."""
    sum_dig = scalar.nibbles(zs_sum[None])[0]
    acc = group.identity(1, zs_sum.device)
    for w in range(63, -1, -1):
        for _ in range(4):
            acc = group.dbl(acc)
        acc = group.add_niels(acc, _base_entry(sum_dig[w:w + 1]))
        acc = group.add_cached(acc, Cached(*[c[:, w:w + 1] for c in sum_a]))
        if w < WINDOWS_R:
            acc = group.add_cached(acc, Cached(*[c[:, w:w + 1]
                                                 for c in sum_r]))
    acc = group.mul_by_cofactor(acc)
    return group.is_identity(acc)[0]


def _rlc_plain(tab, ok_a, idx, rb, sb, blocks, active, z):
    sum_a, sum_r, zs_sum, lanes_ok = _rlc_sums_plain(
        tab, ok_a, idx, rb, sb, blocks, active, z)
    return lanes_ok & _rlc_ladder_plain(sum_a, sum_r, zs_sum)


# ------------------------------------------------- per-shard sums, combine

class RlcSums(NamedTuple):
    """Stacked outputs of the lane stage and window fold, one slot per
    shard: ``sums`` (D, 96, 40) int32 cached window sums (64 A windows,
    then 32 R windows; ypx, ymx, z2, t2d limbs), ``zs`` (D, 32) uint8
    sum z*s mod L, ``ok`` (D,) uint8 AND of the active lanes' checks."""
    sums: torch.Tensor
    zs: torch.Tensor
    ok: torch.Tensor


def rlc_sums_buffers(d: int, device) -> RlcSums:
    """Uninitialised stacked outputs for ``d`` shards on ``device``, views
    of one allocation."""
    raw = torch.empty((d * (WINDOWS * 160 + 33),), dtype=torch.uint8,
                      device=device)
    sums = raw[:d * WINDOWS * 160].view(torch.int32).view(d, WINDOWS, 40)
    zs = raw[d * WINDOWS * 160:d * (WINDOWS * 160 + 32)].view(d, 32)
    return RlcSums(sums, zs, raw[d * (WINDOWS * 160 + 32):])


def _pack_sums(sum_a: Cached, sum_r: Cached) -> torch.Tensor:
    """(10, 64) and (10, 32) cached window sums -> (96, 40) int32 rows."""
    return torch.cat([torch.cat([c.T for c in s], 1)
                      for s in (sum_a, sum_r)]).to(torch.int32)


def _unpack_sums(rows: torch.Tensor) -> Cached:
    """(96, 40) rows -> cached window sums of (10, 96) int64."""
    return Cached(*[rows[:, 10 * k:10 * k + 10].T.to(torch.int64)
                    for k in range(4)])


def _check_rlc(tab, ok_a, idx, rb, sb, blocks, active, z) -> None:
    _build.check_arg(tab, "tab", torch.int32, (None, 16, 4, 10))
    _build.check_arg(ok_a, "ok_a", torch.bool, (tab.shape[0],))
    _build.check_arg(z, "z", torch.uint8, (idx.shape[0], 16))
    _check_lanes(idx, tab.shape[0], rb, sb, blocks, active)


def rlc_sums_gather(tab, ok_a, idx, rb, sb, blocks, active, z, out=None,
                    slot: int = 0) -> RlcSums:
    """The lane stage and window fold of one shard
    (``cometbft_tpu/ops/rlc.py:136 _rlc_sums``), written into slot
    ``slot`` of ``out`` (:func:`rlc_sums_buffers` on the lanes' device;
    one slot when not given).  Arguments as
    :func:`verify_batch_rlc_gather`; an empty shard writes the identity,
    0 and 1.  CUDA kernel ``ed25519_rlc_sums``, the hash in its lane
    stage."""
    _check_rlc(tab, ok_a, idx, rb, sb, blocks, active, z)
    if out is None:
        out = rlc_sums_buffers(1, idx.device)
    d = out.sums.shape[0]
    _build.check_arg(out.sums, "out.sums", torch.int32, (d, WINDOWS, 40))
    _build.check_arg(out.zs, "out.zs", torch.uint8, (d, 32))
    _build.check_arg(out.ok, "out.ok", torch.uint8, (d,))
    if not 0 <= slot < d:
        raise IndexError(f"slot {slot} outside [0, {d})")
    if out.sums.device != idx.device:
        raise ValueError(f"out on {out.sums.device}, lanes on {idx.device}")
    return _rlc_sums(tab, ok_a, idx, rb, sb, blocks, active, z, out, slot)


def _store_sums_plain(tab, ok_a, idx, rb, sb, blocks, active, z, out,
                      slot):
    """The plain version of one shard's sums, written into slot ``slot``
    of ``out`` in the kernel's layout."""
    sum_a, sum_r, zs_sum, lanes_ok = _rlc_sums_plain(
        tab, ok_a, idx, rb, sb, blocks, active, z)
    out.sums[slot] = _pack_sums(sum_a, sum_r)
    out.zs[slot] = scalar.limbs_to_bytes32(zs_sum[None])[0]
    out.ok[slot] = lanes_ok
    return out


def _rlc_sums(tab, ok_a, idx, rb, sb, blocks, active, z, out, slot):
    """:func:`rlc_sums_gather` on arguments already checked."""
    return _rlc_sums_card(tab, ok_a, idx, rb, sb, blocks, active, z,
                          [0, idx.shape[0]], [slot], out)


def _rlc_sums_card(tab, ok_a, idx, rb, sb, blocks, active, z, offs, slots,
                   out):
    """The lane stage and window fold of the shards one device holds, on
    arguments already checked: the lanes of shard ``slots[i]`` are
    ``[offs[i], offs[i + 1])`` of the per-lane arguments, and it writes
    slot ``slots[i]`` of ``out``.  One ``ed25519_rlc_sums`` call over all
    of those lanes."""
    if idx.device.type == "cpu":
        _build.PLAIN_CALLS["ed25519_rlc_sums"] += 1
        lanes = (idx, rb, sb, blocks, active, z)
        for d, a, b in zip(slots, offs, offs[1:]):
            _store_sums_plain(tab, ok_a, *[t[a:b] for t in lanes], out, d)
    else:
        _launch_sums(tab, ok_a, idx, rb, sb, blocks, active, z, offs, slots,
                     out)
    return out


def _launch_sums(tab, ok_a, idx, rb, sb, blocks, active, z, offs, slots,
                 out):
    b, dev = idx.shape[0], idx.device
    nblk = sum(-(-(hi - lo) // _RLC_BLOCK_LANES)
               for lo, hi in zip(offs, offs[1:]))

    # one allocation for the scratch, in 4-byte words: rtab b * 640, zs
    # b * 12 and partials 96 * nblk * 40, then the bytes of zh (b * 32)
    # and lane_ok (b)
    words = b * 652 + WINDOWS * nblk * 40
    base = torch.empty((words + -(-33 * b // 4),), dtype=torch.int32,
                       device=dev)
    p = base.data_ptr()
    n = len(slots)
    _build.launch("ed25519_rlc_sums", idx, tab.data_ptr(), ok_a.data_ptr(),
                  idx.data_ptr(), rb.data_ptr(), sb.data_ptr(),
                  blocks.data_ptr(), active.data_ptr(), z.data_ptr(), b,
                  blocks.shape[1], (ctypes.c_int * (n + 1))(*offs),
                  (ctypes.c_int * n)(*slots), n, lane_block(b), p,
                  p + 4 * words, p + 4 * b * 640, p + 4 * words + 32 * b,
                  p + 4 * b * 652, out.sums.data_ptr(), out.zs.data_ptr(),
                  out.ok.data_ptr())


def _rlc_combine_plain(sums, zs, ok):
    """add_cc chain over the shards' window sums in shard order (as
    ``cometbft_tpu/ops/rlc.py:290 _combine``), sum z*s mod L, AND of the
    oks, then the ladder."""
    acc = _unpack_sums(sums[0])
    for d in range(1, sums.shape[0]):
        acc = group.add_cc(acc, _unpack_sums(sums[d]))
    zs_sum = scalar.sum_mod_l(scalar.bytes_to_limbs(zs, scalar.NS))
    sum_a = Cached(*[c[:, :WINDOWS_A] for c in acc])
    sum_r = Cached(*[c[:, WINDOWS_A:] for c in acc])
    return (ok != 0).all() & _rlc_ladder_plain(sum_a, sum_r, zs_sum)


def rlc_combine(sums, zs, ok) -> torch.Tensor:
    """The verdict (0-d bool tensor) from the stacked per-shard outputs of
    :func:`rlc_sums_gather` (:class:`RlcSums` fields, D >= 1 shards).
    CUDA kernel ``ed25519_rlc_combine``: one block, a thread per window,
    then the comb and the ladder of :func:`verify_batch_rlc_gather`."""
    d = sums.shape[0]
    _build.check_arg(sums, "sums", torch.int32, (d, WINDOWS, 40))
    _build.check_arg(zs, "zs", torch.uint8, (d, 32))
    _build.check_arg(ok, "ok", torch.uint8, (d,))
    if d == 0:
        raise ValueError("rlc_combine needs at least one shard")
    if sums.device.type == "cpu":
        _build.PLAIN_CALLS["ed25519_rlc_combine"] += 1
        return _rlc_combine_plain(sums, zs, ok)
    out = torch.empty((), dtype=torch.bool, device=sums.device)
    _build.launch("ed25519_rlc_combine", sums, sums.data_ptr(),
                  zs.data_ptr(), ok.data_ptr(), d, out.data_ptr())
    return out


def verify_batch_rlc_gather(tab, ok_a, idx, rb, sb, blocks, active, z):
    """One RLC verdict (0-d bool tensor) through a cached validator-set
    table.  Arguments as ``ed25519.verify_padded_gather`` plus z (B, 16)
    uint8 from :func:`host_rlc_coeffs`.  Replaces
    ``cometbft_tpu/ops/rlc.py:221``; CUDA kernel ``ed25519_rlc_gather``."""
    b = idx.shape[0]
    _check_rlc(tab, ok_a, idx, rb, sb, blocks, active, z)
    if idx.device.type == "cpu":
        _build.PLAIN_CALLS["ed25519_rlc_gather"] += 1
        return _rlc_plain(tab, ok_a, idx, rb, sb, blocks, active, z)
    dev = idx.device
    nblk = max(1, -(-b // _RLC_BLOCK_LANES))

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
    if b:
        _build.launch("ed25519_rlc_gather", idx, tab.data_ptr(),
                      ok_a.data_ptr(), idx.data_ptr(), rb.data_ptr(),
                      sb.data_ptr(), blocks.data_ptr(), active.data_ptr(),
                      z.data_ptr(), b, blocks.shape[1], lane_block(b),
                      rtab.data_ptr(), zh.data_ptr(),
                      zs.data_ptr(), lane_ok.data_ptr(), partials.data_ptr(),
                      sums.data_ptr(), zs_sum.data_ptr(), all_ok.data_ptr(),
                      out.data_ptr())
    return out


def verify_batch_rlc(pub, rb, sb, blocks, active, z):
    """Uncached RLC verdict (``cometbft_tpu/ops/rlc.py:207``): the table
    kernel over the lanes' own keys, then the RLC kernel."""
    tab, ok = prepare_pubkey_tables(pub)
    idx = torch.arange(pub.shape[0], dtype=torch.int32, device=pub.device)
    return verify_batch_rlc_gather(tab, ok, idx, rb, sb, blocks, active, z)


def make_verify_batch_rlc_sharded(mesh, gather: bool = False):
    """The RLC verdict sharded over the lanes of ``mesh``
    (``parallel/mesh.py:Mesh``; ``cometbft_tpu/ops/rlc.py:232``).

    Each distinct device runs the lane stage and the window fold once
    over the lanes of all the shards it holds (``_rlc_sums_card``: one
    grid over those lanes, each shard into its slot of stacked outputs on
    that device); the slots of other devices are copied to the first
    device, where :func:`rlc_combine` folds them and runs the one ladder.
    Over a ``ProcessMesh`` each rank runs only its own shards and
    all-gathers the slots (``ProcessMesh.gather_slots``), and every rank
    folds the whole stack.
    The arguments are checked whole, once, before the split, every
    device's slab is copied before any kernel is enqueued
    (``parallel/mesh.py:split_by_device``), and every device is enqueued
    before the caller reads the verdict, so distinct cards overlap.
    ``gather=True`` gives the cached-table variant,
    ``fn(tab, ok_a, idx, rb, sb, blocks, active, z)``, whose table and ok
    mask are replicated (a tensor, or a mapping from device to its
    replica); otherwise ``fn(pub, rb, sb, blocks, active, z)`` builds each
    device's tables from its own lanes' keys.  Returns a 0-d bool tensor
    on the first (local) device."""
    devices = mesh.local_view()
    d0 = next(d for d in devices if d is not None)

    def combine(bufs):
        out = bufs[d0]
        for d, dev in enumerate(devices):
            if dev is not None and dev != d0:
                for o, t in zip(out, bufs[dev]):
                    o[d] = t[d].to(d0)
        mesh.gather_slots(*out)
        return rlc_combine(*out)

    def buffers():
        return {dev: rlc_sums_buffers(len(devices), dev)
                for dev in dict.fromkeys(devices) if dev is not None}

    if gather:
        def fn(tab, ok_a, idx, rb, sb, blocks, active, z):
            tabs, oks = replicate(tab, devices), replicate(ok_a, devices)
            _check_rlc(tabs[d0], oks[d0], idx, rb, sb, blocks, active, z)
            bufs = buffers()
            for dev, slots, offs, lanes in split_by_device(
                    devices, idx, rb, sb, blocks, active, z):
                _rlc_sums_card(tabs[dev], oks[dev], *lanes, offs, slots,
                               bufs[dev])
            return combine(bufs)
        return fn

    def fn(pub, rb, sb, blocks, active, z):
        b = pub.shape[0]
        _build.check_arg(pub, "pub", torch.uint8, (b, 32))
        idx = torch.arange(b, dtype=torch.int32, device=pub.device)
        _build.check_arg(z, "z", torch.uint8, (b, 16))
        _check_lanes(idx, b, rb, sb, blocks, active)
        bufs = buffers()
        for dev, slots, offs, (p, *lanes) in split_by_device(
                devices, pub, rb, sb, blocks, active, z):
            tab, ok = prepare_pubkey_tables(p)
            didx = torch.arange(p.shape[0], dtype=torch.int32, device=dev)
            _rlc_sums_card(tab, ok, didx, *lanes, offs, slots, bufs[dev])
        return combine(bufs)
    return fn
