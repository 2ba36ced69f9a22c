"""Batch signature verification on the device: the port's dispatch layer.

Counterpart of ``cometbft_tpu/crypto/batch.py`` for the Ed25519 path.
Signatures pack into dense byte matrices, hash inputs R || A || M pad
into SHA-512 blocks on the host (``ops/sha512.host_pad``), and the lanes
go to the kernels:

- batches of at least ``RLC_MIN_LANES`` lanes first take the one-shot
  RLC verdict (``ops/rlc.py``); an accept proves every lane;
- smaller batches, and every RLC reject, take the per-lane ladder
  (``ops/ed25519.py``), which names the bad lanes.  On a reject the
  first bad lane is therefore the same one the JAX package names.

``device`` is a device, or ``None`` for the plan's devices
(``crypto/plan.py:resolve_devices``: the device set, else CUDA; ``"cpu"``
runs the plain versions, as the tests do).  On one device the kernels
run as above.  Over several (a device set, which may name one card
more than once) the lanes are cut into contiguous shards
(``parallel/mesh.py``): the RLC verdict is the sharded one
(``ops/rlc.py:make_verify_batch_rlc_sharded``), and the per-lane ladder
runs shard by shard, its verdicts gathered on the first device.

``device_verify_ed25519_cached`` reuses per-validator-set tables
(decode of A and its [j](-A) table) across commits, keyed by the
identity of the set's pubkey matrix, with a replica per distinct
device, so a set's table is built once per device.  The kernels take
any lane count, so there are no shape buckets, no lane cap and no
chunking.  ``DISPATCHES`` counts the verdict calls by route
(``rlc_gather``, ``gather``, ``rlc``, ``verify`` and their ``_sharded``
twins).

:func:`device_call` runs a dispatch on the one device-owner thread (the
counterpart of ``cometbft_tpu/crypto/batch.py:837 _device_call`` in its
patient mode): blocksync's windows, packed on worker threads, and the
verification scheduler's micro-batches (``crypto/scheduler.py``, queued
through :func:`device_submit`) run there one behind the other.  Unlike the JAX package's, the wait has no
bound and nothing falls back to the host: a device error, or a call
that never returns, stays the caller's.
"""

from __future__ import annotations

import collections
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..ops import _build
from ..ops import ed25519 as _ed
from ..ops import rlc as _rlc
from ..ops import sha512 as _sha
from ..parallel import mesh as _mesh
from . import plan as _plan

__all__ = ["RLC_MIN_LANES", "DISPATCHES", "BatchVerifier",
           "create_batch_verifier", "verify_dense", "device_verify_ed25519",
           "device_verify_ed25519_cached", "device_call", "device_submit",
           "DEVICE_THREAD_NAME"]

# Minimum Ed25519 lanes before the RLC verdict
RLC_MIN_LANES = 128
# validator sets whose device tables stay cached (oldest evicted first)
TABLE_CACHE_ENTRIES = 4
# verdict calls by route
DISPATCHES: collections.Counter = collections.Counter()


def _padded_lane_args(pubs, rs, ss, msgs, msg_lens, device):
    """Host packing shared by the cached and uncached routes: the
    R || A || M hash inputs padded into SHA-512 blocks, byte matrices as
    uint8 tensors on ``device``.  Returns (rb, sb, blocks, active)."""
    b = pubs.shape[0]
    hin = np.zeros((b, 64 + msgs.shape[1]), np.uint8)
    hin[:, :32] = rs
    hin[:, 32:64] = pubs
    hin[:, 64:] = msgs
    lens = 64 + np.asarray(msg_lens, np.int64)
    nb = _sha.max_blocks_for_len(int(lens.max(initial=0)))
    blocks, active = _sha.host_pad(hin, lens, nb)

    def put(a, dtype=None):
        return torch.from_numpy(np.array(a if dtype is None else
                                         a.view(dtype))).to(device)

    return (put(np.asarray(rs, np.uint8)), put(np.asarray(ss, np.uint8)),
            put(blocks, np.int32), put(active))


def _per_lane_sharded(devices, head, lanes):
    """The per-lane ladder over lane shards of ``devices``, arguments as
    :func:`_lane_route`'s: each shard runs its slab through the set's
    table replica on its device, or through a table of its own lanes'
    keys.  The batch is checked whole, once; the verdicts come back in
    lane order on the first device."""
    b, d0 = lanes[0].shape[0], devices[0]
    outs = []
    if len(head) == 3:
        tabs, oks = (_mesh.replicate(t, devices) for t in head[:2])
        _build.check_arg(tabs[d0], "tab", torch.int32, (None, 16, 4, 10))
        _build.check_arg(oks[d0], "ok_a", torch.bool, (tabs[d0].shape[0],))
        _ed._check_lanes(head[2], tabs[d0].shape[0], *lanes)
        for dev, part in zip(devices, _mesh.split(devices, head[2], *lanes)):
            outs.append(_ed._verify_gather(tabs[dev], oks[dev], *part))
    else:
        _build.check_arg(head[0], "pub", torch.uint8, (b, 32))
        _ed._check_lanes(torch.arange(b, dtype=torch.int32, device=d0), b,
                         *lanes)
        for dev, (p, *part) in zip(devices,
                                   _mesh.split(devices, head[0], *lanes)):
            tab, ok = _ed.prepare_pubkey_tables(p)
            sidx = torch.arange(p.shape[0], dtype=torch.int32, device=dev)
            outs.append(_ed._verify_gather(tab, ok, sidx, *part))
    return torch.cat([o.to(d0) for o in outs])


def _lane_route(devices, head, lanes, rng_bytes):
    """RLC first at ``RLC_MIN_LANES`` lanes, per lane on small batches
    and on a reject.  ``head`` is ``(tab, ok, idx)`` through a table
    (over several devices ``tab`` and ``ok`` may map each device to its
    replica), or ``(pub,)`` over several devices, whose shards build
    tables from their own keys; ``lanes`` the packed (rb, sb, blocks,
    active) on the first device.  Returns (B,) numpy bool."""
    b = lanes[0].shape[0]
    gather = len(head) == 3
    suffix = "_sharded" if len(devices) > 1 else ""
    if b >= RLC_MIN_LANES:
        z = torch.from_numpy(_rlc.host_rlc_coeffs(
            b, rng_bytes=rng_bytes)).to(lanes[0].device)
        DISPATCHES[("rlc_gather" if gather else "rlc") + suffix] += 1
        fn = (_rlc.make_verify_batch_rlc_sharded(_mesh.Mesh(devices), gather)
              if suffix else _rlc.verify_batch_rlc_gather)
        if bool(fn(*head, *lanes, z)):
            return np.ones((b,), bool)
    DISPATCHES[("gather" if gather else "verify") + suffix] += 1
    out = (_per_lane_sharded(devices, head, lanes) if suffix
           else _ed.verify_padded_gather(*head, *lanes))
    return out.cpu().numpy()


def device_verify_ed25519(pubs, rs, ss, msgs, msg_lens, device=None,
                          rng_bytes=None) -> np.ndarray:
    """Verify B Ed25519 signatures from dense arrays: pubs, rs, ss (B, 32)
    uint8, msgs (B, L) uint8 zero-padded rows, msg_lens (B,).  Tables are
    built for these lanes' own keys (per shard over several devices).
    Returns (B,) bool."""
    b = pubs.shape[0]
    if b == 0:
        return np.zeros((0,), bool)
    devices = _plan.resolve_devices(device)
    dev = devices[0]
    pub_t = torch.from_numpy(np.array(pubs, np.uint8)).to(dev)
    lanes = _padded_lane_args(pubs, rs, ss, msgs, msg_lens, dev)
    if len(devices) > 1:
        return _lane_route(devices, (pub_t,), lanes, rng_bytes)
    tab, ok = _ed.prepare_pubkey_tables(pub_t)
    idx = torch.arange(b, dtype=torch.int32, device=dev)
    return _lane_route(devices, (tab, ok, idx), lanes, rng_bytes)


# id of the set's pubkey matrix -> (matrix, {device: (tab, ok)}).  The
# matrix is ``ValidatorSet.dense()``'s, built once per set; entries hold
# it, so an id is never reused while cached.
_TABLES: dict = {}
_TABLES_LOCK = threading.Lock()


def _valset_tables(valset_pubs: np.ndarray, devices) -> dict:
    """The set's (tab, ok) on every distinct device of ``devices``, each
    built on first use there; the cache holds TABLE_CACHE_ENTRIES sets,
    however many devices each spans.  One lock covers the lookup and the
    build, so two threads never build one set's table twice."""
    with _TABLES_LOCK:
        ent = _TABLES.get(id(valset_pubs))
        if ent is None:
            while len(_TABLES) >= TABLE_CACHE_ENTRIES:
                _TABLES.pop(next(iter(_TABLES)))
            ent = _TABLES[id(valset_pubs)] = (valset_pubs, {})
        reps = ent[1]
        for dev in dict.fromkeys(devices):
            if dev not in reps:
                reps[dev] = _ed.prepare_pubkey_tables(torch.from_numpy(
                    np.array(valset_pubs, np.uint8)).to(dev))
        return dict(reps)


DEVICE_THREAD_NAME = "device-owner"
_DEVICE_POOL: ThreadPoolExecutor | None = None
_DEVICE_POOL_LOCK = threading.Lock()


def device_submit(fn):
    """Queue ``fn()`` (a device dispatch) on the single device-owner
    thread and return its ``concurrent.futures.Future`` (an event loop
    awaits it through ``asyncio.wrap_future``).  The executor is made
    once, under a lock, so concurrent callers share the one thread.
    ``fn`` names its devices: a worker thread has its own current
    device."""
    global _DEVICE_POOL
    with _DEVICE_POOL_LOCK:
        if _DEVICE_POOL is None:
            _DEVICE_POOL = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix=DEVICE_THREAD_NAME)
    return _DEVICE_POOL.submit(fn)


def device_call(fn):
    """``fn()`` run on the device-owner thread (:func:`device_submit`);
    the caller waits for it however long it takes, and an exception
    ``fn`` raises is raised here.  Called on the device-owner thread
    itself, ``fn`` runs inline (waiting on its own queue would never
    return)."""
    if threading.current_thread().name.startswith(DEVICE_THREAD_NAME):
        return fn()
    return device_submit(fn).result()


def device_verify_ed25519_cached(valset_pubs, scope, pubs_rows, rs, ss,
                                 msgs, msg_lens, device=None,
                                 rng_bytes=None) -> np.ndarray:
    """Dense verify through the per-valset table cache: ``scope`` (B,) are
    validator indices into ``valset_pubs`` (N, 32); ``pubs_rows`` (B, 32)
    the gathered keys, still needed for the R || A || M hash."""
    b = pubs_rows.shape[0]
    if b == 0:
        return np.zeros((0,), bool)
    devices = _plan.resolve_devices(device)
    dev = devices[0]
    reps = _valset_tables(valset_pubs, devices)
    if len(devices) > 1:             # replicas keyed by device
        tab = {d: t for d, (t, _) in reps.items()}
        ok = {d: o for d, (_, o) in reps.items()}
    else:
        tab, ok = reps[dev]
    idx = torch.from_numpy(np.asarray(scope, np.int32)).to(dev)
    return _lane_route(devices, (tab, ok, idx),
                       _padded_lane_args(pubs_rows, rs, ss, msgs, msg_lens,
                                         dev), rng_bytes)


def verify_dense(pubs, sigs, msgs, lens, device=None, valset_pubs=None,
                 scope=None, rng_bytes=None):
    """Dense-array verification: ``pubs`` (k, 32) u8, ``sigs`` (k, 64) u8,
    ``msgs`` (k, L) u8 zero-padded rows, ``lens`` (k,).  With
    ``valset_pubs``/``scope`` the per-valset tables are reused.  Returns
    ``(all_ok, oks ndarray)``."""
    k = pubs.shape[0]
    if k == 0:
        return True, np.zeros((0,), bool)
    rs = np.ascontiguousarray(sigs[:, :32])
    ss = np.ascontiguousarray(sigs[:, 32:])
    if valset_pubs is not None and scope is not None:
        out = device_verify_ed25519_cached(valset_pubs, scope, pubs, rs, ss,
                                           msgs, lens, device, rng_bytes)
    else:
        out = device_verify_ed25519(pubs, rs, ss, msgs, lens, device,
                                    rng_bytes)
    return bool(out.all()), out


class BatchVerifier:
    """Accumulate (pubkey, msg, sig) triples and verify them at once (the
    reference's ``crypto.BatchVerifier``): Ed25519 lanes in one dense
    device call, BLS12-381 lanes one by one on the host, as the JAX
    package's verifier routes them.  ``verify()`` returns ``(all_ok,
    per_sig)``; an empty batch is not ok.  An Ed25519 signature that is
    not 64 bytes is rejected without a launch."""

    def __init__(self, device=None):
        _plan.resolve_devices(device)        # raises without a card
        self._device = device
        self._items: list[tuple] = []

    def add(self, pub, msg: bytes, sig: bytes) -> None:
        if not isinstance(msg, (bytes, bytearray)):
            raise TypeError("msg must be bytes")
        self._items.append((pub, bytes(msg), bytes(sig)))

    def __len__(self) -> int:
        return len(self._items)

    def verify(self) -> tuple[bool, list[bool]]:
        n = len(self._items)
        if n == 0:
            return False, []
        oks = [False] * n
        for i, (pub, m, s) in enumerate(self._items):
            if pub.type() == "bls12_381":
                oks[i] = pub.verify_signature(m, s)
        ed = [i for i, (p, _, s) in enumerate(self._items)
              if p.type() == "ed25519" and len(s) == 64]
        if ed:
            items = [self._items[i] for i in ed]
            maxlen = max(max(len(m) for _, m, _ in items), 1)
            pubs = np.frombuffer(b"".join(p.bytes() for p, _, _ in items),
                                 np.uint8).reshape(len(ed), 32)
            sigs = np.frombuffer(b"".join(s for _, _, s in items),
                                 np.uint8).reshape(len(ed), 64)
            msgs = np.zeros((len(ed), maxlen), np.uint8)
            lens = np.zeros((len(ed),), np.int64)
            for j, (_, m, _) in enumerate(items):
                msgs[j, :len(m)] = np.frombuffer(m, np.uint8)
                lens[j] = len(m)
            _, out = verify_dense(pubs, sigs, msgs, lens, self._device)
            for j, i in enumerate(ed):
                oks[i] = bool(out[j])
        return all(oks), oks


def create_batch_verifier(device=None) -> BatchVerifier:
    """The device batch verifier (``device=None``: the plan's devices,
    raising without a card; ``"cpu"``: the plain versions)."""
    return BatchVerifier(device)
