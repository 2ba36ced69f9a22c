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

Each dispatch is also recorded in the JAX package's kernel-dispatch
series (``cometbft_tpu/crypto/batch.py:709-757``), which a node's
``GET /metrics`` serves: ``crypto_kernel_first_dispatch_seconds{kind,
lanes}`` and ``crypto_kernel_first_dispatch_total{kind}`` for the first
dispatch of each (kind, lanes), ``crypto_kernel_dispatch_seconds{kind}``
for the later ones.  ``kind`` is the route (``tables`` for a table
build, whose ``lanes`` are its keys; the verdict routes above, whose
``lanes`` are the batch's).  Beside them ``crypto_kernel_calls_total{
kernel,route}`` serves the counters of ``ops/_build.py`` as they stand:
``route="cuda"`` is ``LAUNCHES`` (one a launch, added at the launch
site), ``route="plain"`` is ``PLAIN_CALLS`` (one a run of a plain
version), every kernel listed, zeros included; and
``torch_cuda_memory_bytes{device,kind}`` the process's caching
allocator on each card it has used (``reserved``, ``peak_reserved``).

:func:`device_call` runs a dispatch on the one device-owner thread (the
counterpart of ``cometbft_tpu/crypto/batch.py:837 _device_call`` in its
patient mode): blocksync's windows, packed on worker threads, and the
verification scheduler's micro-batches (``crypto/scheduler.py``, queued
through :func:`device_submit`) run there one behind the other.  Unlike the JAX package's, the wait has no
bound and nothing falls back to the host: a device error, or a call
that never returns, stays the caller's.
"""

from __future__ import annotations

import asyncio
import collections
import functools
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .. import native as _native
from ..ops import _build
from ..ops import ed25519 as _ed
from ..ops import rlc as _rlc
from ..ops import sha512 as _sha
from ..parallel import mesh as _mesh
from . import plan as _plan

__all__ = ["RLC_MIN_LANES", "DISPATCHES", "HOST_LANES", "BatchVerifier",
           "create_batch_verifier", "verify_dense", "device_verify_ed25519",
           "device_verify_ed25519_cached", "device_call", "device_submit",
           "device_await", "device_jobs_in_flight", "DEVICE_THREAD_NAME",
           "warmup_device"]

# Minimum Ed25519 lanes before the RLC verdict
RLC_MIN_LANES = 128
# validator sets whose device tables stay cached (oldest evicted first)
TABLE_CACHE_ENTRIES = 4
# verdict calls by route
DISPATCHES: collections.Counter = collections.Counter()
# lanes BatchVerifier verified on the host, by key type
HOST_LANES: collections.Counter = collections.Counter()


@functools.cache
def _kprof():
    """The kernel-dispatch series, under the JAX package's names."""
    from ..libs import metrics as m

    return (
        m.gauge("crypto_kernel_first_dispatch_seconds",
                "first dispatch wall time per kernel route and lane count "
                "(the kernels' load when cold)"),
        m.counter("crypto_kernel_first_dispatch_total",
                  "kernel route and lane counts first dispatched in this "
                  "process"),
        m.histogram("crypto_kernel_dispatch_seconds",
                    "device kernel dispatch latency (seen lane counts)",
                    buckets=(0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
                             0.05, 0.1, 0.25, 0.5, 1, 2.5)))


_SEEN_SHAPES: set = set()
_SEEN_LOCK = threading.Lock()


def _note_dispatch(kind: str, lanes: int, seconds: float) -> None:
    """Record one dispatch of route ``kind`` over ``lanes``: the first
    (kind, lanes) sighting sets the first-dispatch gauge and counter and
    a flight-recorder event, repeats go to the histogram."""
    gauge, first, hist = _kprof()
    with _SEEN_LOCK:
        new = (kind, lanes) not in _SEEN_SHAPES
        _SEEN_SHAPES.add((kind, lanes))
    if new:
        gauge.set(seconds, kind=kind, lanes=str(lanes))
        first.inc(kind=kind)
        from ..libs import tracing

        tracing.event("crypto.kernel", "first_dispatch", kind=kind,
                      lanes=lanes, dur_us=int(seconds * 1e6))
    else:
        hist.observe(seconds, kind=kind)


def _kernel_calls():
    for k in _build.KERNELS:
        yield {"kernel": k, "route": "cuda"}, _build.LAUNCHES[k]
        yield {"kernel": k, "route": "plain"}, _build.PLAIN_CALLS[k]


def _cuda_memory():
    if not torch.cuda.is_initialized():
        return
    for i in range(torch.cuda.device_count()):
        if torch.cuda.max_memory_reserved(i):
            yield ({"device": f"cuda:{i}", "kind": "reserved"},
                   torch.cuda.memory_reserved(i))
            yield ({"device": f"cuda:{i}", "kind": "peak_reserved"},
                   torch.cuda.max_memory_reserved(i))


def _serve_counters() -> None:
    from ..libs import metrics as m

    m.sampled("crypto_kernel_calls_total",
              "kernel calls in this process: route cuda counts launches, "
              "route plain runs of the plain version", "counter",
              _kernel_calls)
    m.sampled("torch_cuda_memory_bytes",
              "the caching allocator's device memory in this process",
              "gauge", _cuda_memory)


_serve_counters()


def _tables(pub_t):
    """K5a over ``pub_t``'s keys, its dispatch recorded."""
    t0 = time.perf_counter()
    out = _ed.prepare_pubkey_tables(pub_t)
    _note_dispatch("tables", pub_t.shape[0], time.perf_counter() - t0)
    return out


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


def _per_lane_sharded(mesh, head, lanes):
    """The per-lane ladder over the lane shards of ``mesh``
    (``parallel/mesh.py``: a device tuple or ``Mesh``, or a
    ``ProcessMesh`` whose other ranks' shards this process skips and
    gathers), arguments as
    :func:`_lane_route`'s: each shard runs its slab through the set's
    table replica on its device, or through a table of its own lanes'
    keys.  The batch is checked whole, once; the verdicts come back in
    lane order on the first (local) device."""
    if not isinstance(mesh, _mesh.Mesh):
        mesh = _mesh.Mesh(tuple(mesh))
    devices = mesh.local_view()
    b = lanes[0].shape[0]
    d0 = next(d for d in devices if d is not None)
    outs = []
    if len(head) == 3:
        tabs, oks = (_mesh.replicate(t, devices) for t in head[:2])
        _build.check_arg(tabs[d0], "tab", torch.int32, (None, 16, 4, 10))
        _build.check_arg(oks[d0], "ok_a", torch.bool, (tabs[d0].shape[0],))
        _ed._check_lanes(head[2], tabs[d0].shape[0], *lanes)
        for dev, part in zip(devices, _mesh.split(devices, head[2], *lanes)):
            if dev is not None:
                outs.append(_ed._verify_gather(tabs[dev], oks[dev], *part))
    else:
        _build.check_arg(head[0], "pub", torch.uint8, (b, 32))
        _ed._check_lanes(torch.arange(b, dtype=torch.int32,
                                      device=lanes[0].device), b, *lanes)
        for dev, part in zip(devices, _mesh.split(devices, head[0], *lanes)):
            if dev is not None:
                tab, ok = _tables(part[0])
                sidx = torch.arange(part[0].shape[0], dtype=torch.int32,
                                    device=dev)
                outs.append(_ed._verify_gather(tab, ok, sidx, *part[1:]))
    return mesh.gather_lanes(torch.cat([o.to(d0) for o in outs]), b)


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
        route = ("rlc_gather" if gather else "rlc") + suffix
        DISPATCHES[route] += 1
        fn = (_rlc.make_verify_batch_rlc_sharded(_mesh.Mesh(devices), gather)
              if suffix else _rlc.verify_batch_rlc_gather)
        t0 = time.perf_counter()
        verdict = bool(fn(*head, *lanes, z))
        _note_dispatch(route, b, time.perf_counter() - t0)
        if verdict:
            return np.ones((b,), bool)
    route = ("gather" if gather else "verify") + suffix
    DISPATCHES[route] += 1
    t0 = time.perf_counter()
    out = (_per_lane_sharded(devices, head, lanes) if suffix
           else _ed.verify_padded_gather(*head, *lanes)).cpu().numpy()
    _note_dispatch(route, b, time.perf_counter() - t0)
    return out


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
    tab, ok = _tables(pub_t)
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
                reps[dev] = _tables(torch.from_numpy(
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


# device_await jobs whose result the awaiting loop has not been handed
_AWAITED = [0]
_AWAITED_LOCK = threading.Lock()


def _awaited_done(_f) -> None:
    with _AWAITED_LOCK:
        _AWAITED[0] -= 1


def device_await(fn):
    """``fn()`` on the device-owner thread (:func:`device_submit`) as an
    ``asyncio`` future of the running loop.  The job counts in
    :func:`device_jobs_in_flight` until its result has been queued to the
    loop: the count drops after ``wrap_future``'s own callback has
    written to the loop's self-pipe, so a virtual-time loop
    (``sim/vtime.py``) that reads the count before polling its selector
    never advances its clock while the job runs."""
    with _AWAITED_LOCK:
        _AWAITED[0] += 1
    cfut = device_submit(fn)
    fut = asyncio.wrap_future(cfut)
    cfut.add_done_callback(_awaited_done)
    return fut


def device_jobs_in_flight() -> int:
    """:func:`device_await` jobs not yet handed back to their loop."""
    return _AWAITED[0]


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


def _warm_call(n_keys: int, lanes: int, nb: int, device) -> None:
    """One dispatch of ``lanes`` lanes of ``nb`` SHA-512 blocks through a
    table of ``n_keys`` all-zero keys on ``device``, as the cached route
    makes it (K5a, then K6a from ``RLC_MIN_LANES`` lanes, then K5b), on
    the device-owner thread.  Key and R are the all-zero encoding (a
    point of order 4) and S is 1, so every lane is invalid: the RLC
    verdict rejects and the per-lane route runs.  The table is built for
    this call and never enters ``_TABLES``."""
    def run():
        dev = _plan.resolve_devices(device)[0]
        zeros = np.zeros((lanes, 32), np.uint8)
        ones = zeros.copy()
        ones[:, 0] = 1
        msg_len = nb * 128 - 64 - 17     # the longest that fits nb blocks
        tab, ok = _tables(torch.zeros((n_keys, 32), dtype=torch.uint8,
                                      device=dev))
        idx = torch.zeros((lanes,), dtype=torch.int32, device=dev)
        packed = _padded_lane_args(zeros, zeros, ones,
                                   np.zeros((lanes, msg_len), np.uint8),
                                   np.full((lanes,), msg_len), dev)
        _lane_route((dev,), (tab, ok, idx), packed, None)
    device_call(run)


def warmup_device(lane_buckets=(256, 1024), block_buckets=(2,),
                  device=None, valset_sizes=()) -> int:
    """Launch the commit path's kernels once before the first real commit
    (``cometbft_tpu/crypto/batch.py:443``, which compiles XLA shapes):
    K5a, K6a and K5b at each of ``lane_buckets`` lanes (a table of as
    many keys) and at each of ``valset_sizes`` lanes through a table of
    that many keys (the node's validator set), each at every
    ``block_buckets`` SHA-512 block count.  So the first commit does not
    pay CUDA's lazy load of each kernel, the caching allocator's first
    blocks, or a table build's first launch at the set's size.  Every
    call runs on the device-owner thread (:func:`device_call`), behind
    real work and never beside it; the tables it builds for its own
    all-zero sets never enter, evict or replace an entry of the set
    cache.  Unlike the JAX package's, an error is raised, not counted
    (there is no host to fall back to).  Returns the shapes warmed."""
    done = 0
    for nb in block_buckets:
        for lanes in lane_buckets:
            _warm_call(lanes, lanes, nb, device)
            done += 1
        for n in valset_sizes:
            _warm_call(n, n, nb, device)
            done += 1
    return done


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
    reference's ``crypto.BatchVerifier``), routed as the JAX package's
    ``TpuBatchVerifier`` routes them (``cometbft_tpu/crypto/batch.py:
    985``): Ed25519 lanes in one dense device call; secp256k1 lanes on
    host threads in the native library (``native.
    secp256k1_verify_lanes``), started before the device call and joined
    after it; BLS12-381 lanes one by one in the host library.  No TPU
    kernel computes secp256k1 or a single BLS signature: the JAX package
    verifies those lanes on its host too.  ``verify()`` returns
    ``(all_ok, per_sig)``; an empty batch is not ok.  An Ed25519
    signature that is not 64 bytes is rejected without a launch.
    :data:`HOST_LANES` counts the lanes verified on the host, by key
    type."""

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
        secp = [i for i, (p, _, _) in enumerate(self._items)
                if p.type() == "secp256k1"]
        pending = None
        if secp:
            pending = _native.secp256k1_verify_lanes(
                [(self._items[i][0].bytes(), self._items[i][1],
                  self._items[i][2]) for i in secp])
            HOST_LANES["secp256k1"] += len(secp)
        for i, (pub, m, s) in enumerate(self._items):
            if pub.type() == "bls12_381":
                oks[i] = pub.verify_signature(m, s)
                HOST_LANES["bls12_381"] += 1
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
        if pending is not None:
            for i, ok in zip(secp, pending.result()):
                oks[i] = bool(ok)
        return all(oks), oks


def create_batch_verifier(device=None) -> BatchVerifier:
    """The device batch verifier (``device=None``: the plan's devices,
    raising without a card; ``"cpu"``: the plain versions)."""
    return BatchVerifier(device)
