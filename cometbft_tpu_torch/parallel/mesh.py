"""The device mesh: lane shards over a device set, in one process or over
the processes of a ``torch.distributed`` group.

Counterpart of ``cometbft_tpu/parallel/mesh.py``.  A :class:`Mesh` is a
tuple of ``torch.device``, one per shard; a device may appear more than
once, so one card can run several shards (one after another on its
stream), as the JAX package's tests run its mesh over emulated CPU
devices.  Every per-lane argument is cut into contiguous slabs of
``ceil(B / D)`` lanes (:func:`shard_bounds`: the last one short,
possibly empty); replicated arguments (a validator set's table and ok
mask) are copied once per distinct device (:func:`replicate`).  The
per-lane loop of ``crypto/batch.py`` takes a slab per shard from
:func:`split`; the sharded RLC verdict
(``ops/rlc.py:make_verify_batch_rlc_sharded``, K7) takes one slab per
distinct device, holding all of that device's shards, from
:func:`split_by_device`.

Several processes (:func:`init_multihost`): a :class:`ProcessMesh`'s
shards are every rank's local devices, in rank order, and its shard
bounds are those of one process over as many shards.  The program is
SPMD, as the JAX package's: every rank calls the same
:func:`sharded_kernel` functions in the same order on the same whole
batch, and each runs only its own shards (:meth:`ProcessMesh.
local_view` names the others ``None``, and :func:`split`,
:func:`split_by_device` and :func:`replicate` skip them).  The
collectives run over gloo on host copies (NCCL refuses two ranks on one
card, and the payloads are KBs): the RLC kinds all-gather their stacked
per-shard sums (:meth:`ProcessMesh.gather_slots`; every rank then folds
the whole stack in shard order, so every rank returns the verdict one
process would), the per-lane kinds their verdicts or digests
(:meth:`ProcessMesh.gather_lanes`).  A rank whose shards are empty
still takes part in every collective.  :data:`GATHER_STATS` counts the
collectives, their bytes and their seconds.
"""

from __future__ import annotations

import atexit
import math
import os
import time
from dataclasses import dataclass

import torch

from ..device import resolve_device

__all__ = ["Mesh", "ProcessMesh", "batch_mesh", "init_multihost",
           "sharded_kernel", "sharded_verify_fn", "shard_bounds", "split",
           "split_by_device", "replicate", "GATHER_STATS", "KINDS"]

# the kinds of sharded_kernel (cometbft_tpu/parallel/mesh.py:97)
KINDS = ("verify", "gather", "rlc", "rlc_gather", "merkle_level")
# a rank that never reaches the rendezvous (or a collective) fails the
# call after this many seconds instead of hanging it
DEFAULT_TIMEOUT_S = 60.0
# collectives of ProcessMesh: calls, bytes a rank sent, seconds
GATHER_STATS = {"calls": 0, "bytes": 0, "seconds": 0.0}


@dataclass(frozen=True)
class Mesh:
    devices: tuple          # torch.device per shard, repeats allowed

    @property
    def size(self) -> int:
        return len(self.devices)

    def local_view(self) -> tuple:
        """The shard list with the shards of other processes as None:
        in one process, every shard."""
        return self.devices

    def gather_slots(self, *ts) -> None:
        """Nothing to gather in one process (see :class:`ProcessMesh`)."""

    def gather_lanes(self, x, b: int):
        """The whole ``(B, ...)`` result: in one process, ``x`` itself."""
        return x


@dataclass(frozen=True)
class ProcessMesh(Mesh):
    """The mesh of :func:`init_multihost`: ``devices`` is every rank's
    local devices in rank order (as each rank names its own), ``counts``
    the shards of each rank, ``rank`` this process's, ``group`` the gloo
    group the collectives run on."""

    counts: tuple = ()
    rank: int = 0
    group: object = None

    @property
    def world_size(self) -> int:
        return len(self.counts)

    @property
    def first(self) -> int:
        """The index of this rank's first shard."""
        return sum(self.counts[:self.rank])

    def local_view(self) -> tuple:
        lo, n = self.first, self.counts[self.rank]
        return tuple(d if lo <= i < lo + n else None
                     for i, d in enumerate(self.devices))

    def _all_gather(self, rows: torch.Tensor) -> list:
        """``rows`` (R, W) uint8 of this rank, padded to ``r_max`` rows by
        every rank alike, gathered from every rank over the group on
        host copies."""
        import torch.distributed as dist

        t0 = time.perf_counter()
        host = rows.cpu()
        out = [torch.empty_like(host) for _ in range(self.world_size)]
        dist.all_gather(out, host, group=self.group)
        GATHER_STATS["calls"] += 1
        GATHER_STATS["bytes"] += host.numel()
        GATHER_STATS["seconds"] += time.perf_counter() - t0
        return out

    def gather_slots(self, *ts) -> None:
        """Fill, in place, the slots of the other ranks' shards in the
        stacked per-shard tensors ``ts`` (each of leading size
        :attr:`size`, contiguous, on one device), sending this rank's
        own: one all-gather of every rank's slot rows."""
        lo, n = self.first, self.counts[self.rank]
        widths = [math.prod(t.shape[1:]) * t.element_size() for t in ts]
        r_max = max(self.counts)
        rows = torch.zeros((r_max, sum(widths)), dtype=torch.uint8)
        rows[:n] = torch.cat([_byte_rows(t[lo:lo + n]).cpu() for t in ts], 1)
        got = self._all_gather(rows)
        off = 0
        for r, c in enumerate(self.counts):
            if r != self.rank:
                col = 0
                for t, w in zip(ts, widths):
                    t[off:off + c] = _from_byte_rows(
                        got[r][:c, col:col + w], t).to(t.device)
                    col += w
            off += c

    def gather_lanes(self, x, b: int):
        """The whole ``(B, ...)`` result from this rank's rows ``x`` (its
        shards' lanes, in order): one all-gather of every rank's rows."""
        bounds = shard_bounds(b, self.size)
        spans, off = [], 0
        for c in self.counts:
            spans.append((bounds[off][0], bounds[off + c - 1][1]))
            off += c
        n = [hi - lo for lo, hi in spans]
        if x.shape[0] != n[self.rank]:
            raise ValueError(f"rank {self.rank} holds {n[self.rank]} lanes, "
                             f"got {x.shape[0]} rows")
        width = math.prod(x.shape[1:]) * x.element_size()
        rows = torch.zeros((max(n), width), dtype=torch.uint8)
        rows[:n[self.rank]] = _byte_rows(x).cpu()
        got = self._all_gather(rows)
        full = torch.cat([g[:c] for g, c in zip(got, n)])
        return _from_byte_rows(full, x).to(x.device)


def _byte_rows(t: torch.Tensor) -> torch.Tensor:
    """(R, ...) -> (R, bytes a row) uint8, the same memory."""
    return t.contiguous().reshape(t.shape[0], math.prod(t.shape[1:])).view(
        torch.uint8)


def _from_byte_rows(rows: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """:func:`_byte_rows` undone, to ``like``'s dtype and row shape (a
    copy: a column slice's row stride need not be whole elements)."""
    return rows.clone(memory_format=torch.contiguous_format).view(
        like.dtype).reshape(rows.shape[0], *like.shape[1:])


def batch_mesh(devices=None) -> Mesh:
    """1-D mesh over ``devices`` (default: every visible card)."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        devices = [torch.device("cuda", i) for i in range(n)]
    devs = tuple(resolve_device(d) for d in devices)
    if not devs:
        raise RuntimeError("a mesh needs at least one device")
    return Mesh(devs)


def _device_list(device) -> list:
    if isinstance(device, (list, tuple)):
        return list(device)
    return [device]


def _env_coordinator() -> str | None:
    addr, port = os.environ.get("MASTER_ADDR"), os.environ.get("MASTER_PORT")
    return f"{addr}:{port}" if addr and port else None


def _destroy_group() -> None:
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def init_multihost(coordinator: str | None = None,
                   num_processes: int | None = None,
                   process_id: int | None = None, device=None,
                   timeout_s: float = DEFAULT_TIMEOUT_S) -> Mesh:
    """Multi-process mesh: initialise the ``torch.distributed`` process
    group (every process runs this with the same coordinator) and return
    the :class:`ProcessMesh` over every process's devices.

    ``coordinator`` is ``host:port`` (or ``tcp://host:port``) of rank 0's
    rendezvous; ``num_processes`` and ``process_id`` the world size and
    this process's rank.  Unlike the JAX package, which reads
    ``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES`` and
    ``JAX_PROCESS_ID``, the defaults are the PyTorch launcher's own
    variables: ``MASTER_ADDR``:``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``
    (the ``JAX_*`` variables are not read).  As in the JAX package,
    ``num_processes`` or ``process_id`` without a coordinator raises
    ``ValueError``, no coordinator at all returns the one-process
    :func:`batch_mesh` (over ``device`` where given) and initialises
    nothing, and a group already initialised is reused, not initialised
    again.

    ``device`` is this rank's device, or a list of them (its local
    shards; repeats allowed); by default ``cuda:(LOCAL_RANK %
    device_count)`` (``LOCAL_RANK`` defaults to the rank), raising
    without a card.  The group is gloo, whatever devices the ranks use
    (over a default group of another backend a gloo group of the same
    ranks is made); ``timeout_s`` bounds the rendezvous and every
    collective, so a rank that never arrives fails the call.  The group
    is destroyed at the interpreter's exit."""
    import datetime

    import torch.distributed as dist

    coordinator = coordinator or _env_coordinator()
    if coordinator is None and (num_processes is not None
                                or process_id is not None):
        raise ValueError("num_processes/process_id given without a "
                         "coordinator address")
    if not coordinator:
        return batch_mesh(None if device is None else _device_list(device))
    if num_processes is None and "WORLD_SIZE" in os.environ:
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None and "RANK" in os.environ:
        process_id = int(os.environ["RANK"])
    timeout = datetime.timedelta(seconds=timeout_s)
    if dist.is_initialized():
        rank, world = dist.get_rank(), dist.get_world_size()
        if (num_processes is not None and num_processes != world) or \
                (process_id is not None and process_id != rank):
            raise ValueError(
                f"the process group is initialised as rank {rank} of "
                f"{world}, not {process_id} of {num_processes}")
    else:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator needs num_processes and "
                             "process_id (or WORLD_SIZE and RANK)")
        rank, world = process_id, num_processes
    if device is None:
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
        if not torch.cuda.is_available():
            raise RuntimeError(
                "init_multihost: no CUDA card and no device given; pass "
                "device='cpu' to run the plain versions")
        device = torch.device("cuda", local_rank % torch.cuda.device_count())
    local = [resolve_device(d) for d in _device_list(device)]
    if not local:
        raise RuntimeError("a rank needs at least one device")
    if not dist.is_initialized():
        host = coordinator.removeprefix("tcp://")
        dist.init_process_group("gloo", init_method=f"tcp://{host}",
                                world_size=world, rank=rank, timeout=timeout)
        atexit.register(_destroy_group)
    group = (dist.group.WORLD if dist.get_backend() == "gloo"
             else dist.new_group(backend="gloo", timeout=timeout))
    names = [None] * world
    dist.all_gather_object(names, [str(d) for d in local], group=group)
    return ProcessMesh(tuple(torch.device(n) for r in names for n in r),
                       counts=tuple(len(r) for r in names), rank=rank,
                       group=group)


def shard_bounds(b: int, n: int) -> list:
    """``n`` contiguous ``(lo, hi)`` slabs over ``b`` lanes, each
    ``ceil(b / n)`` lanes; the last one short, and empty ones at the end
    where ``b`` runs out."""
    step = -(-b // n) if n else 0
    return [(min(b, i * step), min(b, (i + 1) * step)) for i in range(n)]


def split(devices, *ts) -> list:
    """Per device of ``devices``, its shard's slab of each per-lane
    tensor in ``ts`` (all of one lane count), on that device; None for a
    shard whose device is None (another process's).  Every slab is
    copied here, before the caller enqueues any shard's kernel: a copy
    out of a card runs on that card's stream, so one enqueued after a
    shard's kernel there would wait for it, and the cards would take
    their shards one after another."""
    bounds = shard_bounds(ts[0].shape[0], len(devices))
    return [None if dev is None else [t[lo:hi].to(dev) for t in ts]
            for dev, (lo, hi) in zip(devices, bounds)]


def split_by_device(devices, *ts) -> list:
    """Per distinct device of ``devices`` (None, another process's
    shards, left out), in order of first appearance:
    ``(device, slots, offsets, slab)``, where ``slots`` are the indices of
    the shards that device holds, ``offsets`` the ``len(slots) + 1`` lane
    offsets of those shards within the slab, and ``slab`` each per-lane
    tensor of ``ts`` cut to those shards' lanes, in shard order, on that
    device (one copy of a contiguous run of shards; the tensors
    themselves where one device holds every shard and they lie there).
    Every slab is copied before the caller enqueues any kernel, as in
    :func:`split`."""
    b = ts[0].shape[0]
    bounds = shard_bounds(b, len(devices))
    out = []
    for dev in dict.fromkeys(d for d in devices if d is not None):
        slots = [d for d, x in enumerate(devices) if x == dev]
        offs = [0]
        for d in slots:
            offs.append(offs[-1] + bounds[d][1] - bounds[d][0])
        if len(slots) == len(devices) and all(t.device == dev for t in ts):
            slab = list(ts)
        elif slots == list(range(slots[0], slots[-1] + 1)):
            lo, hi = bounds[slots[0]][0], bounds[slots[-1]][1]
            slab = [t[lo:hi].to(dev) for t in ts]
        else:
            slab = [torch.cat([t[slice(*bounds[d])] for d in slots]).to(dev)
                    for t in ts]
        out.append((dev, slots, offs, slab))
    return out


def replicate(x, devices) -> dict:
    """``x`` on every distinct device of ``devices`` (None left out): a
    mapping from device to tensor is taken as already replicated, a
    tensor is copied once per device (not at all onto its own)."""
    if isinstance(x, dict):
        return x
    return {dev: x.to(dev) for dev in dict.fromkeys(devices)
            if dev is not None}


def sharded_kernel(kind: str, devices=None, mesh: Mesh | None = None):
    """The ``kind`` kernel (:data:`KINDS`) as one sharded program over
    ``mesh`` (built from ``devices`` when not given; a
    :class:`ProcessMesh` runs this rank's shards and gathers the rest),
    on the JAX package's arguments in the port's dtypes:

    - ``verify``: ``fn(pub, rb, sb, blocks, active)``, a table of each
      shard's own keys, ``(B,)`` bool verdicts;
    - ``gather``: ``fn(tab, ok_a, idx, rb, sb, blocks, active)`` through
      a validator set's table, ``(B,)`` bool verdicts;
    - ``rlc``, ``rlc_gather``: the same arguments and ``z``, the 0-d
      bool RLC verdict (``ops/rlc.py:make_verify_batch_rlc_sharded``);
    - ``merkle_level``: ``fn(left, right)``, (B, 8) int32 child words ->
      (B, 8) parent words.

    Every shard's slab is copied to its device before any kernel is
    enqueued; the result lies on the first (local) device.  Replaces
    ``cometbft_tpu/parallel/mesh.py:114``; no shape needs to divide the
    mesh (ragged and empty shards are taken)."""
    from ..crypto import batch as _batch
    from ..ops import rlc as _rlc
    from ..ops import sha256 as _sha

    if mesh is None:
        mesh = batch_mesh(devices)
    if kind in ("rlc", "rlc_gather"):
        return _rlc.make_verify_batch_rlc_sharded(
            mesh, gather=kind == "rlc_gather")
    if kind in ("verify", "gather"):
        n_head = 1 if kind == "verify" else 3

        def per_lane(*args):
            return _batch._per_lane_sharded(mesh, args[:n_head],
                                            args[n_head:])
        return per_lane
    if kind == "merkle_level":
        def level(left, right):
            b = left.shape[0]
            view = mesh.local_view()
            d0 = next(d for d in view if d is not None)
            outs = [_sha.merkle_inner_level(*part).to(d0)
                    for part in split(view, left, right) if part is not None]
            return mesh.gather_lanes(torch.cat(outs), b)
        return level
    raise KeyError(f"no sharded kernel target for {kind!r}")


def sharded_verify_fn(mesh: Mesh):
    """The per-lane verify program over ``mesh`` (the JAX package's
    historical name; :func:`sharded_kernel` ``"verify"``)."""
    return sharded_kernel("verify", mesh=mesh)
