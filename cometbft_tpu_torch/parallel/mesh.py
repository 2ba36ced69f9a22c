"""The device mesh: lane shards over a device set.

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

Not ported: ``init_multihost`` (``jax.distributed``); a
``torch.distributed`` counterpart stands in ``ROADMAP.md``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..device import resolve_device

__all__ = ["Mesh", "batch_mesh", "shard_bounds", "split", "split_by_device",
           "replicate"]


@dataclass(frozen=True)
class Mesh:
    devices: tuple          # torch.device per shard, repeats allowed

    @property
    def size(self) -> int:
        return len(self.devices)


def batch_mesh(devices=None) -> Mesh:
    """1-D mesh over ``devices`` (default: every visible card)."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        devices = [torch.device("cuda", i) for i in range(n)]
    devs = tuple(resolve_device(d) for d in devices)
    if not devs:
        raise RuntimeError("a mesh needs at least one device")
    return Mesh(devs)


def shard_bounds(b: int, n: int) -> list:
    """``n`` contiguous ``(lo, hi)`` slabs over ``b`` lanes, each
    ``ceil(b / n)`` lanes; the last one short, and empty ones at the end
    where ``b`` runs out."""
    step = -(-b // n) if n else 0
    return [(min(b, i * step), min(b, (i + 1) * step)) for i in range(n)]


def split(devices, *ts) -> list:
    """Per device of ``devices``, its shard's slab of each per-lane
    tensor in ``ts`` (all of one lane count), on that device.  Every slab
    is copied here, before the caller enqueues any shard's kernel: a
    copy out of a card runs on that card's stream, so one enqueued after
    a shard's kernel there would wait for it, and the cards would take
    their shards one after another."""
    bounds = shard_bounds(ts[0].shape[0], len(devices))
    return [[t[lo:hi].to(dev) for t in ts]
            for dev, (lo, hi) in zip(devices, bounds)]


def split_by_device(devices, *ts) -> list:
    """Per distinct device of ``devices``, in order of first appearance:
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
    for dev in dict.fromkeys(devices):
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
    """``x`` on every distinct device of ``devices``: a mapping from
    device to tensor is taken as already replicated, a tensor is copied
    once per device (not at all onto its own)."""
    if isinstance(x, dict):
        return x
    return {dev: x.to(dev) for dev in dict.fromkeys(devices)}
