"""The device mesh: lane shards over a device set.

Counterpart of ``cometbft_tpu/parallel/mesh.py``.  A :class:`Mesh` is a
tuple of ``torch.device``, one per shard; a device may appear more than
once, so one card can run several shards (one after another on its
stream), as the JAX package's tests run its mesh over emulated CPU
devices.  Every per-lane argument is cut into contiguous slabs of
``ceil(B / D)`` lanes (:func:`shard_bounds`: the last one short,
possibly empty); replicated arguments (a validator set's table and ok
mask) are copied once per distinct device (:func:`replicate`).  The
sharded kernels are ``ops/rlc.py:make_verify_batch_rlc_sharded`` (K7)
and the per-lane loop of ``crypto/batch.py``; both take their slabs
from :func:`split`.

Not ported: ``init_multihost`` (``jax.distributed``); a
``torch.distributed`` counterpart stands in ``ROADMAP.md``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..device import resolve_device

__all__ = ["Mesh", "batch_mesh", "shard_bounds", "split", "replicate"]


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


def replicate(x, devices) -> dict:
    """``x`` on every distinct device of ``devices``: a mapping from
    device to tensor is taken as already replicated, a tensor is copied
    once per device (not at all onto its own)."""
    if isinstance(x, dict):
        return x
    return {dev: x.to(dev) for dev in dict.fromkeys(devices)}
