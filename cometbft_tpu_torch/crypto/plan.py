"""The device set: which devices a batch runs on.

Counterpart of the device-set half of ``cometbft_tpu/crypto/plan.py``
(``set_devices``/``resolve_devices``, :242-276).  :func:`set_devices`
is the one way to choose a device set; it may name one card more than
once, so one card can run several shards, as the JAX package's tests run
its mesh over emulated CPU devices.

Not ported, because the port's kernels take any lane count: the lane,
block, table, merkle and BLS buckets, ``chunk_bucket``,
``mesh_occupancy``, ``window_blocks``, the warm set and ``plan_hash``
(the AOT bundle and blocksync's window stand in ``ROADMAP.md``).  Nor
are the plan's settable fields: the RLC threshold is the constant
``crypto/batch.py:RLC_MIN_LANES``, and the mesh shape and axis name
have no reader here.
"""

from __future__ import annotations

import torch

from ..device import resolve_device

__all__ = ["set_devices", "resolve_devices"]

_DEVICES: tuple | None = None    # explicit device set


def set_devices(devices) -> None:
    """Shard every batch over these devices (``torch.device`` or names;
    one device may be named more than once).  None or an empty list
    clears the set."""
    global _DEVICES
    _DEVICES = (tuple(resolve_device(d) for d in devices) if devices
                else None)


def resolve_devices(device=None) -> tuple:
    """The devices a batch runs on: an explicit ``device`` alone; else
    the :func:`set_devices` set; else every visible card where there is
    more than one; else CUDA, which raises without a card."""
    if device is not None:
        return (resolve_device(device),)
    if _DEVICES is not None:
        return _DEVICES
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count > 1:
        return tuple(torch.device("cuda", i) for i in range(count))
    return (resolve_device(None),)
