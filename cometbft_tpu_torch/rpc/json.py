"""JSON projection of domain objects for the RPC surface (counterpart of
``cometbft_tpu/rpc/json.py``): the storage codec's dict form
(``types/codec.py`` ``to_dict``) with bytes rendered as ``{"~b": hex}``,
so that it round-trips through :func:`from_jsonable` and equals the JAX
package's JSON of the same object."""

from __future__ import annotations

from ..types import codec

__all__ = ["jsonable", "from_jsonable"]


def jsonable(obj):
    """codec dict form with bytes -> tagged hex strings."""
    return _hexify(codec.to_dict(obj))


def from_jsonable(data):
    """Inverse of :func:`jsonable`."""
    return codec.from_dict(_unhexify(data))


def _hexify(v):
    if isinstance(v, bytes):
        return {"~b": v.hex()}
    if isinstance(v, list):
        return [_hexify(x) for x in v]
    if isinstance(v, dict):
        return {k: _hexify(x) for k, x in v.items()}
    return v


def _unhexify(v):
    if isinstance(v, dict):
        if set(v.keys()) == {"~b"}:
            return bytes.fromhex(v["~b"])
        return {k: _unhexify(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_unhexify(x) for x in v]
    return v
