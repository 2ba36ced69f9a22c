"""Trusted light-block store (reference: ``light/store/db``).

Counterpart of ``cometbft_tpu/light/store.py``: the same keys
(``lb/`` then the height as 8 big-endian bytes) and the same bytes
(``codec.pack`` of ``{"h": header, "c": commit, "v": validators}``) as
the JAX store, over any ``storage.db.KVStore`` (a ``MemDB`` by default).
"""

from __future__ import annotations

from ..storage.db import KVStore, MemDB, height_key
from ..types import codec
from .types import LightBlock

__all__ = ["K_LB", "TrustedStore"]

K_LB = b"lb/"
_END = K_LB + b"\xff" * 12


class TrustedStore:
    def __init__(self, db: KVStore | None = None):
        self.db = db or MemDB()

    def save(self, lb: LightBlock) -> None:
        self.db.set(height_key(K_LB, lb.height), codec.pack(
            {"h": lb.header, "c": lb.commit, "v": lb.validators}))

    @staticmethod
    def _decode(raw: bytes) -> LightBlock:
        d = codec.unpack(raw)
        return LightBlock(header=d["h"], commit=d["c"], validators=d["v"])

    def get(self, height: int) -> LightBlock | None:
        raw = self.db.get(height_key(K_LB, height))
        return self._decode(raw) if raw is not None else None

    def latest(self) -> LightBlock | None:
        best = None
        for _, raw in self.db.iterate(K_LB, _END):
            best = raw
        return self._decode(best) if best is not None else None

    def first(self) -> LightBlock | None:
        for _, raw in self.db.iterate(K_LB, _END):
            return self._decode(raw)
        return None

    def prune(self, keep: int) -> None:
        """Keep the ``keep`` highest light blocks (0 deletes all)."""
        keys = [k for k, _ in self.db.iterate(K_LB, _END)]
        for k in keys[:-keep] if keep else keys:
            self.db.delete(k)
