"""Fixed-size LRU cache of tx keys (counterpart of
``cometbft_tpu/mempool/cache.py``; reference: ``mempool/cache.go``)."""

from __future__ import annotations

from collections import OrderedDict

__all__ = ["LRUTxCache"]


class LRUTxCache:
    def __init__(self, size: int = 10_000):
        self.capacity = size
        self._map: OrderedDict[bytes, None] = OrderedDict()

    def push(self, key: bytes) -> bool:
        """Returns False if the key was already present."""
        if key in self._map:
            self._map.move_to_end(key)
            return False
        self._map[key] = None
        if len(self._map) > self.capacity:
            self._map.popitem(last=False)
        return True

    def remove(self, key: bytes) -> None:
        self._map.pop(key, None)

    def has(self, key: bytes) -> bool:
        """Membership probe, refreshing recency: the announce-dedup path
        consults this for every announced hash, and a tx that keeps
        being announced (recently committed, still flooding the net)
        should stay cached — evicting it would buy the next announce a
        pointless fetch round trip."""
        if key in self._map:
            self._map.move_to_end(key)
            return True
        return False

    def __len__(self) -> int:
        return len(self._map)

    def reset(self) -> None:
        self._map.clear()
