"""BitArray (reference: ``internal/bits/bit_array.go``): vote and part
presence tracking gossiped between peers.

Counterpart of ``cometbft_tpu/libs/bits.py``: a Python integer holds the
bits, bit i for index i."""

from __future__ import annotations

import random

__all__ = ["BitArray"]


class BitArray:
    def __init__(self, size: int, bits: int = 0):
        if size < 0:
            raise ValueError("negative size")
        self.size = size
        self._bits = bits & ((1 << size) - 1)

    @classmethod
    def from_indices(cls, size: int, idxs) -> "BitArray":
        b = cls(size)
        for i in idxs:
            b.set_index(i, True)
        return b

    def get_index(self, i: int) -> bool:
        if not 0 <= i < self.size:
            return False
        return bool((self._bits >> i) & 1)

    def set_index(self, i: int, v: bool) -> bool:
        if not 0 <= i < self.size:
            return False
        if v:
            self._bits |= 1 << i
        else:
            self._bits &= ~(1 << i)
        return True

    def copy(self) -> "BitArray":
        return BitArray(self.size, self._bits)

    def or_(self, other: "BitArray") -> "BitArray":
        return BitArray(max(self.size, other.size), self._bits | other._bits)

    def and_(self, other: "BitArray") -> "BitArray":
        return BitArray(min(self.size, other.size), self._bits & other._bits)

    def not_(self) -> "BitArray":
        return BitArray(self.size, ~self._bits)

    def sub(self, other: "BitArray") -> "BitArray":
        """Bits in self but not in other."""
        return BitArray(self.size, self._bits & ~other._bits)

    def is_empty(self) -> bool:
        return self._bits == 0

    def is_full(self) -> bool:
        return self._bits == (1 << self.size) - 1

    def pick_random(self, rng: random.Random | None = None
                    ) -> tuple[int, bool]:
        """A uniformly random set index (reference PickRandom)."""
        idxs = self.get_true_indices()
        if not idxs:
            return 0, False
        return (rng or random).choice(idxs), True

    def get_true_indices(self) -> list[int]:
        out, bits, i = [], self._bits, 0
        while bits:
            if bits & 1:
                out.append(i)
            bits >>= 1
            i += 1
        return out

    def num_true_bits(self) -> int:
        return bin(self._bits).count("1")

    def __eq__(self, other):
        return (isinstance(other, BitArray) and self.size == other.size
                and self._bits == other._bits)

    def __str__(self):
        return "".join("x" if self.get_index(i) else "_"
                       for i in range(self.size))
