"""PartSet: a block cut into 64 kB parts, each with a merkle proof
(reference: ``types/part_set.go``; part size ``types/params.go:23``).

Counterpart of ``cometbft_tpu/types/part_set.py``.  The proofs come from
``crypto/merkle.py:proofs_from_byte_slices`` (a block has few parts, so
hashlib builds them; ``device`` is read only from
``merkle.MERKLE_KERNEL_MIN_LEAVES`` parts on)."""

from __future__ import annotations

from dataclasses import dataclass

from ..crypto import merkle
from ..libs.bits import BitArray
from .block_id import PartSetHeader
from .params import BLOCK_PART_SIZE_BYTES

__all__ = ["PartSetError", "Part", "PartSet"]


class PartSetError(Exception):
    pass


@dataclass
class Part:
    index: int
    bytes_: bytes
    proof: merkle.Proof

    def validate_basic(self) -> str | None:
        if self.index < 0:
            return "negative index"
        if len(self.bytes_) > BLOCK_PART_SIZE_BYTES:
            return "part too big"
        if self.proof.index != self.index:
            return "proof index mismatch"
        return None


class PartSet:
    """Either built whole from data (the proposer's side) or assembled
    part by part against a trusted header (the receiver's side)."""

    def __init__(self, header: PartSetHeader):
        self.total = header.total
        self.hash = header.hash
        self.parts: list[Part | None] = [None] * header.total
        self.parts_bit_array = BitArray(header.total)
        self.count = 0
        self.byte_size = 0

    @classmethod
    def from_data(cls, data: bytes, part_size: int = BLOCK_PART_SIZE_BYTES,
                  device=None) -> "PartSet":
        chunks = [data[i:i + part_size]
                  for i in range(0, max(len(data), 1), part_size)]
        if not chunks:
            chunks = [b""]
        root, proofs = merkle.proofs_from_byte_slices(chunks, device=device)
        ps = cls(PartSetHeader(len(chunks), root))
        for i, (c, p) in enumerate(zip(chunks, proofs)):
            ps.parts[i] = Part(i, c, p)
            ps.parts_bit_array.set_index(i, True)
        ps.count = len(chunks)
        ps.byte_size = len(data)
        return ps

    def header(self) -> PartSetHeader:
        return PartSetHeader(self.total, self.hash)

    def add_part(self, part: Part) -> bool:
        """Check the part's inclusion proof and store it
        (types/part_set.go:277 AddPart); False for a part already held."""
        err = part.validate_basic()
        if err:
            raise PartSetError(err)
        if part.index >= self.total:
            raise PartSetError("part index out of range")
        if self.parts[part.index] is not None:
            return False
        if not part.proof.verify(self.hash, part.bytes_):
            raise PartSetError("invalid part proof")
        self.parts[part.index] = part
        self.parts_bit_array.set_index(part.index, True)
        self.count += 1
        self.byte_size += len(part.bytes_)
        return True

    def get_part(self, i: int) -> Part | None:
        return self.parts[i] if 0 <= i < self.total else None

    def is_complete(self) -> bool:
        return self.count == self.total

    def get_data(self) -> bytes:
        if not self.is_complete():
            raise PartSetError("part set incomplete")
        return b"".join(p.bytes_ for p in self.parts)

    def bit_array(self) -> BitArray:
        return self.parts_bit_array.copy()
