"""BlockID and PartSetHeader (reference: ``types/block.go`` BlockID,
``types/part_set.go`` PartSetHeader).

The port's own copy of ``cometbft_tpu/types/block_id.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from . import wire


@dataclass(frozen=True)
class PartSetHeader:
    total: int = 0
    hash: bytes = b""

    def is_zero(self) -> bool:
        return self.total == 0 and not self.hash

    def encode(self) -> bytes:
        return wire.field_varint(1, self.total) + wire.field_bytes(2, self.hash)


@dataclass(frozen=True)
class BlockID:
    hash: bytes = b""
    part_set_header: PartSetHeader = field(default_factory=PartSetHeader)

    def is_nil(self) -> bool:
        return not self.hash and self.part_set_header.is_zero()

    def is_complete(self) -> bool:
        return (len(self.hash) == 32 and self.part_set_header.total > 0
                and len(self.part_set_header.hash) == 32)

    def encode(self) -> bytes:
        """BlockID proto: {bytes hash=1; PartSetHeader part_set_header=2}."""
        psh = self.part_set_header.encode()
        return (wire.field_bytes(1, self.hash)
                + (wire.field_message(2, psh) if psh else b""))

    def encode_canonical(self) -> bytes | None:
        """CanonicalBlockID, or None when nil (field omitted in sign bytes)."""
        if self.is_nil():
            return None
        return (wire.field_bytes(1, self.hash)
                + wire.field_message(2, self.part_set_header.encode(),
                                     force=True))

    def key(self) -> bytes:
        return (self.hash + self.part_set_header.hash
                + self.part_set_header.total.to_bytes(8, "big"))

    def __str__(self):
        return f"{self.hash.hex()[:12]}:{self.part_set_header.total}"
