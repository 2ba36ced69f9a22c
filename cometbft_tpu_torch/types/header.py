"""Header, Data and Block (reference: ``types/block.go:1-600``).

Counterpart of ``cometbft_tpu/types/header.py``.  ``Header.hash`` is the
merkle root of the 14 proto-encoded header fields, so it stays on
hashlib; ``Data.hash`` (the merkle root of the transactions' SHA-256
hashes), the last commit's hash and the evidence hash take the kernel
route at ``merkle.MERKLE_KERNEL_MIN_LEAVES`` leaves or more, on the
``device`` a ``Block`` method is given (None: CUDA).  ``Block.hash`` is
its header's.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..crypto import merkle, tmhash
from . import canonical, wire
from .block_id import BlockID
from .commit import Commit

__all__ = ["BLOCK_PROTOCOL_VERSION", "Header", "Data", "Block", "tx_hash"]

BLOCK_PROTOCOL_VERSION = 11  # version/version.go BlockProtocol


def _string_value(s: str) -> bytes:
    return wire.field_string(1, s)


def _bytes_value(b: bytes) -> bytes:
    return wire.field_bytes(1, b)


def _int64_value(v: int) -> bytes:
    return wire.field_varint(1, v)


@dataclass
class Header:
    chain_id: str
    height: int
    time_ns: int
    last_block_id: BlockID = field(default_factory=BlockID)
    last_commit_hash: bytes = b""
    data_hash: bytes = b""
    validators_hash: bytes = b""
    next_validators_hash: bytes = b""
    consensus_hash: bytes = b""
    app_hash: bytes = b""
    last_results_hash: bytes = b""
    evidence_hash: bytes = b""
    proposer_address: bytes = b""
    version_block: int = BLOCK_PROTOCOL_VERSION
    version_app: int = 0

    def version_encode(self) -> bytes:
        return (wire.field_varint(1, self.version_block)
                + wire.field_varint(2, self.version_app))

    def hash(self) -> bytes:
        """Merkle root over the proto-encoded fields (types/block.go:432),
        or b"" when the header is incomplete (validators_hash unset), like
        the reference's nil return."""
        if not self.validators_hash:
            return b""
        fields = [
            self.version_encode(),
            _string_value(self.chain_id),
            _int64_value(self.height),
            canonical.encode_timestamp(self.time_ns),
            self.last_block_id.encode(),
            _bytes_value(self.last_commit_hash),
            _bytes_value(self.data_hash),
            _bytes_value(self.validators_hash),
            _bytes_value(self.next_validators_hash),
            _bytes_value(self.consensus_hash),
            _bytes_value(self.app_hash),
            _bytes_value(self.last_results_hash),
            _bytes_value(self.evidence_hash),
            _bytes_value(self.proposer_address),
        ]
        return merkle.hash_from_byte_slices(fields)

    def validate_basic(self) -> str | None:
        if not self.chain_id or len(self.chain_id) > 50:
            return "chain_id empty or too long"
        if self.height < 0:
            return "negative height"
        if self.height > 1 and self.last_block_id.is_nil():
            return "nil last_block_id after height 1"
        if self.proposer_address and len(self.proposer_address) != 20:
            return "invalid proposer address size"
        return None

    def encode(self) -> bytes:
        """Wire proto of the full header (for part sets and storage)."""
        return (wire.field_message(1, self.version_encode(), force=True)
                + wire.field_string(2, self.chain_id)
                + wire.field_varint(3, self.height)
                + wire.field_message(4, canonical.encode_timestamp(
                    self.time_ns), force=True)
                + wire.field_message(5, self.last_block_id.encode(),
                                     force=True)
                + wire.field_bytes(6, self.last_commit_hash)
                + wire.field_bytes(7, self.data_hash)
                + wire.field_bytes(8, self.validators_hash)
                + wire.field_bytes(9, self.next_validators_hash)
                + wire.field_bytes(10, self.consensus_hash)
                + wire.field_bytes(11, self.app_hash)
                + wire.field_bytes(12, self.last_results_hash)
                + wire.field_bytes(13, self.evidence_hash)
                + wire.field_bytes(14, self.proposer_address))


def tx_hash(tx: bytes) -> bytes:
    return tmhash.sum_sha256(tx)


@dataclass
class Data:
    txs: list[bytes] = field(default_factory=list)

    def hash(self, device=None) -> bytes:
        return merkle.hash_from_byte_slices_fast(
            [tx_hash(t) for t in self.txs], device=device)


@dataclass
class Block:
    header: Header
    data: Data = field(default_factory=Data)
    evidence: list = field(default_factory=list)
    last_commit: Commit | None = None

    def hash(self) -> bytes:
        return self.header.hash()

    def fill_hashes(self, device=None) -> None:
        """Set the header's derived hashes from the contents (block
        construction)."""
        self.header.data_hash = self.data.hash(device)
        if self.last_commit is not None:
            self.header.last_commit_hash = self.last_commit.hash(device)
        self.header.evidence_hash = merkle.hash_from_byte_slices_fast(
            [e.hash() for e in self.evidence], device=device)

    def validate_basic(self, device=None) -> str | None:
        err = self.header.validate_basic()
        if err:
            return err
        if self.header.height > 1:
            if self.last_commit is None:
                return "nil last_commit"
            err = self.last_commit.validate_basic()
            if err:
                return f"invalid last_commit: {err}"
            if self.header.last_commit_hash != self.last_commit.hash(device):
                return "wrong last_commit_hash"
        if self.header.data_hash != self.data.hash(device):
            return "wrong data_hash"
        return None

    def encode(self) -> bytes:
        """Wire proto of the block (header=1, data=2, evidence=3,
        commit=4)."""
        data_enc = b"".join(wire.field_bytes(1, t, force=True)
                            for t in self.data.txs)
        ev_enc = b"".join(wire.field_message(1, e.encode(), force=True)
                          for e in self.evidence)
        out = (wire.field_message(1, self.header.encode(), force=True)
               + wire.field_message(2, data_enc, force=True)
               + wire.field_message(3, ev_enc, force=True))
        if self.last_commit is not None:
            out += wire.field_message(4, self.last_commit.encode(),
                                      force=True)
        return out
