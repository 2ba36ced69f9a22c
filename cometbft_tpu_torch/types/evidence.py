"""Evidence of Byzantine behaviour (reference: ``types/evidence.go``).

Counterpart of ``cometbft_tpu/types/evidence.py``: ``DuplicateVoteEvidence``
(two signed votes of one validator for the same height, round and type
but different blocks, ``types/evidence.go:36``) and
``LightClientAttackEvidence`` (a conflicting light block,
``types/evidence.go:210``), their encodings and hashes, and the merkle
hash of an evidence list over the port's ``crypto/merkle.py``.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from dataclasses import dataclass, field

from ..crypto import merkle, tmhash
from . import wire
from .validator_set import ValidatorSet
from .vote import Vote

__all__ = ["EvidenceError", "Evidence", "DuplicateVoteEvidence",
           "LightClientAttackEvidence", "evidence_list_hash"]


class EvidenceError(Exception):
    pass


class Evidence(ABC):
    @abstractmethod
    def height(self) -> int: ...

    @abstractmethod
    def time_ns(self) -> int: ...

    @abstractmethod
    def hash(self) -> bytes: ...

    @abstractmethod
    def encode(self) -> bytes: ...

    @abstractmethod
    def validate_basic(self) -> str | None: ...

    @abstractmethod
    def abci_kind(self) -> str: ...


@dataclass
class DuplicateVoteEvidence(Evidence):
    vote_a: Vote
    vote_b: Vote
    total_voting_power: int = 0
    validator_power: int = 0
    timestamp_ns: int = 0

    @classmethod
    def from_votes(cls, vote1: Vote, vote2: Vote, block_time_ns: int,
                   val_set: ValidatorSet) -> "DuplicateVoteEvidence":
        """The votes ordered by BlockID key (types/evidence.go:66)."""
        if vote1 is None or vote2 is None or val_set is None:
            raise EvidenceError("missing vote or validator set")
        idx, val = val_set.get_by_address(vote1.validator_address)
        if idx < 0:
            raise EvidenceError("validator not in set")
        a, b = sorted((vote1, vote2), key=lambda v: v.block_id.key())
        return cls(vote_a=a, vote_b=b,
                   total_voting_power=val_set.total_voting_power(),
                   validator_power=val.voting_power,
                   timestamp_ns=block_time_ns)

    def height(self) -> int:
        return self.vote_a.height

    def time_ns(self) -> int:
        return self.timestamp_ns

    def encode(self) -> bytes:
        return (wire.field_message(1, self.vote_a.encode(), force=True)
                + wire.field_message(2, self.vote_b.encode(), force=True)
                + wire.field_varint(3, self.total_voting_power)
                + wire.field_varint(4, self.validator_power)
                + wire.field_varint(5, self.timestamp_ns))

    def hash(self) -> bytes:
        return tmhash.sum_sha256(b"duplicate-vote" + self.encode())

    def validate_basic(self) -> str | None:
        a, b = self.vote_a, self.vote_b
        if a is None or b is None:
            return "missing vote"
        if a.block_id.key() >= b.block_id.key():
            return "votes not ordered by block id"
        for v in (a, b):
            err = v.validate_basic()
            if err:
                return f"invalid vote: {err}"
        if (a.height, a.round, a.type) != (b.height, b.round, b.type):
            return "votes from different height/round/type"
        if a.validator_address != b.validator_address:
            return "votes from different validators"
        if a.block_id == b.block_id:
            return "votes for the same block"
        return None

    def abci_kind(self) -> str:
        return "DUPLICATE_VOTE"


@dataclass
class LightClientAttackEvidence(Evidence):
    """A conflicting light block seen by a light client
    (types/evidence.go:210); ``conflicting_block`` is the
    ``light.types.LightBlock``, typed loosely to keep ``light`` out of
    this module's imports."""

    conflicting_header_hash: bytes
    conflicting_height: int
    common_height: int
    byzantine_validators: list = field(default_factory=list)
    total_voting_power: int = 0
    timestamp_ns: int = 0
    conflicting_block: object = None

    def height(self) -> int:
        return self.common_height

    def time_ns(self) -> int:
        return self.timestamp_ns

    def encode(self) -> bytes:
        return (wire.field_bytes(1, self.conflicting_header_hash)
                + wire.field_varint(2, self.conflicting_height)
                + wire.field_varint(3, self.common_height)
                + wire.field_varint(4, self.total_voting_power)
                + wire.field_varint(5, self.timestamp_ns))

    def hash(self) -> bytes:
        return tmhash.sum_sha256(b"light-client-attack" + self.encode())

    def validate_basic(self) -> str | None:
        if not self.conflicting_header_hash:
            return "missing conflicting header"
        if self.common_height <= 0:
            return "non-positive common height"
        if self.conflicting_height < self.common_height:
            return "conflicting height below common height"
        return None

    def abci_kind(self) -> str:
        return "LIGHT_CLIENT_ATTACK"


def evidence_list_hash(evidence: list[Evidence], device=None) -> bytes:
    """Merkle root of the evidence hashes; at
    ``merkle.MERKLE_KERNEL_MIN_LEAVES`` items or more it is hashed by the
    kernels on ``device`` (None: CUDA)."""
    return merkle.hash_from_byte_slices_fast([e.hash() for e in evidence],
                                             device=device)
