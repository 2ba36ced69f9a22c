"""On-chain consensus parameters (reference: ``types/params.go``).

Counterpart of ``cometbft_tpu/types/params.py``: block, evidence,
validator, version, feature (the height-gated activation of vote
extensions and PBTS, types/params.go:82-99) and synchrony parameters,
and the params hash pinned into ``Header.consensus_hash``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..crypto import tmhash
from . import wire

__all__ = ["BLOCK_PART_SIZE_BYTES", "MAX_BLOCK_SIZE_BYTES", "BlockParams",
           "EvidenceParams", "ValidatorParams", "VersionParams",
           "FeatureParams", "SynchronyParams", "ConsensusParams",
           "default_consensus_params"]

BLOCK_PART_SIZE_BYTES = 65536        # types/params.go:23
MAX_BLOCK_SIZE_BYTES = 100 * 1024 * 1024


@dataclass
class BlockParams:
    max_bytes: int = 4194304           # 4 MB (types/params.go:159)
    max_gas: int = 10_000_000          # (types/params.go:160)

    def validate(self) -> str | None:
        if self.max_bytes == 0 or self.max_bytes < -1:
            return "block.max_bytes must be -1 or positive"
        if self.max_bytes > MAX_BLOCK_SIZE_BYTES:
            return "block.max_bytes too big"
        if self.max_gas < -1:
            return "block.max_gas must be >= -1"
        return None


@dataclass
class EvidenceParams:
    max_age_num_blocks: int = 100_000
    max_age_duration_ns: int = 48 * 3600 * 1_000_000_000
    max_bytes: int = 1024 * 1024

    def validate(self) -> str | None:
        if self.max_age_num_blocks <= 0:
            return "evidence.max_age_num_blocks must be positive"
        if self.max_age_duration_ns <= 0:
            return "evidence.max_age_duration must be positive"
        return None


@dataclass
class ValidatorParams:
    pub_key_types: list[str] = field(default_factory=lambda: ["ed25519"])

    def validate(self) -> str | None:
        if not self.pub_key_types:
            return "validator.pub_key_types must not be empty"
        return None


@dataclass
class VersionParams:
    app: int = 0


@dataclass
class FeatureParams:
    """Height-gated feature activation; 0 = disabled (types/params.go:82)."""

    vote_extensions_enable_height: int = 0
    pbts_enable_height: int = 0

    def vote_extensions_enabled(self, height: int) -> bool:
        h = self.vote_extensions_enable_height
        return h > 0 and height >= h

    def pbts_enabled(self, height: int) -> bool:
        h = self.pbts_enable_height
        return h > 0 and height >= h


@dataclass
class SynchronyParams:
    """PBTS bounds (types/params.go:121)."""

    precision_ns: int = 505_000_000
    message_delay_ns: int = 15_000_000_000

    def in_timely_bounds(self, proposal_time_ns: int, recv_time_ns: int,
                         round_: int) -> bool:
        """Proposal timeliness with a 10% a round back-off of the message
        delay (internal/consensus/state.go:1364-1376)."""
        delay = self.message_delay_ns
        for _ in range(min(round_, 100)):
            delay = delay * 11 // 10
        lhs = proposal_time_ns - self.precision_ns
        rhs = proposal_time_ns + delay + self.precision_ns
        return lhs <= recv_time_ns <= rhs


@dataclass
class ConsensusParams:
    block: BlockParams = field(default_factory=BlockParams)
    evidence: EvidenceParams = field(default_factory=EvidenceParams)
    validator: ValidatorParams = field(default_factory=ValidatorParams)
    version: VersionParams = field(default_factory=VersionParams)
    feature: FeatureParams = field(default_factory=FeatureParams)
    synchrony: SynchronyParams = field(default_factory=SynchronyParams)

    def validate(self) -> str | None:
        for part in (self.block, self.evidence, self.validator):
            err = part.validate()
            if err:
                return err
        return None

    def hash(self) -> bytes:
        """Params hash pinned into Header.consensus_hash."""
        enc = (wire.field_varint(1, self.block.max_bytes)
               + wire.field_varint(2, self.block.max_gas, force=True)
               + wire.field_varint(3, self.evidence.max_age_num_blocks)
               + wire.field_varint(4, self.version.app)
               + wire.field_varint(5,
                                   self.feature.vote_extensions_enable_height)
               + wire.field_varint(6, self.feature.pbts_enable_height))
        return tmhash.sum_sha256(enc)


def default_consensus_params() -> ConsensusParams:
    return ConsensusParams()
