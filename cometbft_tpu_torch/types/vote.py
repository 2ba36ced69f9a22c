"""Vote and Proposal (reference: ``types/vote.go``, ``types/proposal.go``).

Counterpart of ``cometbft_tpu/types/vote.py``: sign bytes (BLS keys sign
the zero-timestamp aggregation domain), basic checks, single-signature
verification through the port's keys, the wire encoding and copies.
The consensus paths that gossip votes come with a later slice.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

from . import canonical, wire
from .block_id import BlockID

__all__ = ["PREVOTE_TYPE", "PRECOMMIT_TYPE", "PROPOSAL_TYPE",
           "MAX_VOTE_EXTENSION_SIZE", "Vote", "Proposal"]

PREVOTE_TYPE = canonical.SIGNED_MSG_TYPE_PREVOTE
PRECOMMIT_TYPE = canonical.SIGNED_MSG_TYPE_PRECOMMIT
PROPOSAL_TYPE = canonical.SIGNED_MSG_TYPE_PROPOSAL

MAX_VOTE_EXTENSION_SIZE = 1024 * 1024


@dataclass
class Vote:
    """A single prevote or precommit.  ``extension`` and
    ``extension_signature`` appear only on precommits with vote
    extensions enabled."""

    type: int
    height: int
    round: int
    block_id: BlockID
    timestamp_ns: int
    validator_address: bytes
    validator_index: int
    signature: bytes = b""
    extension: bytes = b""
    extension_signature: bytes = b""
    # sign-bytes memos, keyed by every field the encoding reads, so an
    # edited vote never serves stale bytes; outside equality and repr
    _sb_memo: tuple | None = field(default=None, compare=False, repr=False)
    _sbz_memo: tuple | None = field(default=None, compare=False, repr=False)

    def _memo_sign_bytes(self, chain_id: str, ts: int, slot: str) -> bytes:
        guard = (chain_id, self.type, self.height, self.round,
                 self.block_id, ts)
        memo = getattr(self, slot)
        if memo is not None and memo[0] == guard:
            return memo[1]
        sb = canonical.canonical_vote_sign_bytes(
            chain_id, self.type, self.height, self.round, self.block_id, ts)
        setattr(self, slot, (guard, sb))
        return sb

    def sign_bytes(self, chain_id: str) -> bytes:
        return self._memo_sign_bytes(chain_id, self.timestamp_ns, "_sb_memo")

    def sign_bytes_for(self, chain_id: str, key_type: str) -> bytes:
        """Sign bytes for the signer's key type: BLS keys sign the
        canonical vote with the timestamp zero (one message per block, so
        a cohort folds into one aggregate); Ed25519 keys sign the
        reference encoding."""
        if key_type != "bls12_381":
            return self.sign_bytes(chain_id)
        return self._memo_sign_bytes(chain_id, 0, "_sbz_memo")

    def extension_sign_bytes(self, chain_id: str) -> bytes:
        return canonical.canonical_vote_extension_sign_bytes(
            chain_id, self.height, self.round, self.extension)

    def is_nil(self) -> bool:
        return self.block_id.is_nil()

    def validate_basic(self) -> str | None:
        """An error string, or None (types/vote.go ValidateBasic)."""
        if self.type not in (PREVOTE_TYPE, PRECOMMIT_TYPE):
            return "invalid vote type"
        if self.height < 1:
            return "negative or zero height"
        if self.round < 0:
            return "negative round"
        if not self.block_id.is_nil() and not self.block_id.is_complete():
            return "blockID must be either empty or complete"
        if len(self.validator_address) != 20:
            return "invalid validator address size"
        if self.validator_index < 0:
            return "negative validator index"
        if not self.signature:
            return "signature is missing"
        if len(self.signature) > 96:      # 64 ed25519, 96 bls12_381 G2
            return "signature too big"
        if self.type != PRECOMMIT_TYPE and (self.extension or
                                            self.extension_signature):
            return "vote extension on non-precommit"
        return None

    def verify(self, chain_id: str, pub_key) -> bool:
        """Single-signature verification (types/vote.go:235), the sign
        bytes following the key type."""
        return pub_key.verify_signature(
            self.sign_bytes_for(chain_id, pub_key.type()), self.signature)

    def verify_vote_and_extension(self, chain_id: str, pub_key,
                                  require_extension: bool) -> bool:
        """types/vote.go:244 VerifyVoteAndExtension."""
        if not self.verify(chain_id, pub_key):
            return False
        if require_extension and self.type == PRECOMMIT_TYPE \
                and not self.block_id.is_nil():
            return self.verify_extension(chain_id, pub_key)
        return True

    def verify_extension(self, chain_id: str, pub_key) -> bool:
        """types/vote.go:265 VerifyExtension."""
        return pub_key.verify_signature(self.extension_sign_bytes(chain_id),
                                        self.extension_signature)

    def encode(self) -> bytes:
        """Wire proto (types.proto Vote)."""
        return (wire.field_varint(1, self.type)
                + wire.field_varint(2, self.height)
                + wire.field_varint(3, self.round, force=False)
                + wire.field_message(4, self.block_id.encode() or b"")
                + wire.field_message(5, canonical.encode_timestamp(
                    self.timestamp_ns), force=True)
                + wire.field_bytes(6, self.validator_address)
                + wire.field_varint(7, self.validator_index, force=False)
                + wire.field_bytes(8, self.signature)
                + wire.field_bytes(9, self.extension)
                + wire.field_bytes(10, self.extension_signature))

    def copy(self) -> "Vote":
        return replace(self)


@dataclass
class Proposal:
    """Block proposal (types/proposal.go)."""

    height: int
    round: int
    pol_round: int          # -1 without a proof of lock
    block_id: BlockID
    timestamp_ns: int
    signature: bytes = b""

    def sign_bytes(self, chain_id: str) -> bytes:
        return canonical.canonical_proposal_sign_bytes(
            chain_id, self.height, self.round, self.pol_round, self.block_id,
            self.timestamp_ns)

    def validate_basic(self) -> str | None:
        if self.height < 1:
            return "negative or zero height"
        if self.round < 0:
            return "negative round"
        if self.pol_round < -1 or self.pol_round >= self.round:
            return "pol_round must be -1 or in [0, round)"
        if not self.block_id.is_complete():
            return "blockID must be complete"
        if not self.signature:
            return "signature is missing"
        return None

    def verify(self, chain_id: str, pub_key) -> bool:
        return pub_key.verify_signature(self.sign_bytes(chain_id),
                                        self.signature)

    def copy(self) -> "Proposal":
        return replace(self)
