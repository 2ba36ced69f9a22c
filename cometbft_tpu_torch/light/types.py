"""Light-client types (reference: ``types/light.go`` LightBlock /
SignedHeader).

Counterpart of ``cometbft_tpu/light/types.py``.  ``validate_basic``
hashes the validator set, which at ``merkle.MERKLE_KERNEL_MIN_LEAVES``
validators or more runs the merkle kernels on ``device`` (None: CUDA).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..types.commit import Commit
from ..types.header import Header
from ..types.validator_set import ValidatorSet

__all__ = ["LightClientError", "ErrNewValSetCantBeTrusted",
           "ErrInvalidHeader", "LightBlock"]


class LightClientError(Exception):
    pass


class ErrNewValSetCantBeTrusted(LightClientError):
    """Less than the trust level of the trusted set signed the new header:
    bisect (light/verifier.go ErrNewValSetCantBeTrusted)."""


class ErrInvalidHeader(LightClientError):
    pass


@dataclass
class LightBlock:
    """SignedHeader (header + commit) and the validator set that signed it
    (types/light.go:12)."""

    header: Header
    commit: Commit
    validators: ValidatorSet

    @property
    def height(self) -> int:
        return self.header.height

    def validate_basic(self, chain_id: str, device=None) -> str | None:
        if self.header is None or self.commit is None:
            return "missing header or commit"
        if self.validators is None:
            return "missing validator set"
        if self.header.chain_id != chain_id:
            return f"header from another chain {self.header.chain_id!r}"
        err = self.commit.validate_basic()
        if err:
            return err
        if self.header.validators_hash != self.validators.hash(device):
            return "validators don't match header validators_hash"
        if self.commit.height != self.header.height:
            return "commit height != header height"
        if self.commit.block_id.hash != self.header.hash():
            return "commit signs a different header"
        return None
