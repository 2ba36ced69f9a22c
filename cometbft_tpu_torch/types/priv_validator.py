"""PrivValidator interface and the in-memory MockPV (counterpart of
``cometbft_tpu/types/priv_validator.py``; reference:
``types/priv_validator.go``).

The interface is async: a remote signer does socket round trips, and the
consensus state machine awaits signing on its single-writer task.  Ed25519
keys sign through the port's native signer (``crypto/keys.py``); the file
signer with double-sign protection comes with the networked node."""

from __future__ import annotations

from abc import ABC, abstractmethod

from ..crypto.keys import Ed25519PrivKey
from .vote import Proposal, Vote

__all__ = ["PrivValidator", "MockPV"]


class PrivValidator(ABC):
    @abstractmethod
    def get_pub_key(self): ...

    @abstractmethod
    async def sign_vote(self, chain_id: str, vote: Vote,
                        sign_extension: bool) -> None:
        """Fills vote.signature (and extension_signature if requested)."""

    @abstractmethod
    async def sign_proposal(self, chain_id: str,
                            proposal: Proposal) -> None: ...


class MockPV(PrivValidator):
    """Unprotected signer for tests (types/priv_validator.go MockPV).
    Key-type aware: a bls12_381 key signs votes over the zero-timestamp
    aggregation domain (``Vote.sign_bytes_for``), so sim networks can
    mix BLS and Ed25519 validators in one genesis."""

    def __init__(self, priv_key=None):
        self.priv_key = priv_key or Ed25519PrivKey.generate()

    @classmethod
    def from_secret(cls, secret: bytes,
                    key_type: str = "ed25519") -> "MockPV":
        if key_type == "bls12_381":
            from ..crypto import bls12381 as _bls

            return cls(_bls.Bls12381PrivKey.from_secret(secret))
        return cls(Ed25519PrivKey.from_secret(secret))

    def get_pub_key(self):
        return self.priv_key.pub_key()

    def pop(self) -> bytes:
        """Proof of possession (BLS keys only; b"" otherwise) — what a
        genesis doc or validator update publishes beside the pubkey so
        admission can run the rogue-key gate)."""
        if self.priv_key.type() != "bls12_381":
            return b""
        from ..crypto import bls12381 as _bls

        return _bls.pop_prove(self.priv_key.bytes())

    async def sign_vote(self, chain_id: str, vote: Vote,
                        sign_extension: bool) -> None:
        vote.signature = self.priv_key.sign(
            vote.sign_bytes_for(chain_id, self.priv_key.type()))
        if sign_extension:
            vote.extension_signature = self.priv_key.sign(
                vote.extension_sign_bytes(chain_id))

    async def sign_proposal(self, chain_id: str, proposal: Proposal) -> None:
        proposal.signature = self.priv_key.sign(
            proposal.sign_bytes(chain_id))
