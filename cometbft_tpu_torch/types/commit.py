"""Commit and CommitSig (reference: ``types/block.go:607-1000``).

Counterpart of ``cometbft_tpu/types/commit.py`` for Ed25519 commits: one
CommitSig per validator (by validator-set index), flagged absent, commit
or nil.  The BLS aggregate lanes (flag 4) belong to a later slice of the
port; ``types/validation.py`` refuses a commit that carries them.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from . import canonical
from .block_id import BlockID
from .vote import PRECOMMIT_TYPE

__all__ = ["BLOCK_ID_FLAG_ABSENT", "BLOCK_ID_FLAG_COMMIT",
           "BLOCK_ID_FLAG_NIL", "BLOCK_ID_FLAG_AGGREGATE", "CommitSig",
           "Commit"]

BLOCK_ID_FLAG_ABSENT = 1
BLOCK_ID_FLAG_COMMIT = 2
BLOCK_ID_FLAG_NIL = 3
BLOCK_ID_FLAG_AGGREGATE = 4


@dataclass
class CommitSig:
    block_id_flag: int = BLOCK_ID_FLAG_ABSENT
    validator_address: bytes = b""
    timestamp_ns: int = 0
    signature: bytes = b""

    def is_absent(self) -> bool:
        return self.block_id_flag == BLOCK_ID_FLAG_ABSENT

    def is_commit(self) -> bool:
        return self.block_id_flag in (BLOCK_ID_FLAG_COMMIT,
                                      BLOCK_ID_FLAG_AGGREGATE)

    def is_aggregate(self) -> bool:
        return self.block_id_flag == BLOCK_ID_FLAG_AGGREGATE


@dataclass
class Commit:
    height: int
    round: int
    block_id: BlockID
    signatures: list[CommitSig] = field(default_factory=list)

    def size(self) -> int:
        return len(self.signatures)

    def has_aggregate(self) -> bool:
        return any(cs.is_aggregate() for cs in self.signatures)

    def vote_sign_bytes(self, chain_id: str, idx: int) -> bytes:
        """Canonical vote bytes for signature idx (types/block.go:902):
        the message the kernels verify for that lane."""
        cs = self.signatures[idx]
        return self._sb_encoder(chain_id, cs.is_commit()).sign_bytes(
            cs.timestamp_ns)

    def vote_sign_bytes_for(self, chain_id: str, idx: int,
                            key_type: str) -> bytes:
        """Sign bytes for lane idx given the signer's key type.  Ed25519
        signs the reference encoding; the BLS zero-timestamp domain comes
        with the BLS slice."""
        if key_type != "ed25519":
            raise ValueError(f"key type {key_type!r} is not ported yet")
        return self.vote_sign_bytes(chain_id, idx)

    def _sb_encoder(self, chain_id: str, is_commit: bool):
        cache = self.__dict__.setdefault("_sb_encoders", {})
        enc = cache.get((chain_id, is_commit))
        if enc is None:
            bid = self.block_id if is_commit else BlockID()
            enc = canonical.CanonicalVoteEncoder(
                chain_id, PRECOMMIT_TYPE, self.height, self.round, bid)
            cache[(chain_id, is_commit)] = enc
        return enc

    def dense_columns(self):
        """Columnar view for dense verification: ``(flags uint8 (N,),
        timestamps int64 (N,), sigs uint8 (N, 64), sig_ok bool (N,))``.
        ``sig_ok`` is False where a non-absent lane's signature is not
        64 bytes; such a lane verifies as invalid.  Returns None when a
        flag or timestamp does not fit its column; verification refuses
        such a commit as invalid."""
        sigs = self.signatures
        n = len(sigs)
        try:
            flags64 = np.fromiter((cs.block_id_flag for cs in sigs),
                                  np.int64, n)
            ts = np.fromiter((cs.timestamp_ns for cs in sigs), np.int64, n)
        except (OverflowError, ValueError, TypeError):
            return None
        if n and not ((flags64 >= 0) & (flags64 <= 0xFF)).all():
            return None
        buf = bytearray(n * 64)
        sig_ok = np.zeros((n,), bool)
        for i, cs in enumerate(sigs):
            if len(cs.signature) == 64:
                buf[i * 64:(i + 1) * 64] = cs.signature
                sig_ok[i] = True
        sigmat = np.frombuffer(bytes(buf), np.uint8).reshape(n, 64)
        return flags64.astype(np.uint8), ts, sigmat, sig_ok
