"""Commit and CommitSig (reference: ``types/block.go:607-1000``).

Counterpart of ``cometbft_tpu/types/commit.py`` for Ed25519 commits: one
CommitSig per validator (by validator-set index), flagged absent, commit
or nil, with the commit's wire encoding, merkle hash and basic checks.
The BLS aggregate lanes (flag 4) belong to a later slice of the port:
``types/validation.py`` refuses a commit that carries them, and so do
``Commit.hash`` and ``Commit.validate_basic``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..crypto import merkle
from . import canonical, wire
from .block_id import BlockID
from .vote import PRECOMMIT_TYPE

__all__ = ["BLOCK_ID_FLAG_ABSENT", "BLOCK_ID_FLAG_COMMIT",
           "BLOCK_ID_FLAG_NIL", "BLOCK_ID_FLAG_AGGREGATE",
           "MAX_SIGNATURE_SIZE", "CommitSig", "Commit"]

BLOCK_ID_FLAG_ABSENT = 1
BLOCK_ID_FLAG_COMMIT = 2
BLOCK_ID_FLAG_NIL = 3
BLOCK_ID_FLAG_AGGREGATE = 4
MAX_SIGNATURE_SIZE = 96


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

    def validate_basic(self) -> str | None:
        if self.block_id_flag not in (BLOCK_ID_FLAG_ABSENT,
                                      BLOCK_ID_FLAG_COMMIT,
                                      BLOCK_ID_FLAG_NIL,
                                      BLOCK_ID_FLAG_AGGREGATE):
            return "unknown block ID flag"
        if self.is_absent():
            if self.validator_address or self.signature:
                return "absent sig with address/signature"
        elif self.is_aggregate():
            if len(self.validator_address) != 20:
                return "invalid validator address size"
            if self.signature:
                return "aggregate lane carries an individual signature"
        else:
            if len(self.validator_address) != 20:
                return "invalid validator address size"
            if not self.signature or len(self.signature) > MAX_SIGNATURE_SIZE:
                return "signature absent or too big"
        return None

    def encode(self) -> bytes:
        return (wire.field_varint(1, self.block_id_flag)
                + wire.field_bytes(2, self.validator_address)
                + wire.field_message(3, canonical.encode_timestamp(
                    self.timestamp_ns), force=True)
                + wire.field_bytes(4, self.signature))


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

    def hash(self, device=None) -> bytes:
        """Merkle root of the encoded CommitSigs (types/block.go); at
        ``merkle.MERKLE_KERNEL_MIN_LEAVES`` signatures or more it is hashed
        by the kernels on ``device`` (None: CUDA).  The aggregate leaf
        comes with the BLS slice: a commit with aggregate lanes raises
        ``ValueError``."""
        if self.has_aggregate():
            raise ValueError("BLS aggregate lanes are not supported")
        return merkle.hash_from_byte_slices_fast(
            [cs.encode() for cs in self.signatures], device=device)

    def validate_basic(self) -> str | None:
        if self.height < 0:
            return "negative height"
        if self.round < 0:
            return "negative round"
        if self.height >= 1:
            if self.block_id.is_nil():
                return "commit cannot be for nil block"
            if not self.signatures:
                return "no signatures in commit"
            for i, cs in enumerate(self.signatures):
                err = cs.validate_basic()
                if err:
                    return f"invalid signature {i}: {err}"
            if self.has_aggregate():
                return "BLS aggregate lanes are not supported"
        return None

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
