"""Commit and CommitSig (reference: ``types/block.go:607-1000``).

Counterpart of ``cometbft_tpu/types/commit.py``: one CommitSig per
validator (by validator-set index), flagged absent, commit, nil or
aggregate, with the commit's wire encoding, merkle hash and basic
checks.  A BLS aggregate commit folds its BLS for-block lanes into one
96-byte G2 signature (``agg_signature``) over the zero-timestamp sign
bytes plus a signer bitmap (``agg_signers``); those lanes keep address
and timestamp and carry no signature of their own
(:func:`aggregate_commit`, verified in ``types/validation.py``).
``ExtendedCommit`` carries each lane's vote extension and its signature
(types/block.go:1086) for the heights where vote extensions are on.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..crypto import merkle
from . import canonical, wire
from .block_id import BlockID
from .vote import PRECOMMIT_TYPE, Vote

__all__ = ["BLOCK_ID_FLAG_ABSENT", "BLOCK_ID_FLAG_COMMIT",
           "BLOCK_ID_FLAG_NIL", "BLOCK_ID_FLAG_AGGREGATE",
           "MAX_SIGNATURE_SIZE", "signer_bitmap", "bitmap_indices",
           "CommitSig", "Commit", "aggregate_commit", "ExtendedCommitSig",
           "ExtendedCommit"]

BLOCK_ID_FLAG_ABSENT = 1
BLOCK_ID_FLAG_COMMIT = 2
BLOCK_ID_FLAG_NIL = 3
BLOCK_ID_FLAG_AGGREGATE = 4
MAX_SIGNATURE_SIZE = 96


def signer_bitmap(indices, n: int) -> bytes:
    """Aggregate-signer bitmap: bit i (byte i // 8, bit i % 8, LSB first)
    set when validator-set index i signed into the aggregate."""
    buf = bytearray((n + 7) // 8)
    for i in indices:
        if not 0 <= i < n:
            raise ValueError(f"signer index {i} out of range for {n}")
        buf[i // 8] |= 1 << (i % 8)
    return bytes(buf)


def bitmap_indices(bitmap: bytes, n: int) -> list[int] | None:
    """Decode a signer bitmap; None when its length is wrong or a bit at
    or beyond n is set."""
    if len(bitmap) != (n + 7) // 8:
        return None
    out = []
    for i, byte in enumerate(bitmap):
        base = i * 8
        while byte:
            low = byte & -byte
            idx = base + low.bit_length() - 1
            if idx >= n:
                return None
            out.append(idx)
            byte ^= low
    return out


@dataclass
class CommitSig:
    block_id_flag: int = BLOCK_ID_FLAG_ABSENT
    validator_address: bytes = b""
    timestamp_ns: int = 0
    signature: bytes = b""

    @classmethod
    def absent(cls) -> "CommitSig":
        return cls()

    def is_absent(self) -> bool:
        return self.block_id_flag == BLOCK_ID_FLAG_ABSENT

    def is_commit(self) -> bool:
        return self.block_id_flag in (BLOCK_ID_FLAG_COMMIT,
                                      BLOCK_ID_FLAG_AGGREGATE)

    def is_aggregate(self) -> bool:
        return self.block_id_flag == BLOCK_ID_FLAG_AGGREGATE

    def for_block(self) -> bool:
        return self.is_commit()

    def block_id(self, commit_block_id: BlockID) -> BlockID:
        """The BlockID this lane signed: the commit's for a commit or
        aggregate lane, nil otherwise (types/block.go CommitSig.BlockID)."""
        if self.is_commit():
            return commit_block_id
        return BlockID()

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
    # one compressed G2 signature over the zero-timestamp precommit,
    # covering exactly the BLOCK_ID_FLAG_AGGREGATE lanes, and their bitmap
    # (signer_bitmap); empty on commits without an aggregate
    agg_signature: bytes = b""
    agg_signers: bytes = b""

    def size(self) -> int:
        return len(self.signatures)

    def __deepcopy__(self, memo):
        # derived caches (sign-bytes encoders, aggregate lanes and bitmap)
        # stay behind: a copy's lanes are routinely edited
        import copy as _copy

        return Commit(self.height, self.round,
                      _copy.deepcopy(self.block_id, memo),
                      _copy.deepcopy(self.signatures, memo),
                      self.agg_signature, self.agg_signers)

    def has_aggregate(self) -> bool:
        """True when the commit carries an aggregate signature, a signer
        bitmap or any AGGREGATE-flag lane (cached, as the lanes)."""
        h = self.__dict__.get("_has_agg")
        if h is None:
            h = bool(self.agg_signature) or bool(self.agg_signers) or any(
                cs.block_id_flag == BLOCK_ID_FLAG_AGGREGATE
                for cs in self.signatures)
            self.__dict__["_has_agg"] = h
        return h

    def aggregate_lanes(self) -> list[int]:
        """Indices of the AGGREGATE-flag lanes, in index order (cached)."""
        lanes = self.__dict__.get("_agg_lanes")
        if lanes is None:
            lanes = [i for i, cs in enumerate(self.signatures)
                     if cs.block_id_flag == BLOCK_ID_FLAG_AGGREGATE]
            self.__dict__["_agg_lanes"] = lanes
        return lanes

    def hash(self, device=None) -> bytes:
        """Merkle root of the encoded CommitSigs (types/block.go), plus one
        leaf binding the aggregate signature and bitmap when the commit
        carries them; at ``merkle.MERKLE_KERNEL_MIN_LEAVES`` leaves or more
        it is hashed by the kernels on ``device`` (None: CUDA)."""
        leaves = [cs.encode() for cs in self.signatures]
        if self.agg_signature or self.agg_signers:
            leaves.append(wire.field_bytes(1, self.agg_signature)
                          + wire.field_bytes(2, self.agg_signers))
        return merkle.hash_from_byte_slices_fast(leaves, device=device)

    def encode(self) -> bytes:
        body = (wire.field_varint(1, self.height)
                + wire.field_varint(2, self.round)
                + wire.field_message(3, self.block_id.encode(), force=True))
        for cs in self.signatures:
            body += wire.field_message(4, cs.encode(), force=True)
        return (body + wire.field_bytes(5, self.agg_signature)
                + wire.field_bytes(6, self.agg_signers))

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
            return self._validate_aggregate()
        return None

    def _validate_aggregate(self) -> str | None:
        """Shape of the aggregate: the bitmap names exactly the
        AGGREGATE-flag lanes, and signature and bitmap come together.  The
        signature itself is checked in ``types/validation.py``."""
        lanes = self.aggregate_lanes()
        if not self.agg_signature and not self.agg_signers and not lanes:
            return None
        if len(self.agg_signature) != 96:
            return "aggregate signature must be 96 bytes"
        if not lanes:
            return "aggregate signature without aggregate lanes"
        if len(self.agg_signers) != (len(self.signatures) + 7) // 8:
            return "malformed aggregate signer bitmap"
        # the lanes' own bitmap, cached as the lanes are: one bytes
        # compare per call instead of a loop over every lane
        expect = self.__dict__.get("_agg_bitmap")
        if expect is None:
            expect = signer_bitmap(lanes, len(self.signatures))
            self.__dict__["_agg_bitmap"] = expect
        if self.agg_signers != expect:
            return "aggregate signer bitmap does not match aggregate lanes"
        return None

    def vote_sign_bytes(self, chain_id: str, idx: int) -> bytes:
        """Canonical vote bytes for signature idx (types/block.go:902):
        the message the kernels verify for that lane."""
        cs = self.signatures[idx]
        return self._sb_encoder(chain_id, cs.is_commit()).sign_bytes(
            cs.timestamp_ns)

    def vote_sign_bytes_for(self, chain_id: str, idx: int,
                            key_type: str) -> bytes:
        """Sign bytes for lane idx given the signer's key type: BLS
        validators sign the zero-timestamp aggregation domain, Ed25519
        ones the reference encoding."""
        cs = self.signatures[idx]
        return self._sb_encoder(chain_id, cs.is_commit()).sign_bytes(
            0 if key_type == "bls12_381" else cs.timestamp_ns)

    def aggregate_sign_bytes(self, chain_id: str) -> bytes:
        """The message under the aggregate signature: the canonical
        precommit for the commit's BlockID with the timestamp zero."""
        return self._sb_encoder(chain_id, True).sign_bytes(0)

    def sign_bytes_templates(self, chain_id: str):
        """``(pre_commit, pre_nil, post)``: the sign bytes' body without
        its timestamp field, before it in the commit and the nil variant
        and after it, for the native encoder
        (``native.build_vote_sign_bytes``)."""
        enc_c = self._sb_encoder(chain_id, True)
        enc_n = self._sb_encoder(chain_id, False)
        return enc_c._prefix, enc_n._prefix, enc_c._suffix

    def _sb_encoder(self, chain_id: str, is_commit: bool):
        cache = self.__dict__.setdefault("_sb_encoders", {})
        enc = cache.get((chain_id, is_commit))
        if enc is None:
            bid = self.block_id if is_commit else BlockID()
            enc = canonical.CanonicalVoteEncoder(
                chain_id, PRECOMMIT_TYPE, self.height, self.round, bid)
            cache[(chain_id, is_commit)] = enc
        return enc

    def to_vote(self, idx: int) -> Vote:
        cs = self.signatures[idx]
        return Vote(type=PRECOMMIT_TYPE, height=self.height, round=self.round,
                    block_id=cs.block_id(self.block_id),
                    timestamp_ns=cs.timestamp_ns,
                    validator_address=cs.validator_address,
                    validator_index=idx, signature=cs.signature)

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


def aggregate_commit(commit: Commit, val_set) -> Commit:
    """Fold the BLS for-block lanes of a fresh commit into one aggregate
    signature and signer bitmap (``cometbft_tpu/types/commit.py:
    aggregate_commit``).  Lanes fold in index order; cohorts smaller than
    2 stay individual, NIL votes always do (they sign another message),
    and Ed25519 lanes are untouched.  A commit that already carries an
    aggregate comes back as it is."""
    if commit.has_aggregate() or not val_set.has_bls():
        return commit
    cohort, sigs = [], []
    for i, cs in enumerate(commit.signatures):
        if cs.block_id_flag != BLOCK_ID_FLAG_COMMIT:
            continue
        val = val_set.get_by_index(i)
        if val is None or val.pub_key.type() != "bls12_381":
            continue
        cohort.append(i)
        sigs.append(cs.signature)
    if len(cohort) < 2:
        return commit
    from ..crypto import bls12381 as _bls

    # check=False: each input passed its own verification on the way in
    agg = _bls.aggregate_signatures(sigs, check=False)
    new_sigs = list(commit.signatures)
    for i in cohort:
        cs = commit.signatures[i]
        new_sigs[i] = CommitSig(BLOCK_ID_FLAG_AGGREGATE, cs.validator_address,
                                cs.timestamp_ns, b"")
    return Commit(commit.height, commit.round, commit.block_id, new_sigs,
                  agg, signer_bitmap(cohort, len(new_sigs)))


@dataclass
class ExtendedCommitSig:
    commit_sig: CommitSig = field(default_factory=CommitSig)
    extension: bytes = b""
    extension_signature: bytes = b""

    def validate_basic(self) -> str | None:
        err = self.commit_sig.validate_basic()
        if err:
            return err
        if self.commit_sig.is_commit():
            if len(self.extension_signature) > MAX_SIGNATURE_SIZE:
                return "extension signature too big"
        elif self.extension or self.extension_signature:
            return "extension on non-commit vote"
        return None

    def ensure_extension(self, ext_enabled: bool) -> bool:
        """types/block.go EnsureExtensions, for one lane."""
        if not ext_enabled:
            return not self.extension and not self.extension_signature
        if self.commit_sig.is_commit():
            return len(self.extension_signature) > 0
        return True


@dataclass
class ExtendedCommit:
    """A commit with its lanes' vote extensions (types/block.go:1086).
    An aggregate carried over from an aggregated commit stays with it:
    its folded lanes have no signatures of their own."""

    height: int
    round: int
    block_id: BlockID
    extended_signatures: list[ExtendedCommitSig] = field(default_factory=list)
    agg_signature: bytes = b""
    agg_signers: bytes = b""

    def size(self) -> int:
        return len(self.extended_signatures)

    def to_commit(self) -> Commit:
        """The commit without its extensions (types/block.go:1165)."""
        return Commit(height=self.height, round=self.round,
                      block_id=self.block_id,
                      signatures=[e.commit_sig
                                  for e in self.extended_signatures],
                      agg_signature=self.agg_signature,
                      agg_signers=self.agg_signers)

    def ensure_extensions(self, ext_enabled: bool) -> bool:
        """types/block.go:1154 EnsureExtensions."""
        return all(e.ensure_extension(ext_enabled)
                   for e in self.extended_signatures)

    def to_extended_vote(self, idx: int) -> Vote:
        e = self.extended_signatures[idx]
        v = Commit(self.height, self.round, self.block_id,
                   [x.commit_sig for x in self.extended_signatures]
                   ).to_vote(idx)
        v.extension = e.extension
        v.extension_signature = e.extension_signature
        return v
