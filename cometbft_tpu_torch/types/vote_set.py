"""VoteSet: the 2/3-majority accumulator (counterpart of
``cometbft_tpu/types/vote_set.py``; reference: ``types/vote_set.go``).

One VoteSet per (height, round, type).  Tracks one canonical vote per
validator, per-block tallies, and promotes a BlockID to +2/3 majority.
Conflicting votes (same validator, different block) surface as
``ConflictingVoteError``, the raw material of DuplicateVoteEvidence, and
are also tracked when a peer has claimed (SetPeerMaj23) that the
conflicting block has a majority.

Signatures are checked through the verification scheduler
(``crypto/scheduler.py``): ``verify_cached`` (a cache hit, else one lane
on the scheduler's device) for a new vote, ``verify_uncached`` (a fresh
device lane) for a conflicting one.  With no scheduler registered both
raise ``RuntimeError``.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..libs.bits import BitArray
from .block_id import BlockID
from .commit import (BLOCK_ID_FLAG_ABSENT, BLOCK_ID_FLAG_COMMIT,
                     BLOCK_ID_FLAG_NIL, Commit, CommitSig, ExtendedCommit,
                     ExtendedCommitSig)
from .validator_set import ValidatorSet
from .vote import PRECOMMIT_TYPE, PREVOTE_TYPE, Vote


__all__ = ["VoteSetError", "ConflictingVoteError", "VoteSet"]


class VoteSetError(Exception):
    pass


@dataclass
class ConflictingVoteError(Exception):
    existing: Vote
    new: Vote

    def __str__(self):
        return (f"conflicting votes from validator "
                f"{self.new.validator_address.hex()}")


class _BlockVotes:
    __slots__ = ("peer_maj23", "bit_array", "votes", "sum")

    def __init__(self, peer_maj23: bool, n: int):
        self.peer_maj23 = peer_maj23
        self.bit_array = BitArray(n)
        self.votes: list[Vote | None] = [None] * n
        self.sum = 0

    def add_verified(self, idx: int, vote: Vote, power: int):
        if self.votes[idx] is None:
            self.bit_array.set_index(idx, True)
            self.votes[idx] = vote
            self.sum += power


class VoteSet:
    def __init__(self, chain_id: str, height: int, round_: int,
                 signed_msg_type: int, val_set: ValidatorSet,
                 extensions_enabled: bool = False):
        if signed_msg_type not in (PREVOTE_TYPE, PRECOMMIT_TYPE):
            raise VoteSetError("invalid vote type")
        if extensions_enabled and signed_msg_type != PRECOMMIT_TYPE:
            raise VoteSetError("extensions on non-precommit vote set")
        self.chain_id = chain_id
        self.height = height
        self.round = round_
        self.type = signed_msg_type
        self.val_set = val_set
        self.extensions_enabled = extensions_enabled
        n = val_set.size()
        self.votes_bit_array = BitArray(n)
        self.votes: list[Vote | None] = [None] * n
        self.sum = 0
        self.maj23: BlockID | None = None
        self.votes_by_block: dict[bytes, _BlockVotes] = {}
        self.peer_maj23s: dict[str, BlockID] = {}

    # ------------------------------------------------------------------ add

    def add_vote(self, vote: Vote) -> bool:
        """Returns True if the vote was added; raises on invalid/conflict
        (types/vote_set.go:158 AddVote)."""
        if vote is None:
            raise VoteSetError("nil vote")
        idx = vote.validator_index
        if (vote.height != self.height or vote.round != self.round
                or vote.type != self.type):
            raise VoteSetError(
                f"expected {self.height}/{self.round}/{self.type}, got "
                f"{vote.height}/{vote.round}/{vote.type}")
        val = self.val_set.get_by_index(idx)
        if val is None:
            raise VoteSetError(f"validator index {idx} out of range")
        if val.address != vote.validator_address:
            raise VoteSetError("validator address does not match index")

        existing = self.votes[idx]
        if existing is not None:
            if existing.block_id == vote.block_id:
                if existing.signature == vote.signature:
                    return False              # duplicate
                raise VoteSetError("same block, different signature")
            # conflicting vote: verify, maybe track, raise for evidence.
            # The verification bypasses the verified-signature cache: an
            # equivocation proof that slashes a validator must rest on a
            # fresh verification, never a cache entry.
            if not self._verify(vote, val, use_cache=False):
                raise VoteSetError("invalid signature on conflicting vote")
            self._maybe_track_conflict(vote, val)
            raise ConflictingVoteError(existing, vote)

        if not self._verify(vote, val):
            raise VoteSetError("invalid vote signature")

        self.votes[idx] = vote
        self.votes_bit_array.set_index(idx, True)
        self.sum += val.voting_power
        bv = self._get_or_make_block_votes(vote.block_id)
        bv.add_verified(idx, vote, val.voting_power)
        self._maybe_promote_maj23(vote.block_id, bv)
        return True

    def _verify(self, vote: Vote, val, *, use_cache: bool = True) -> bool:
        """Signature check for one gossiped vote — the steady-state hot
        path.  Routed through the verified-signature cache
        (``crypto/scheduler``): consensus pre-verifies peers' votes in
        coalesced micro-batches, so by the time the single-writer handler
        gets here the verdict is usually a cache hit; a miss is one lane
        on the scheduler's device.  ``use_cache=False`` verifies a fresh
        lane."""
        from ..crypto import scheduler as _vsched

        check = _vsched.verify_cached if use_cache \
            else _vsched.verify_uncached
        # sign bytes follow the signer's key type: BLS validators sign
        # the zero-timestamp aggregation domain (Vote.sign_bytes_for)
        sb = vote.sign_bytes_for(self.chain_id, val.pub_key.type())
        if self.extensions_enabled and vote.type == PRECOMMIT_TYPE:
            if vote.block_id.is_nil():
                # nil precommits carry no extension to require
                # (vote.go VerifyVoteAndExtension skips the check)
                return check(val.pub_key, sb, vote.signature)
            items = [(val.pub_key, sb, vote.signature),
                     (val.pub_key, vote.extension_sign_bytes(self.chain_id),
                      vote.extension_signature)]
            if use_cache:
                # the vote and its extension in one device call: on a
                # shared event loop each call holds every node
                return _vsched.verify_cached_all(items)
            return all(_vsched.verify_uncached(*it) for it in items)
        if vote.extension_signature and not self.extensions_enabled:
            return False
        return check(val.pub_key, sb, vote.signature)

    def _get_or_make_block_votes(self, block_id: BlockID) -> _BlockVotes:
        key = block_id.key()
        bv = self.votes_by_block.get(key)
        if bv is None:
            bv = _BlockVotes(False, self.val_set.size())
            self.votes_by_block[key] = bv
        return bv

    def _maybe_track_conflict(self, vote: Vote, val):
        bv = self.votes_by_block.get(vote.block_id.key())
        if bv is not None and bv.peer_maj23:
            bv.add_verified(vote.validator_index, vote, val.voting_power)
            # the tracked block can cross +2/3 through conflicting votes too
            # (vote_set.go addVerifiedVote promotes on this same path)
            self._maybe_promote_maj23(vote.block_id, bv)

    def _maybe_promote_maj23(self, block_id: BlockID, bv: _BlockVotes):
        quorum = self.val_set.total_voting_power() * 2 // 3 + 1
        if bv.sum >= quorum and self.maj23 is None:
            self.maj23 = block_id
            # copy block votes into canonical slots (conflict resolution)
            for i, v in enumerate(bv.votes):
                if v is not None:
                    self.votes[i] = v

    def set_peer_maj23(self, peer_id: str, block_id: BlockID) -> None:
        """A peer claims +2/3 for block_id (types/vote_set.go SetPeerMaj23)."""
        if peer_id in self.peer_maj23s:
            if self.peer_maj23s[peer_id] != block_id:
                raise VoteSetError("peer already sent a different maj23")
            return
        self.peer_maj23s[peer_id] = block_id
        bv = self.votes_by_block.get(block_id.key())
        if bv is not None:
            bv.peer_maj23 = True
        else:
            nv = _BlockVotes(True, self.val_set.size())
            self.votes_by_block[block_id.key()] = nv

    # -------------------------------------------------------------- queries

    def two_thirds_majority(self) -> tuple[BlockID | None, bool]:
        return self.maj23, self.maj23 is not None

    def has_two_thirds_majority(self) -> bool:
        return self.maj23 is not None

    def has_two_thirds_any(self) -> bool:
        return self.sum > self.val_set.total_voting_power() * 2 // 3

    def has_all(self) -> bool:
        return self.sum == self.val_set.total_voting_power()

    def bit_array(self) -> BitArray:
        return self.votes_bit_array.copy()

    def bit_array_by_block_id(self, block_id: BlockID) -> BitArray | None:
        bv = self.votes_by_block.get(block_id.key())
        return bv.bit_array.copy() if bv else None

    def get_by_index(self, idx: int) -> Vote | None:
        return self.votes[idx] if 0 <= idx < len(self.votes) else None

    def get_by_address(self, addr: bytes) -> Vote | None:
        idx, _ = self.val_set.get_by_address(addr)
        return self.get_by_index(idx) if idx >= 0 else None

    # --------------------------------------------------------------- commit

    def make_commit(self) -> Commit:
        """Commit from a +2/3 precommit set (types/vote_set.go
        MakeCommit), with the BLS for-block cohort folded into one
        aggregate signature + signer bitmap (``aggregate_commit`` — the
        fold is deterministic, so replays stay byte-identical)."""
        from .commit import aggregate_commit

        return aggregate_commit(self.make_extended_commit().to_commit(),
                                self.val_set)

    def make_extended_commit(self) -> ExtendedCommit:
        if self.type != PRECOMMIT_TYPE:
            raise VoteSetError("cannot make commit from prevote set")
        if self.maj23 is None:
            raise VoteSetError("no +2/3 majority")
        sigs = []
        for i, v in enumerate(self.votes):
            if v is None:
                sigs.append(ExtendedCommitSig())
                continue
            flag = (BLOCK_ID_FLAG_COMMIT if v.block_id == self.maj23
                    else BLOCK_ID_FLAG_NIL if v.block_id.is_nil()
                    else BLOCK_ID_FLAG_ABSENT)
            if flag == BLOCK_ID_FLAG_ABSENT:
                # vote for a different block: treated as absent in the commit
                sigs.append(ExtendedCommitSig())
                continue
            cs = CommitSig(flag, v.validator_address, v.timestamp_ns,
                           v.signature)
            sigs.append(ExtendedCommitSig(cs, v.extension,
                                          v.extension_signature))
        return ExtendedCommit(self.height, self.round, self.maj23, sigs)

    def __str__(self):
        return (f"VoteSet{{h={self.height} r={self.round} t={self.type} "
                f"sum={self.sum} maj23={self.maj23}}}")
