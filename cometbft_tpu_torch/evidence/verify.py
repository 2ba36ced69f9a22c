"""Evidence verification (counterpart of ``cometbft_tpu/evidence/verify.py``;
reference: ``internal/evidence/verify.go:19,110,164``).

DuplicateVoteEvidence: both votes must be validly signed by the same
validator, who must have been in the validator set at the evidence
height; the recorded powers must match that historical set.  Each vote's
signature is a fresh device lane through the verification scheduler
(``crypto/scheduler.py:verify_uncached``, which raises with no scheduler
registered): evidence never rests on the cache or on a host check.  Age
is checked against the consensus evidence params.

LightClientAttackEvidence: the conflicting block's commit is checked
against the common-height validator set with trusting semantics
(``VerifyCommitLightTrustingAllSignatures``, on ``device``)."""

from __future__ import annotations

from fractions import Fraction

from ..crypto import scheduler as _vsched
from ..types.evidence import (DuplicateVoteEvidence, Evidence, EvidenceError,
                              EvidenceNotApplicableError,
                              LightClientAttackEvidence)
from ..types.validation import VerifyCommitLightTrustingAllSignatures

__all__ = ["verify_evidence"]


def verify_evidence(ev: Evidence, state, state_store, device=None,
                    block_store=None) -> None:
    """internal/evidence/verify.go:19 — dispatch + age check.
    Raises EvidenceError on any failure.

    When ``block_store`` is given, the evidence's claimed timestamp is
    pinned to the committed block time at its height (verify.go:36-44) —
    otherwise an attacker could stamp ancient evidence with a fresh time
    and slide it past the duration half of the expiry check."""
    err = ev.validate_basic()
    if err:
        raise EvidenceError(f"invalid evidence: {err}")

    ev_time = ev.time_ns()
    if block_store is not None:
        blk = block_store.load_block(ev.height())
        if blk is None:
            # not necessarily malicious: a statesync'd node has no
            # blocks below its snapshot base
            raise EvidenceNotApplicableError(
                f"no committed block at evidence height {ev.height()}")
        if ev_time != blk.header.time_ns:
            raise EvidenceError(
                f"evidence time {ev_time} != block time "
                f"{blk.header.time_ns} at height {ev.height()}")

    height = state.last_block_height
    ev_params = state.consensus_params.evidence
    age_blocks = height - ev.height()
    age_ns = state.last_block_time_ns - ev_time
    if age_blocks > ev_params.max_age_num_blocks and \
            age_ns > ev_params.max_age_duration_ns:
        # expiry race with the sender's pruning, not malice
        raise EvidenceNotApplicableError(
            f"evidence from height {ev.height()} is too old "
            f"({age_blocks} blocks, {age_ns} ns)")

    if isinstance(ev, DuplicateVoteEvidence):
        _verify_duplicate_vote(ev, state.chain_id, state_store)
    elif isinstance(ev, LightClientAttackEvidence):
        _verify_light_client_attack(ev, state.chain_id, state_store, device)
    else:
        raise EvidenceError(f"unknown evidence type {type(ev).__name__}")


def _verify_duplicate_vote(ev: DuplicateVoteEvidence, chain_id: str,
                           state_store) -> None:
    """verify.go:164 VerifyDuplicateVote."""
    vals = state_store.load_validators(ev.height())
    if vals is None:
        # pruned / statesync'd history: we cannot judge, so don't blame
        raise EvidenceNotApplicableError(
            f"no validator set at height {ev.height()}")
    idx, val = vals.get_by_address(ev.vote_a.validator_address)
    if idx < 0:
        raise EvidenceError("validator not in set at evidence height")
    if ev.validator_power != val.voting_power:
        raise EvidenceError(
            f"validator power mismatch {ev.validator_power} != "
            f"{val.voting_power}")
    if ev.total_voting_power != vals.total_voting_power():
        raise EvidenceError(
            f"total power mismatch {ev.total_voting_power} != "
            f"{vals.total_voting_power()}")
    for v in (ev.vote_a, ev.vote_b):
        # BLS validators sign the zero-timestamp aggregation domain
        # (types/vote.py sign_bytes_for); Ed25519 the reference encoding
        if not _vsched.verify_uncached(
                val.pub_key, v.sign_bytes_for(chain_id, val.pub_key.type()),
                v.signature):
            raise EvidenceError("invalid vote signature in evidence")


def _verify_light_client_attack(ev: LightClientAttackEvidence,
                                chain_id: str, state_store, device) -> None:
    """verify.go:110 VerifyLightClientAttack (conflicting-block commit
    check against the common-height set with 1/3 trust)."""
    common_vals = state_store.load_validators(ev.common_height)
    if common_vals is None:
        raise EvidenceNotApplicableError(
            f"no validator set at common height {ev.common_height}")
    blk = ev.conflicting_block
    if blk is None:
        raise EvidenceError("missing conflicting block payload")
    commit = getattr(blk, "commit", None)
    if commit is None:
        raise EvidenceError("conflicting block has no commit")
    VerifyCommitLightTrustingAllSignatures(
        chain_id, common_vals, commit, trust_level=Fraction(1, 3),
        device=device)
