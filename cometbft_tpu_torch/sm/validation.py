"""Block validation against the committed state (reference:
``state/validation.go``; counterpart of ``cometbft_tpu/sm/validation.py``).

The last-commit check at the end goes to ``types/validation.py``'s
``VerifyCommit`` (one dense device call), or, for blocksync, whose
window proved the commit already, to its basic checks alone.
"""

from __future__ import annotations

from ..storage.statestore import State
from ..types.commit import Commit
from ..types.header import BLOCK_PROTOCOL_VERSION, Block
from ..types.validation import VerifyCommit, _check_commit_basics

__all__ = ["BlockValidationError", "median_time", "validate_block"]


class BlockValidationError(Exception):
    pass


def median_time(commit: Commit, validators) -> int:
    """Voting-power-weighted median of the commit's timestamps, BFT time
    (types/block.go:949 MedianTime), over the Ed25519 lanes only: a BLS
    validator signs the zero-timestamp domain, so its lane's timestamp
    is not authenticated.  0 when no lane is (a BLS-only set); callers
    then take ``last_block_time_ns + 1``."""
    pairs = []
    total = 0
    for cs in commit.signatures:
        if cs.is_absent():
            continue
        _, val = validators.get_by_address(cs.validator_address)
        if val is None or val.pub_key.type() == "bls12_381":
            continue
        pairs.append((cs.timestamp_ns, val.voting_power))
        total += val.voting_power
    if not pairs:
        return 0
    pairs.sort()
    mid = total // 2
    acc = 0
    for ts, power in pairs:
        acc += power
        if acc >= mid:
            return ts
    return pairs[-1][0]


def validate_block(state: State, block: Block, device=None,
                   verify_last_commit_sigs: bool = True) -> None:
    """Raise BlockValidationError where the block does not follow
    ``state`` (state/validation.go).  ``verify_last_commit_sigs=False``
    keeps the last commit's structural checks and skips its signatures:
    blocksync proved them in a window's device call."""
    err = block.validate_basic(device)
    if err:
        raise BlockValidationError(f"invalid block: {err}")
    h = block.header

    if h.version_block != BLOCK_PROTOCOL_VERSION:
        raise BlockValidationError("wrong block protocol version")
    if h.chain_id != state.chain_id:
        raise BlockValidationError(
            f"wrong chain id {h.chain_id!r} != {state.chain_id!r}")
    want_height = state.last_block_height + 1 \
        if state.last_block_height else state.initial_height
    if h.height != want_height:
        raise BlockValidationError(
            f"wrong height {h.height}, expected {want_height}")
    if h.last_block_id != state.last_block_id:
        raise BlockValidationError("wrong last_block_id")
    if h.validators_hash != state.validators.hash(device):
        raise BlockValidationError("wrong validators_hash")
    if h.next_validators_hash != state.next_validators.hash(device):
        raise BlockValidationError("wrong next_validators_hash")
    if h.consensus_hash != state.consensus_params.hash():
        raise BlockValidationError("wrong consensus_hash")
    if h.app_hash != state.app_hash:
        raise BlockValidationError("wrong app_hash")
    if h.last_results_hash != state.last_results_hash:
        raise BlockValidationError("wrong last_results_hash")
    if not state.validators.has_address(h.proposer_address):
        raise BlockValidationError("proposer not in validator set")

    if h.height == state.initial_height:
        if block.last_commit is not None and block.last_commit.size() > 0:
            raise BlockValidationError(
                "initial block cannot have a last commit")
        return
    if block.last_commit is None:
        raise BlockValidationError("missing last commit")
    if state.last_validators is None:
        raise BlockValidationError("no last validators to verify commit")
    if verify_last_commit_sigs:
        VerifyCommit(state.chain_id, state.last_validators,
                     state.last_block_id, h.height - 1, block.last_commit,
                     device=device)
    else:
        _check_commit_basics(state.last_validators, block.last_commit,
                             h.height - 1, state.last_block_id)
    # BFT time: the block's time moves past the last block's
    if h.time_ns <= state.last_block_time_ns:
        raise BlockValidationError("block time not monotonic")
    if not state.consensus_params.feature.pbts_enabled(h.height):
        want = median_time(block.last_commit, state.last_validators) \
            or state.last_block_time_ns + 1
        if h.time_ns != want:
            raise BlockValidationError(
                f"block time {h.time_ns} != median time {want}")
