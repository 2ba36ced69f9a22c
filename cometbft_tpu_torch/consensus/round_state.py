"""RoundState (counterpart of ``cometbft_tpu/consensus/round_state.py``;
reference: ``internal/consensus/types/round_state.go``)."""

from __future__ import annotations

from dataclasses import dataclass, field

from ..types.block_id import BlockID
from ..types.header import Block
from ..types.part_set import PartSet
from ..types.validator_set import ValidatorSet
from ..types.vote import Proposal

STEP_NEW_HEIGHT = 1
STEP_NEW_ROUND = 2
STEP_PROPOSE = 3
STEP_PREVOTE = 4
STEP_PREVOTE_WAIT = 5
STEP_PRECOMMIT = 6
STEP_PRECOMMIT_WAIT = 7
STEP_COMMIT = 8

STEP_NAMES = {
    STEP_NEW_HEIGHT: "NewHeight", STEP_NEW_ROUND: "NewRound",
    STEP_PROPOSE: "Propose", STEP_PREVOTE: "Prevote",
    STEP_PREVOTE_WAIT: "PrevoteWait", STEP_PRECOMMIT: "Precommit",
    STEP_PRECOMMIT_WAIT: "PrecommitWait", STEP_COMMIT: "Commit",
}


@dataclass
class RoundState:
    height: int = 0
    round: int = 0
    step: int = STEP_NEW_HEIGHT
    start_time_ns: int = 0
    commit_time_ns: int = 0
    validators: ValidatorSet | None = None
    proposal: Proposal | None = None
    proposal_receive_time_ns: int = 0     # PBTS timeliness input
    proposal_block: Block | None = None
    proposal_block_parts: PartSet | None = None
    locked_round: int = -1
    locked_block: Block | None = None
    locked_block_parts: PartSet | None = None
    valid_round: int = -1
    valid_block: Block | None = None
    valid_block_parts: PartSet | None = None
    votes: object = None                  # HeightVoteSet
    commit_round: int = -1
    last_commit: object = None            # prev height precommits (VoteSet)
    # whole commit received via aggregate catch-up (Commit): the folded
    # BLS lanes carry no individual signatures, so a lagging node gets
    # the verified commit as one unit instead of vote-by-vote
    decided_commit: object = None
    last_validators: ValidatorSet | None = None
    triggered_timeout_precommit: bool = False

    def step_name(self) -> str:
        return STEP_NAMES.get(self.step, "?")

    def proposal_complete(self) -> bool:
        return (self.proposal is not None
                and self.proposal_block is not None)

    def locked_block_id(self) -> BlockID | None:
        if self.locked_block is None:
            return None
        return BlockID(self.locked_block.hash(),
                       self.locked_block_parts.header())
