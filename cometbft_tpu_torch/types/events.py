"""Event kinds and attribute keys (reference: ``types/events.go:19-38,151``;
counterpart of ``cometbft_tpu/types/events.py``)."""

from __future__ import annotations

EVENT_NEW_BLOCK = "NewBlock"
EVENT_NEW_BLOCK_HEADER = "NewBlockHeader"
EVENT_NEW_BLOCK_EVENTS = "NewBlockEvents"
EVENT_NEW_ROUND = "NewRound"
EVENT_NEW_ROUND_STEP = "NewRoundStep"
EVENT_TX = "Tx"
EVENT_VALIDATOR_SET_UPDATES = "ValidatorSetUpdates"
EVENT_COMPLETE_PROPOSAL = "CompleteProposal"
EVENT_LOCK = "Lock"
EVENT_POLKA = "Polka"
EVENT_RELOCK = "Relock"
EVENT_TIMEOUT_PROPOSE = "TimeoutPropose"
EVENT_TIMEOUT_WAIT = "TimeoutWait"
EVENT_VOTE = "Vote"
EVENT_PROPOSAL_BLOCK_PART = "ProposalBlockPart"

EVENT_TYPE_KEY = "tm.event"
TX_HASH_KEY = "tx.hash"
TX_HEIGHT_KEY = "tx.height"
BLOCK_HEIGHT_KEY = "block.height"


def query_for_event(event_type: str) -> str:
    """Prebuilt subscription query string (types/events.go:151)."""
    return f"{EVENT_TYPE_KEY}='{event_type}'"
