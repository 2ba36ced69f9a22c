"""The Tendermint consensus state machine (counterpart of
``cometbft_tpu/consensus``; reference: ``internal/consensus/``): round
state, height vote sets, the timeout ticker, the WAL and the
single-writer receive loop with WAL catch-up replay.  The reactor's
gossip and the app handshake at node start come with the networked
node."""

from .height_vote_set import HeightVoteSet
from .round_state import (STEP_COMMIT, STEP_NEW_HEIGHT, STEP_NEW_ROUND,
                          STEP_PRECOMMIT, STEP_PRECOMMIT_WAIT, STEP_PREVOTE,
                          STEP_PREVOTE_WAIT, STEP_PROPOSE, RoundState)
from .state import ConsensusState
from .ticker import TimeoutInfo, TimeoutTicker
from .wal import WAL, WALError

__all__ = ["ConsensusState", "RoundState", "HeightVoteSet", "TimeoutTicker",
           "TimeoutInfo", "WAL", "WALError", "STEP_NEW_HEIGHT",
           "STEP_NEW_ROUND", "STEP_PROPOSE", "STEP_PREVOTE",
           "STEP_PREVOTE_WAIT", "STEP_PRECOMMIT", "STEP_PRECOMMIT_WAIT",
           "STEP_COMMIT"]
