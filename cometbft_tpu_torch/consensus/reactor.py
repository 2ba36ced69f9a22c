"""The consensus reactor's catch-up helper (counterpart of
``cometbft_tpu/consensus/reactor.py:103 votes_from_commit``).  The
reactor itself, with its gossip routines and peer state, comes with the
networked node; the in-process harness (``testing.py``) catches lagging
nodes up with this helper alone."""

from __future__ import annotations

from ..types.block_id import BlockID
from ..types.commit import Commit
from ..types.vote import PRECOMMIT_TYPE, Vote

__all__ = ["votes_from_commit"]


def votes_from_commit(commit: Commit) -> list[Vote]:
    """Precommit Votes rebuilt from a stored commit so lagging peers can
    be caught up vote by vote (reactor.go:646; Commit.ToVoteSet
    types/block.go:1134).  Aggregate lanes are skipped: their signatures
    were folded into ``commit.agg_signature`` and no longer exist."""
    out = []
    for i, cs in enumerate(commit.signatures):
        if cs.is_absent() or cs.is_aggregate():
            continue
        out.append(Vote(
            type=PRECOMMIT_TYPE, height=commit.height, round=commit.round,
            block_id=commit.block_id if cs.is_commit() else BlockID(),
            timestamp_ns=cs.timestamp_ns,
            validator_address=cs.validator_address,
            validator_index=i, signature=cs.signature))
    return out
