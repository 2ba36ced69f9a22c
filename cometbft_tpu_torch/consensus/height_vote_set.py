"""HeightVoteSet: all prevote and precommit VoteSets of one height, keyed
by round (counterpart of ``cometbft_tpu/consensus/height_vote_set.py``;
reference: ``internal/consensus/types/height_vote_set.go:38-130``).

Rounds are created lazily; peer-contributed votes for future rounds are
capped by tracking the rounds each peer may catch up to (the reference's
peerCatchupRounds rule: at most 2 rounds a peer)."""

from __future__ import annotations

from ..types.validator_set import ValidatorSet
from ..types.vote import PRECOMMIT_TYPE, PREVOTE_TYPE, Vote
from ..types.vote_set import VoteSet


class HeightVoteSet:
    def __init__(self, chain_id: str, height: int, val_set: ValidatorSet,
                 extensions_enabled: bool = False):
        self.chain_id = chain_id
        self.height = height
        self.val_set = val_set
        self.extensions_enabled = extensions_enabled
        self.round = 0
        self._sets: dict[tuple[int, int], VoteSet] = {}
        self._peer_catchup: dict[str, list[int]] = {}
        self.set_round(0)

    def _make(self, round_: int) -> None:
        for typ in (PREVOTE_TYPE, PRECOMMIT_TYPE):
            if (round_, typ) not in self._sets:
                self._sets[(round_, typ)] = VoteSet(
                    self.chain_id, self.height, round_, typ, self.val_set,
                    extensions_enabled=(self.extensions_enabled
                                        and typ == PRECOMMIT_TYPE))

    def set_round(self, round_: int) -> None:
        """Ensure vote sets exist up to round_ + 1."""
        new_round = max(self.round, 0)
        for r in range(new_round, round_ + 2):
            self._make(r)
        self.round = round_

    def prevotes(self, round_: int) -> VoteSet | None:
        return self._sets.get((round_, PREVOTE_TYPE))

    def precommits(self, round_: int) -> VoteSet | None:
        return self._sets.get((round_, PRECOMMIT_TYPE))

    def add_vote(self, vote: Vote, peer_id: str = "") -> bool:
        """Raises like VoteSet.add_vote; lazily creates catchup rounds
        (bounded to 2 per peer)."""
        key = (vote.round, vote.type)
        if key not in self._sets:
            rounds = self._peer_catchup.setdefault(peer_id, [])
            if vote.round in rounds or len(rounds) < 2:
                if vote.round not in rounds:
                    rounds.append(vote.round)
                self._make(vote.round)
            else:
                raise ValueError("peer has sent too many catchup rounds")
        return self._sets[key].add_vote(vote)

    def pol_info(self) -> tuple[int, object]:
        """Latest round with a prevote +2/3 (proof-of-lock), or (-1, None)."""
        for r in range(self.round, -1, -1):
            vs = self.prevotes(r)
            if vs is not None and vs.has_two_thirds_majority():
                return r, vs.two_thirds_majority()[0]
        return -1, None

    def set_peer_maj23(self, round_: int, typ: int, peer_id: str,
                       block_id) -> None:
        self._make(round_)
        self._sets[(round_, typ)].set_peer_maj23(peer_id, block_id)
