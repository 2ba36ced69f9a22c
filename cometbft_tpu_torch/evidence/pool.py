"""Evidence pool: collect, verify, persist and serve evidence of
Byzantine behaviour until it is committed in a block (counterpart of
``cometbft_tpu/evidence/pool.py``; reference:
``internal/evidence/pool.go:24,190,248``).

Consensus reports conflicting votes as raw vote pairs
(``report_conflicting_votes``); they become ``DuplicateVoteEvidence``
stamped with the committed block's time and validator set on the next
``update``, since evidence needs the block time, which is not known when
the conflict surfaces.  Verification runs on ``device``
(``evidence/verify.py``)."""

from __future__ import annotations

from typing import Callable

from ..abci.types import Misbehavior
from ..storage.db import KVStore, MemDB
from ..types import codec
from ..types.evidence import (DuplicateVoteEvidence, Evidence, EvidenceError,
                              EvidenceNotApplicableError,
                              LightClientAttackEvidence)
from ..types.vote import Vote
from .verify import verify_evidence

__all__ = ["EvidencePool"]

K_PENDING = b"evp/"
K_COMMITTED = b"evc/"


def _key(prefix: bytes, ev: Evidence) -> bytes:
    return prefix + ev.height().to_bytes(8, "big") + ev.hash()


class EvidencePool:
    def __init__(self, db: KVStore | None = None, state_store=None,
                 block_store=None, device=None):
        self.db = db or MemDB()
        self.state_store = state_store
        self.block_store = block_store
        self.device = device
        self.state = None                   # latest sm.State, set by update
        self._conflicting_votes: list[tuple[Vote, Vote]] = []
        self.on_evidence_added: Callable[[Evidence], None] = lambda ev: None

    # ------------------------------------------------------------ ingest

    def report_conflicting_votes(self, vote_a: Vote, vote_b: Vote) -> None:
        """pool.go ReportConflictingVotes — buffered until the next block
        commit supplies time + validator set."""
        self._conflicting_votes.append((vote_a, vote_b))

    def add_evidence(self, ev: Evidence) -> bool:
        """pool.go:190 AddEvidence (gossip/RPC path). Returns False if
        already known; raises EvidenceError if invalid."""
        if self.is_pending(ev) or self.is_committed(ev):
            return False
        if self.state is None or self.state_store is None:
            raise EvidenceNotApplicableError(
                "evidence pool has no state yet")
        verify_evidence(ev, self.state, self.state_store,
                        device=self.device, block_store=self.block_store)
        self.db.set(_key(K_PENDING, ev), codec.pack(ev))
        self.on_evidence_added(ev)
        return True

    # ----------------------------------------------------------- queries

    def is_pending(self, ev: Evidence) -> bool:
        return self.db.get(_key(K_PENDING, ev)) is not None

    def is_committed(self, ev: Evidence) -> bool:
        return self.db.get(_key(K_COMMITTED, ev)) is not None

    def _iter_pending(self):
        return self.db.iterate(K_PENDING, K_PENDING + b"\xff" * 48)

    def pending_evidence(self, max_bytes: int) -> list[Evidence]:
        """pool.go PendingEvidence, size-capped for proposals."""
        out, total = [], 0
        for _, raw in sorted(self._iter_pending()):
            ev = codec.unpack(raw)
            total += len(raw)
            if max_bytes > 0 and total > max_bytes:
                break
            out.append(ev)
        return out

    # ------------------------------------------------- block-exec interface

    def check_evidence(self, evidence: list[Evidence]) -> None:
        """Validate evidence carried by a proposed block
        (pool.go CheckEvidence): every item must verify, no duplicates,
        total size within the consensus params cap (a block a validator
        accepts must not exceed what an honest proposer may build)."""
        seen = set()
        total = 0
        max_bytes = (self.state.consensus_params.evidence.max_bytes
                     if self.state is not None else 0)
        for ev in evidence:
            h = ev.hash()
            if h in seen:
                raise EvidenceError("duplicate evidence in block")
            seen.add(h)
            total += len(codec.pack(ev))
            if max_bytes > 0 and total > max_bytes:
                raise EvidenceError(
                    f"evidence in block exceeds max bytes "
                    f"({total} > {max_bytes})")
            if self.is_committed(ev):
                raise EvidenceError("evidence was already committed")
            if not self.is_pending(ev):
                if self.state is None or self.state_store is None:
                    raise EvidenceError("evidence pool has no state yet")
                verify_evidence(ev, self.state, self.state_store,
                                device=self.device,
                                block_store=self.block_store)

    def update(self, state, committed: list[Evidence]) -> None:
        """pool.go Update: mark committed, prune expired, convert buffered
        conflicting votes into DuplicateVoteEvidence."""
        self.state = state
        for ev in committed:
            self.db.set(_key(K_COMMITTED, ev), b"\x01")
            self.db.delete(_key(K_PENDING, ev))
        self._prune_expired(state)
        self._process_conflicting_votes(state)

    def _process_conflicting_votes(self, state) -> None:
        pairs, still_waiting = self._conflicting_votes, []
        self._conflicting_votes = []
        for a, b in pairs:
            try:
                vals = self.state_store.load_validators(a.height) \
                    if self.state_store else None
                # evidence time is pinned to the block time at the vote's
                # height (pool.go processConsensusBuffer)
                blk = self.block_store.load_block(a.height) \
                    if self.block_store else None
                if vals is None or blk is None:
                    if a.height >= state.last_block_height:
                        still_waiting.append((a, b))   # block not yet committed
                    continue
                ev = DuplicateVoteEvidence.from_votes(
                    a, b, blk.header.time_ns, vals)
                if self.is_pending(ev) or self.is_committed(ev):
                    continue
                verify_evidence(ev, state, self.state_store,
                                device=self.device,
                                block_store=self.block_store)
                self.db.set(_key(K_PENDING, ev), codec.pack(ev))
                self.on_evidence_added(ev)
            except EvidenceError:
                continue
        self._conflicting_votes.extend(still_waiting)

    def _prune_expired(self, state) -> None:
        params = state.consensus_params.evidence
        height = state.last_block_height
        now = state.last_block_time_ns
        for key, raw in list(self._iter_pending()):
            ev = codec.unpack(raw)
            if height - ev.height() > params.max_age_num_blocks and \
                    now - ev.time_ns() > params.max_age_duration_ns:
                self.db.delete(key)

    def abci_evidence(self, evidence: list[Evidence],
                      state) -> list[Misbehavior]:
        """types/evidence.go ABCI() — Misbehavior records for FinalizeBlock/
        PrepareProposal so the app can punish (e.g. slash) offenders."""
        out = []
        for ev in evidence:
            if isinstance(ev, DuplicateVoteEvidence):
                out.append(Misbehavior(
                    type=ev.abci_kind(),
                    validator_address=ev.vote_a.validator_address,
                    validator_power=ev.validator_power,
                    height=ev.height(), time_ns=ev.time_ns(),
                    total_voting_power=ev.total_voting_power))
            elif isinstance(ev, LightClientAttackEvidence):
                for val in ev.byzantine_validators:
                    out.append(Misbehavior(
                        type=ev.abci_kind(),
                        validator_address=val.address,
                        validator_power=val.voting_power,
                        height=ev.height(), time_ns=ev.time_ns(),
                        total_voting_power=ev.total_voting_power))
        return out
