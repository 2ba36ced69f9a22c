"""ABCI 2.0 call-sequence grammar checker (counterpart of
``cometbft_tpu/abci/grammar.py``; reference:
``test/e2e/pkg/grammar/checker.go`` + ``abci_grammar.md``): the e2e tier
records every ABCI call a node makes and validates the ordering against
the legal protocol grammar.

Grammar (consensus + statesync surface)::

    start      := init | statesync | recovery
    init       := InitChain height*
    statesync  := OfferSnapshot ApplySnapshotChunk* height*
    recovery   := height*                     (replay after restart)
    height     := proposal* FinalizeBlock Commit
    proposal   := PrepareProposal | ProcessProposal

Mempool (CheckTx) and query (Info/Query/Echo) calls ride separate logical
connections and may interleave anywhere; vote-extension calls
(ExtendVote / VerifyVoteExtension) may appear between proposals and
FinalizeBlock of their height."""

from __future__ import annotations

import inspect as _inspect

from .application import Application

__all__ = ["GrammarError", "check_sequence", "RecordingApp"]

# calls checked by the grammar (consensus + statesync connections)
_SEQUENCED = {
    "init_chain", "prepare_proposal", "process_proposal",
    "finalize_block", "commit", "offer_snapshot", "apply_snapshot_chunk",
}
# free interleave (mempool/query conns + vote extensions + snapshot serving)
_FREE = {
    "echo", "info", "query", "check_tx", "list_snapshots",
    "load_snapshot_chunk", "extend_vote", "verify_vote_extension",
}


class GrammarError(Exception):
    def __init__(self, pos: int, call: str, state: str, seq: list[str]):
        self.pos = pos
        window = seq[max(0, pos - 4):pos + 3]
        super().__init__(
            f"illegal ABCI call {call!r} at position {pos} in state "
            f"{state!r} (context: {window})")


def check_sequence(calls: list[str]) -> int:
    """Validate a recorded call sequence; returns the number of completed
    heights.  Raises GrammarError on the first illegal transition."""
    seq = [c for c in calls if c in _SEQUENCED]
    state = "start"
    heights = 0
    for pos, call in enumerate(seq):
        if state == "start":
            if call == "init_chain":
                state = "chain"
                continue
            if call == "offer_snapshot":
                state = "restoring"
                continue
            # recovery: straight into the height loop
            state = "chain"
        if state == "restoring":
            if call == "apply_snapshot_chunk":
                continue
            if call == "offer_snapshot":
                continue               # retry with the next snapshot
            state = "chain"            # restore done; fall into heights
        if state == "chain":
            if call in ("prepare_proposal", "process_proposal"):
                state = "proposing"
                continue
            if call == "finalize_block":
                state = "finalized"
                continue
            raise GrammarError(pos, call, state, seq)
        if state == "proposing":
            if call in ("prepare_proposal", "process_proposal"):
                continue
            if call == "finalize_block":
                state = "finalized"
                continue
            raise GrammarError(pos, call, state, seq)
        if state == "finalized":
            if call == "commit":
                heights += 1
                state = "chain"
                continue
            raise GrammarError(pos, call, state, seq)
        raise GrammarError(pos, call, state, seq)
    return heights


class RecordingApp:
    """Wrap an application; record the name of every ABCI call in order
    (the e2e node's call logger).

    Deliberately NOT an Application subclass: the base class ships concrete
    no-op methods, which would shadow ``__getattr__`` delegation and record
    nothing."""

    def __init__(self, inner: Application):
        self.inner = inner
        self.calls: list[str] = []

    def __getattr__(self, name):
        target = getattr(self.inner, name)
        if not callable(target):
            return target
        if not _inspect.iscoroutinefunction(target):
            return target

        async def recorded(*args, **kwargs):
            self.calls.append(name)
            return await target(*args, **kwargs)

        return recorded

    def check(self) -> int:
        return check_sequence(self.calls)
