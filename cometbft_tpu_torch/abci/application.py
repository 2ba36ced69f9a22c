"""Application base class: the 14 methods of ABCI 2.0 (reference:
``abci/types/application.go:9-35``; counterpart of
``cometbft_tpu/abci/application.py``).  Every method is async; a local
application runs inline."""

from __future__ import annotations

from . import types as t


class Application:
    """Override what you need; defaults are legal no-ops."""

    # ------------------------------------------------------------- info/query

    async def info(self) -> t.InfoResponse:
        return t.InfoResponse()

    async def query(self, path: str, data: bytes, height: int,
                    prove: bool) -> t.QueryResponse:
        return t.QueryResponse()

    # --------------------------------------------------------------- mempool

    async def check_tx(self, tx: bytes, recheck: bool = False
                       ) -> t.CheckTxResponse:
        return t.CheckTxResponse()

    # ------------------------------------------------------------- consensus

    async def init_chain(self, req: t.InitChainRequest) -> t.InitChainResponse:
        return t.InitChainResponse()

    async def prepare_proposal(self, req: t.PrepareProposalRequest
                               ) -> t.PrepareProposalResponse:
        # default: include txs up to the size limit (like the reference's
        # default PrepareProposal tx selection)
        total, out = 0, []
        for tx in req.txs:
            total += len(tx)
            if req.max_tx_bytes >= 0 and total > req.max_tx_bytes:
                break
            out.append(tx)
        return t.PrepareProposalResponse(txs=out)

    async def process_proposal(self, req: t.ProcessProposalRequest) -> int:
        return t.PROCESS_PROPOSAL_ACCEPT

    async def finalize_block(self, req: t.FinalizeBlockRequest
                             ) -> t.FinalizeBlockResponse:
        return t.FinalizeBlockResponse(
            tx_results=[t.ExecTxResult() for _ in req.txs])

    async def extend_vote(self, height: int, round_: int,
                          block_hash: bytes) -> t.ExtendVoteResponse:
        return t.ExtendVoteResponse()

    async def verify_vote_extension(self, height: int, round_: int,
                                    validator_address: bytes,
                                    block_hash: bytes, extension: bytes
                                    ) -> t.VerifyVoteExtensionResponse:
        return t.VerifyVoteExtensionResponse()

    async def commit(self) -> t.CommitResponse:
        return t.CommitResponse()

    # ------------------------------------------------------------- snapshots

    async def list_snapshots(self) -> list[t.Snapshot]:
        return []

    async def offer_snapshot(self, snapshot: t.Snapshot,
                             app_hash: bytes) -> int:
        return t.OFFER_SNAPSHOT_REJECT

    async def load_snapshot_chunk(self, height: int, format_: int,
                                  chunk: int) -> bytes:
        return b""

    async def apply_snapshot_chunk(self, index: int, chunk: bytes,
                                   sender: str):
        """Return a status int or a full t.ApplySnapshotChunkResponse
        (refetch_chunks / reject_senders honored by the syncer)."""
        return t.APPLY_CHUNK_ABORT
