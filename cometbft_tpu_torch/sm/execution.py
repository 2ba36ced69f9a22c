"""BlockExecutor (reference: ``state/execution.go:24-460``): proposal
creation, proposal processing, block application, state transitions
and events.

Counterpart of ``cometbft_tpu/sm/execution.py``.  ``device`` is where the
executor's commit verification and large hashes run (None: CUDA;
``"cpu"``: the plain versions).  The evidence pool is
:class:`NopEvidencePool` (the evidence slice comes later); with no
``pruner`` the retain height prunes the stores inline.
"""

from __future__ import annotations

from dataclasses import replace

from ..abci import types as abci
from ..abci.client import ABCIClient, _decode_value, _encode_value
from ..crypto.keys import pub_key_from_type_bytes
from ..libs.fail import fail_point
from ..libs.pubsub import EventBus
from ..mempool.mempool import Mempool, TxKey
from ..storage.blockstore import BlockStore
from ..storage.statestore import State, StateStore
from ..types import _msgpack, codec
from ..types import events as ev
from ..types.block_id import BlockID
from ..types.commit import ExtendedCommit, aggregate_commit
from ..types.header import Block, Data, Header
from ..types.part_set import PartSet
from ..types.validator_set import Validator
from ..types.vote import Vote
from .validation import BlockValidationError, median_time, validate_block

__all__ = ["NopEvidencePool", "BlockExecutor", "unpack_finalize_response"]


class NopEvidencePool:
    def pending_evidence(self, max_bytes: int) -> list:
        return []

    def check_evidence(self, evidence: list) -> None:
        pass

    def update(self, state: State, evidence: list) -> None:
        pass

    def abci_evidence(self, evidence: list, state: State) -> list:
        return []


class BlockExecutor:
    def __init__(self, state_store: StateStore, block_store: BlockStore,
                 app_conn: ABCIClient, mempool: Mempool,
                 evidence_pool=None, event_bus: EventBus | None = None,
                 device=None, pruner=None):
        self.state_store = state_store
        self.block_store = block_store
        self.app = app_conn
        self.mempool = mempool
        self.evidence_pool = evidence_pool or NopEvidencePool()
        self.event_bus = event_bus or EventBus()
        self.device = device
        self.pruner = pruner

    # ----------------------------------------------------------- proposals

    async def create_proposal_block(self, height: int, state: State,
                                    last_ext_commit: ExtendedCommit,
                                    proposer_addr: bytes,
                                    now_ns: int) -> tuple[Block, PartSet]:
        """Reap the mempool and evidence, run ABCI PrepareProposal and
        assemble the block (state/execution.go:108)."""
        max_bytes = state.consensus_params.block.max_bytes
        max_gas = state.consensus_params.block.max_gas
        evidence = self.evidence_pool.pending_evidence(
            state.consensus_params.evidence.max_bytes)
        max_data = max_bytes - 2048 if max_bytes > 0 else -1
        txs = self.mempool.reap_max_bytes_max_gas(max_data, max_gas)
        # the BLS for-block cohort folds into one aggregate; deterministic,
        # so every correct proposer derives the same last_commit bytes
        last_commit = aggregate_commit(
            last_ext_commit.to_commit(),
            state.last_validators or state.validators)

        if height == state.initial_height:
            block_time = max(state.last_block_time_ns + 1, now_ns)
        elif state.consensus_params.feature.pbts_enabled(height):
            block_time = now_ns
        else:
            # BFT time over the authenticated (Ed25519) lanes; a commit
            # with none takes the deterministic minimum advance
            block_time = median_time(
                last_commit, state.last_validators or state.validators) \
                or state.last_block_time_ns + 1

        req = abci.PrepareProposalRequest(
            max_tx_bytes=max_data, txs=txs, height=height,
            time_ns=block_time, proposer_address=proposer_addr,
            local_last_commit=last_ext_commit,
            misbehavior=self.evidence_pool.abci_evidence(evidence, state))
        resp = await self.app.prepare_proposal(req)

        header = Header(
            chain_id=state.chain_id, height=height, time_ns=block_time,
            last_block_id=state.last_block_id,
            validators_hash=state.validators.hash(self.device),
            next_validators_hash=state.next_validators.hash(self.device),
            consensus_hash=state.consensus_params.hash(),
            app_hash=state.app_hash,
            last_results_hash=state.last_results_hash,
            proposer_address=proposer_addr)
        block = Block(header=header, data=Data(txs=list(resp.txs)),
                      evidence=evidence,
                      last_commit=last_commit if height > state.initial_height
                      else None)
        block.fill_hashes(self.device)
        parts = PartSet.from_data(codec.pack(block), device=self.device)
        return block, parts

    async def process_proposal(self, block: Block, state: State) -> bool:
        """ABCI ProcessProposal (state/execution.go:168)."""
        req = abci.ProcessProposalRequest(
            txs=list(block.data.txs), height=block.header.height,
            time_ns=block.header.time_ns, hash=block.hash(),
            proposer_address=block.header.proposer_address,
            misbehavior=self.evidence_pool.abci_evidence(
                block.evidence, state))
        status = await self.app.process_proposal(req)
        return status == abci.PROCESS_PROPOSAL_ACCEPT

    # ----------------------------------------------------------- validation

    def validate_block(self, state: State, block: Block) -> None:
        validate_block(state, block, device=self.device)
        self.evidence_pool.check_evidence(block.evidence)

    # ------------------------------------------------------------ execution

    async def apply_block(self, state: State, block_id: BlockID,
                          block: Block, syncing_to_height: int = 0,
                          verified: bool = False) -> State:
        """FinalizeBlock, the state update, Commit with the mempool
        update, pruning and events (state/execution.go:227 applyBlock).
        ``verified`` skips validation (ApplyVerifiedBlock, :217)."""
        if not verified:
            self.validate_block(state, block)

        req = abci.FinalizeBlockRequest(
            txs=list(block.data.txs), height=block.header.height,
            time_ns=block.header.time_ns, hash=block.hash(),
            proposer_address=block.header.proposer_address,
            decided_last_commit=block.last_commit,
            misbehavior=self.evidence_pool.abci_evidence(
                block.evidence, state),
            syncing_to_height=syncing_to_height or block.header.height)
        resp = await self.app.finalize_block(req)
        if len(resp.tx_results) != len(block.data.txs):
            raise BlockValidationError(
                f"app returned {len(resp.tx_results)} tx results for "
                f"{len(block.data.txs)} txs")

        fail_point("exec:after-finalize-block")   # execution.go:261-311
        self.state_store.save_finalize_block_response(
            block.header.height, _pack_finalize_response(resp))
        fail_point("exec:after-save-response")

        new_state = self._update_state(state, block_id, block, resp)

        # Commit: the mempool stays locked across the app's Commit and
        # its own update (state/execution.go:391-460)
        async with self.mempool.lock():
            commit_resp = await self.app.commit()
            await self.mempool.update(block.header.height,
                                      list(block.data.txs), resp.tx_results)
        fail_point("exec:after-app-commit")
        self.state_store.save(new_state)
        fail_point("exec:after-state-save")
        self.evidence_pool.update(new_state, block.evidence)

        retain = commit_resp.retain_height
        if retain > 0:
            if self.pruner is not None:
                self.pruner.set_app_retain_height(retain)
            else:
                try:
                    self.block_store.prune_blocks(
                        min(retain, self.block_store.height()))
                    self.state_store.prune_states(retain)
                except ValueError:
                    pass

        self._fire_events(block, block_id, resp)
        return new_state

    def _update_state(self, state: State, block_id: BlockID, block: Block,
                      resp: abci.FinalizeBlockResponse) -> State:
        """state/execution.go updateState: rotate the validator sets,
        apply the updates, advance the proposer priorities."""
        height = block.header.height
        next_vals = state.next_validators.copy()
        changed_height = state.last_height_validators_changed
        if resp.validator_updates:
            changes = []
            allowed = state.consensus_params.validator.pub_key_types
            for vu in resp.validator_updates:
                if vu.pub_key_type not in allowed:
                    raise BlockValidationError(
                        f"validator key type {vu.pub_key_type} not in "
                        f"allowed {allowed}")
                try:
                    key = pub_key_from_type_bytes(vu.pub_key_type,
                                                  vu.pub_key_bytes)
                except ValueError as e:
                    raise BlockValidationError(str(e)) from e
                # a bls12_381 key entering the set proves possession of
                # its secret (the rogue-key defence of aggregation);
                # removals and power changes of admitted keys need none
                if (vu.pub_key_type == "bls12_381" and vu.power > 0
                        and not next_vals.has_address(key.address())):
                    from ..crypto import bls12381 as _bls

                    if not vu.pop:
                        raise BlockValidationError(
                            "bls12_381 validator update admits key "
                            f"{key.bytes().hex()[:16]}… without a proof "
                            "of possession")
                    if not _bls.pop_verify(key.bytes(), vu.pop):
                        raise BlockValidationError(
                            "bls12_381 validator update for key "
                            f"{key.bytes().hex()[:16]}…: proof of "
                            "possession failed to verify")
                changes.append(Validator(key, vu.power))
            next_vals.update_with_change_set(changes)
            changed_height = height + 1
        next_vals.increment_proposer_priority(1)

        params = state.consensus_params
        params_height = state.last_height_params_changed
        if resp.consensus_param_updates is not None:
            params = resp.consensus_param_updates
            params_height = height + 1

        return replace(
            state,
            last_block_height=height,
            last_block_id=block_id,
            last_block_time_ns=block.header.time_ns,
            validators=state.next_validators.copy(),
            next_validators=next_vals,
            last_validators=state.validators.copy(),
            last_height_validators_changed=changed_height,
            consensus_params=params,
            last_height_params_changed=params_height,
            last_results_hash=resp.results_hash(self.device),
            app_hash=resp.app_hash,
        )

    def _fire_events(self, block: Block, block_id: BlockID,
                     resp: abci.FinalizeBlockResponse) -> None:
        h = str(block.header.height)
        self.event_bus.publish(ev.EVENT_NEW_BLOCK,
                               {"block": block, "block_id": block_id,
                                "result": resp},
                               {ev.BLOCK_HEIGHT_KEY: h})
        self.event_bus.publish(ev.EVENT_NEW_BLOCK_HEADER,
                               {"header": block.header},
                               {ev.BLOCK_HEIGHT_KEY: h})
        self.event_bus.publish(ev.EVENT_NEW_BLOCK_EVENTS,
                               {"events": resp.events, "height": h},
                               {ev.BLOCK_HEIGHT_KEY: h})
        for i, tx in enumerate(block.data.txs):
            self.event_bus.publish(
                ev.EVENT_TX,
                {"tx": tx, "result": resp.tx_results[i],
                 "height": block.header.height, "index": i},
                {ev.TX_HASH_KEY: TxKey(tx).hex(), ev.TX_HEIGHT_KEY: h})
        if resp.validator_updates:
            self.event_bus.publish(ev.EVENT_VALIDATOR_SET_UPDATES,
                                   {"updates": resp.validator_updates})

    # ------------------------------------------------------ vote extensions

    async def extend_vote(self, vote: Vote) -> bytes:
        resp = await self.app.extend_vote(vote.height, vote.round,
                                          vote.block_id.hash)
        return resp.vote_extension

    async def verify_vote_extension(self, vote: Vote) -> bool:
        resp = await self.app.verify_vote_extension(
            vote.height, vote.round, vote.validator_address,
            vote.block_id.hash, vote.extension)
        return resp.accepted


def _pack_finalize_response(resp: abci.FinalizeBlockResponse) -> bytes:
    return _msgpack.packb(_encode_value(resp))


def unpack_finalize_response(raw: bytes) -> abci.FinalizeBlockResponse:
    return _decode_value(_msgpack.unpackb(raw))
