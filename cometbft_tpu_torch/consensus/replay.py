"""Handshaker: reconcile app height with store/state height on startup
(counterpart of ``cometbft_tpu/consensus/replay.py``; reference:
``internal/consensus/replay.go:201-446`` ReplayBlocks case matrix).

Cases handled:
- fresh chain (state height 0): InitChain, apply the app's genesis response
  (validators / app hash / params overrides) to state;
- store height == state height + 1 (crash after SaveBlock + WAL EndHeight
  but before ApplyBlock): apply that block through the executor;
- app behind state: replay stored blocks into the app (FinalizeBlock +
  Commit only — state already reflects them);
- app ahead of state: unrecoverable, raise.
"""

from __future__ import annotations

from dataclasses import replace as dc_replace

from ..abci import types as abci
from ..crypto import bls12381 as _bls
from ..crypto.keys import pub_key_from_type_bytes
from ..proxy.multi_app_conn import AppConns
from ..sm.execution import BlockExecutor, unpack_finalize_response
from ..storage.blockstore import BlockStore
from ..storage.statestore import State, StateStore
from ..types.genesis import GenesisDoc
from ..types.validator_set import Validator, ValidatorSet


class HandshakeError(Exception):
    pass


class Handshaker:
    def __init__(self, state_store: StateStore, block_store: BlockStore,
                 genesis_doc: GenesisDoc):
        self.state_store = state_store
        self.block_store = block_store
        self.genesis = genesis_doc

    async def handshake(self, state: State, app_conns: AppConns,
                        executor: BlockExecutor) -> State:
        info = await app_conns.query.info()
        app_height = info.last_block_height
        store_height = self.block_store.height()

        if state.last_block_height == 0 and app_height == 0:
            state = await self._init_chain(state, app_conns)

        if app_height == store_height == state.last_block_height + 1:
            # Crash between app Commit and state save (the
            # exec:after-app-commit window): a PERSISTENT app already
            # holds block H, so re-executing would double-apply it.
            # Advance state from the persisted finalize response alone —
            # the reference handles appBlockHeight == storeBlockHeight
            # with a mock app built from stored ABCI responses
            # (replay.go ReplayBlocks -> replayBlock via mockProxyApp).
            state = self._recover_state_from_stored_response(
                state, store_height, executor)

        if app_height > state.last_block_height:
            raise HandshakeError(
                f"app height {app_height} ahead of state "
                f"{state.last_block_height}")

        # replay blocks the app missed (app-only: state already has them)
        for h in range(app_height + 1, state.last_block_height + 1):
            block = self.block_store.load_block(h)
            if block is None:
                raise HandshakeError(f"missing block {h} for app replay")
            req = abci.FinalizeBlockRequest(
                txs=list(block.data.txs), height=h,
                time_ns=block.header.time_ns, hash=block.hash(),
                proposer_address=block.header.proposer_address,
                decided_last_commit=block.last_commit,
                syncing_to_height=state.last_block_height)
            resp = await app_conns.consensus.finalize_block(req)
            await app_conns.consensus.commit()
            # Pinpoint divergence at the FIRST height whose replayed app
            # hash disagrees with the stored per-height ABCI response,
            # not just at the tip: "which height first diverged" is the
            # fact a post-mortem needs
            stored_hash = None
            raw = self.state_store.load_finalize_block_response(h)
            if raw is not None:
                stored_hash = unpack_finalize_response(raw).app_hash
            if stored_hash is not None and resp.app_hash != stored_hash:
                raise HandshakeError(
                    f"app hash mismatch after replay at {h} (first "
                    f"divergent height; replaying {app_height + 1}.."
                    f"{state.last_block_height}): replayed "
                    f"{resp.app_hash.hex()} != stored {stored_hash.hex()} "
                    f"({len(block.data.txs)} txs at {h})")
            if h == state.last_block_height and \
                    resp.app_hash != state.app_hash:
                raise HandshakeError(
                    f"app hash mismatch after replay at {h}: "
                    f"replayed {resp.app_hash.hex()} != stored "
                    f"{state.app_hash.hex()} (app replayed from "
                    f"{app_height + 1})")

        # Crash between SaveBlock and ApplyBlock: finish applying the
        # pending block — AFTER the catch-up replay above, so the app
        # has seen every earlier block exactly once.  The previous
        # ordering (recovery first) both fed the pending block to an app
        # that could still be missing earlier blocks AND re-finalized it
        # in the replay loop (the loop's app_height predates the
        # recovery apply) — a double-execution that idempotent apps mask
        # but stateful ones must never see.
        if store_height == state.last_block_height + 1 and store_height > 0:
            block = self.block_store.load_block(store_height)
            meta = self.block_store.load_block_meta(store_height)
            state = await executor.apply_block(state, meta.block_id, block)
            self.state_store.save(state)
        return state

    def _recover_state_from_stored_response(self, state: State, height: int,
                                            executor: BlockExecutor) -> State:
        """Advance state over a block the app has already committed,
        using the finalize response persisted before the app Commit
        (``exec:after-save-response`` precedes ``exec:after-app-commit``,
        so the response is always on disk in this crash window) — no
        FinalizeBlock/Commit is sent to the app."""
        block = self.block_store.load_block(height)
        meta = self.block_store.load_block_meta(height)
        raw = self.state_store.load_finalize_block_response(height)
        if block is None or meta is None or raw is None:
            raise HandshakeError(
                f"app height {height} ahead of state "
                f"{state.last_block_height} and no stored block/response "
                f"to recover from")
        # Cross-check the stored artifacts against each other and against
        # the state lineage BEFORE persisting anything: this path runs
        # exactly once after a crash, on data a partial write (or a
        # corrupted store) could have mangled — silently advancing state
        # over a block whose header doesn't match its own meta would fork
        # this node from the network at the next commit.
        block_hash = block.hash()
        if meta.block_id.hash != block_hash:
            raise HandshakeError(
                f"recovery block {height} header hash "
                f"{block_hash.hex()} does not match stored meta block_id "
                f"{meta.block_id.hash.hex()}: blockstore corrupt")
        if block.header.height != height:
            raise HandshakeError(
                f"recovery block at store height {height} claims header "
                f"height {block.header.height}: blockstore corrupt")
        if height != state.last_block_height + 1:
            raise HandshakeError(
                f"recovery block {height} does not extend state height "
                f"{state.last_block_height}")
        if state.last_block_height > 0 and \
                block.header.app_hash != state.app_hash:
            raise HandshakeError(
                f"recovery block {height} app_hash "
                f"{block.header.app_hash.hex()} breaks lineage: state at "
                f"{state.last_block_height} expects "
                f"{state.app_hash.hex()}")
        resp = unpack_finalize_response(raw)
        state = executor._update_state(state, meta.block_id, block, resp)
        self.state_store.save(state)
        return state

    async def _init_chain(self, state: State, app_conns: AppConns) -> State:
        """InitChain + genesis-response overrides (replay.go:310)."""
        vals = [abci.ValidatorUpdate(v.pub_key.type(), v.pub_key.bytes(),
                                     v.power, pop=v.pop)
                for v in self.genesis.validators]
        resp = await app_conns.consensus.init_chain(abci.InitChainRequest(
            chain_id=self.genesis.chain_id,
            initial_height=self.genesis.initial_height,
            time_ns=self.genesis.genesis_time_ns,
            validators=vals,
            app_state_bytes=self.genesis.app_state,
            consensus_params=self.genesis.consensus_params))
        if resp.validators:
            # the app's genesis response ADMITS keys (it replaces the
            # genesis valset wholesale), so bls12_381 entries must carry
            # a verifying proof of possession exactly like genesis-doc
            # validators and later ABCI updates — rogue-key gate
            for vu in resp.validators:
                if vu.pub_key_type != "bls12_381" or vu.power <= 0:
                    continue
                if not vu.pop or not _bls.pop_verify(vu.pub_key_bytes,
                                                     vu.pop):
                    raise HandshakeError(
                        "InitChain response admits bls12_381 key "
                        f"{vu.pub_key_bytes.hex()[:16]}… without a "
                        "verifying proof of possession")
            new_vals = ValidatorSet(
                [Validator(pub_key_from_type_bytes(vu.pub_key_type,
                                                   vu.pub_key_bytes),
                           vu.power)
                 for vu in resp.validators])
            state = dc_replace(
                state, validators=new_vals,
                next_validators=new_vals.copy_increment_proposer_priority(1))
        if resp.app_hash:
            state = dc_replace(state, app_hash=resp.app_hash)
        if resp.consensus_params is not None:
            state = dc_replace(state, consensus_params=resp.consensus_params)
        self.state_store.save(state)
        return state
