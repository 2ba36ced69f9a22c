"""State provider: trusted ``sm.State`` + ``Commit`` for a snapshot height
via the light client (counterpart of
``cometbft_tpu/statesync/stateprovider.py``; reference:
``statesync/stateprovider.go:38-79`` lightClientStateProvider).

The light client verifies headers h, h+1 and h+2 on its device: at a
large validator set each is a ``VerifyCommitLight(Trusting)`` through
the table and RLC kernels.

The state AFTER block h needs light blocks h, h+1 and h+2: the app hash
and last-results hash as of h live in header h+1, and the validator sets
rotate one height ahead (State.validators is the set for the NEXT
block).

Light-block fetches go over the network, so TRANSIENT provider failures
(timeouts, dropped connections) get a bounded exponential-backoff retry
— the same discipline as ``light/rpc_provider.py`` — instead of one
flaky fetch of ``app_hash(h)`` failing the whole snapshot round.
Verification failures (a bad or forked header) are NOT transient and
surface immediately: retrying cannot make a dishonest header honest."""

from __future__ import annotations

import asyncio

from ..libs import clock
from ..libs import log as tmlog

from ..light.client import Client
from ..storage.statestore import State
from ..types.commit import Commit

# Transient = the fetch itself failed, not what it fetched.
# ConnectionError is an OSError subclass; asyncio.TimeoutError aliases
# TimeoutError on modern Pythons but both spellings stay for clarity.
_TRANSIENT = (TimeoutError, asyncio.TimeoutError, OSError)


class StateProvider:
    def __init__(self, light_client: Client, genesis_doc, *,
                 retries: int = 2, backoff_s: float = 0.25):
        self.client = light_client
        self.genesis = genesis_doc
        self.retries = max(0, int(retries))
        self.backoff_s = float(backoff_s)
        self.log = tmlog.logger("statesync.provider")

    async def _verify(self, height: int):
        """``verify_light_block_at_height`` with bounded exponential
        backoff on transient failures."""
        delay = self.backoff_s
        for attempt in range(self.retries + 1):
            try:
                return await self.client.verify_light_block_at_height(
                    height)
            except _TRANSIENT as e:
                if attempt >= self.retries:
                    raise
                self.log.warn("transient light-block fetch failure; "
                              "retrying", height=height,
                              attempt=attempt + 1, err=repr(e))
                await clock.sleep(delay)
                delay *= 2

    async def app_hash(self, height: int) -> bytes:
        """App hash AFTER block ``height`` (stateprovider.go AppHash —
        header at height+1 carries it)."""
        nxt = await self._verify(height + 1)
        return nxt.header.app_hash

    async def commit(self, height: int) -> Commit:
        lb = await self._verify(height)
        return lb.commit

    async def state(self, height: int) -> State:
        """stateprovider.go State(): assemble the post-``height`` state."""
        cur = await self._verify(height)
        nxt = await self._verify(height + 1)
        nxt2 = await self._verify(height + 2)
        from ..types.block_id import BlockID

        return State(
            chain_id=self.genesis.chain_id,
            initial_height=self.genesis.initial_height,
            last_block_height=height,
            last_block_id=BlockID(cur.header.hash(),
                                  nxt.header.last_block_id.part_set_header),
            last_block_time_ns=cur.header.time_ns,
            validators=nxt.validators,
            next_validators=nxt2.validators,
            last_validators=cur.validators,
            last_height_validators_changed=height + 1,
            consensus_params=self.genesis.consensus_params,
            last_height_params_changed=self.genesis.initial_height,
            last_results_hash=nxt.header.last_results_hash,
            app_hash=nxt.header.app_hash,
        )
