"""Shared fixtures of the blocksync-slice parity tests
(``tests/test_torch_block_store.py``, ``tests/test_torch_execution.py``,
``tests/test_torch_blocksync.py``): a chain made by the JAX package's
own ``BlockExecutor``.  The loopback switch that joins two blocksync
reactors of either package in one event loop is ``chip_smoke.py``'s
``LoopSwitch``.

The chain: ``N_VALS`` Ed25519 validators at power 10, heights
1..``HEIGHTS``, each block made by ``create_proposal_block``, its commit
signed by every validator (canonical precommit sign bytes, as
``tests/test_types.py:make_commit`` signs them, with a timestamp a lane
past the block's time), then applied with ``apply_block`` (which
validates it and verifies its last commit).  Vote extensions are on from
``EXT_HEIGHT``, so those heights are saved with their extended commit.
After each height the block store's and the state store's keys and
values are kept, for byte comparisons."""

import asyncio
import dataclasses

from cometbft_tpu.abci.application import Application as JApp
from cometbft_tpu.abci.client import LocalClient as JLocal
from cometbft_tpu.crypto.keys import Ed25519PrivKey as JPriv
from cometbft_tpu.mempool.mempool import NopMempool as JNopMempool
from cometbft_tpu.sm.execution import BlockExecutor as JExecutor
from cometbft_tpu.storage.blockstore import BlockStore as JBlockStore
from cometbft_tpu.storage.db import MemDB as JMemDB
from cometbft_tpu.storage.statestore import State as JState
from cometbft_tpu.storage.statestore import StateStore as JStateStore
from cometbft_tpu.types import canonical as JCanon
from cometbft_tpu.types.block_id import BlockID as JBlockID
from cometbft_tpu.types.commit import BLOCK_ID_FLAG_COMMIT
from cometbft_tpu.types.commit import CommitSig as JCommitSig
from cometbft_tpu.types.commit import ExtendedCommit as JExtCommit
from cometbft_tpu.types.commit import ExtendedCommitSig as JExtSig
from cometbft_tpu.types.genesis import GenesisDoc as JGenesis
from cometbft_tpu.types.genesis import GenesisValidator as JGenVal
from cometbft_tpu.types.params import default_consensus_params
from cometbft_tpu.types.vote import PRECOMMIT_TYPE

CHAIN = "bs-chain"
N_VALS = 4
HEIGHTS = 12
EXT_HEIGHT = 11
T0 = 1_700_000_000_000_000_000


def run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


def privs(n=N_VALS):
    return [JPriv.from_secret(b"bs-torch-%d" % i) for i in range(n)]


def genesis(keys, ext_height=EXT_HEIGHT):
    params = default_consensus_params()
    params.feature.vote_extensions_enable_height = ext_height
    return JGenesis(CHAIN, genesis_time_ns=T0, consensus_params=params,
                    validators=[JGenVal(k.pub_key(), 10) for k in keys])


def sign_ext_commit(state, bid, height, by_addr, ext_on, bad_at=()):
    """Every validator of ``state.validators`` precommits ``bid`` at
    ``height``; lane i's timestamp is ``T0 + height * 10**9 + 1 + i``.
    With ``ext_on`` each lane carries an extension and its signature.
    Lanes in ``bad_at`` have one signature bit flipped."""
    sigs = []
    for i, v in enumerate(state.validators.validators):
        ts = T0 + height * 10**9 + 1 + i
        sb = JCanon.canonical_vote_sign_bytes(CHAIN, PRECOMMIT_TYPE, height,
                                              0, bid, ts)
        sig = by_addr[v.address].sign(sb)
        if i in bad_at:
            sig = sig[:20] + bytes([sig[20] ^ 1]) + sig[21:]
        ext = extsig = b""
        if ext_on:
            ext = b"ext-%d-%d" % (height, i)
            extsig = by_addr[v.address].sign(
                JCanon.canonical_vote_extension_sign_bytes(CHAIN, height, 0,
                                                           ext))
        sigs.append(JExtSig(JCommitSig(BLOCK_ID_FLAG_COMMIT, v.address, ts,
                                       sig), ext, extsig))
    return JExtCommit(height, 0, bid, sigs)


@dataclasses.dataclass
class JaxChain:
    doc: object
    keys: list
    blocks: list            # JAX Blocks, heights 1..HEIGHTS
    parts: list             # their part sets
    ext_commits: list       # the extended commit signed for each height
    states: list            # JAX State after each height (index h - 1)
    block_dbs: list         # block store contents after each height
    state_dbs: list         # state store contents after each height
    block_store: object
    state_store: object


def jax_chain(n_vals=N_VALS, heights=HEIGHTS, ext_height=EXT_HEIGHT):
    keys = privs(n_vals)
    by_addr = {k.pub_key().address(): k for k in keys}
    doc = genesis(keys, ext_height)

    async def build():
        bdb, sdb = JMemDB(), JMemDB()
        bs, ss = JBlockStore(bdb), JStateStore(sdb)
        ex = JExecutor(ss, bs, JLocal(JApp()), JNopMempool(), backend="cpu")
        state = JState.from_genesis(doc)
        ss.save(state)
        out = JaxChain(doc, keys, [], [], [], [], [], [], bs, ss)
        last_ext = JExtCommit(0, 0, JBlockID(), [])
        for h in range(1, heights + 1):
            proposer = state.validators.get_proposer().address
            block, parts = await ex.create_proposal_block(
                h, state, last_ext, proposer, T0 + h * 10**9)
            bid = JBlockID(block.hash(), parts.header())
            ext_on = state.consensus_params.feature.vote_extensions_enabled(h)
            ext = sign_ext_commit(state, bid, h, by_addr, ext_on)
            if ext_on:
                bs.save_block_with_extended_commit(block, parts, ext)
            else:
                bs.save_block(block, parts, ext.to_commit())
            state = await ex.apply_block(state, bid, block)
            out.blocks.append(block)
            out.parts.append(parts)
            out.ext_commits.append(ext)
            out.states.append(state)
            out.block_dbs.append(dict(bdb._data))
            out.state_dbs.append(dict(sdb._data))
            last_ext = ext
        return out

    return run(build())
