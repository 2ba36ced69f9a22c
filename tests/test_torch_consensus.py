"""The port's consensus in one process (``cometbft_tpu_torch/testing.py``'s
in-process network over ``consensus/state.py``), on the CPU: the cases of
``tests/test_consensus.py`` on the port's harness with ``device="cpu"``
(the verification scheduler and every kernel's plain version on the CPU),
and the slice as a whole against the JAX package: a port network's
committed blocks, decoded by the JAX codec, replayed through the JAX
package's ``BlockExecutor`` from the same genesis give, height by height,
the same stored state bytes and app hashes.

A one-lane check of the plain versions takes about 0.4 s here, and a
height of 4 validators needs 12 of them (4 proposal checks, 8 own
votes), so a height takes seconds and a round may time out into the
next; the cases hold safety (no fork) and liveness (the height is
reached), as the JAX package's do, with waits sized for that.  The
timing cases (PBTS, empty blocks, skip timeout commit) and the WAL
recovery are in ``tests/test_torch_consensus_config.py``."""

import asyncio
import base64

import pytest
import torch

from cometbft_tpu_torch.crypto import _ed25519_py as ref
from cometbft_tpu_torch.crypto import scheduler as vsched
from cometbft_tpu_torch.testing import make_inproc_network

torch.set_num_threads(1)

pytestmark = pytest.mark.timeout(120)


def run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


@pytest.fixture(autouse=True)
def no_host_verify(monkeypatch):
    """Every signature check of the port's consensus runs on the device
    (here the plain versions on the CPU): the host oracle must never be
    called, and no scheduler outlives a case."""
    def refuse(*a, **kw):
        raise AssertionError("host oracle called on the consensus path")

    monkeypatch.setattr(ref, "verify_zip215", refuse)
    vsched.set_scheduler(None)
    yield
    vsched.set_scheduler(None)


def _agree(nodes, top):
    for h in range(1, top + 1):
        hashes = {n.block_store.load_block(h).hash() for n in nodes}
        assert len(hashes) == 1, f"fork at height {h}"


def test_four_validators_commit_blocks():
    """Four validators commit kvstore blocks through a full proposer
    rotation; every injected tx is committed and executed everywhere."""

    async def main():
        net = await make_inproc_network(4, device="cpu")
        try:
            sched = vsched.get_scheduler()
            assert sched is not None and sched.device == "cpu"
            await net.start()
            for i, node in enumerate(net.nodes):
                await node.mempool.check_tx(b"k%d=v%d" % (i, i))
            await net.wait_for_height(6, timeout=110)
            _agree(net.nodes, 6)
            committed = {bytes(tx) for n in net.nodes
                         for h in range(1, n.block_store.height() + 1)
                         for tx in n.block_store.load_block(h).data.txs}
            want = {b"k%d=v%d" % (i, i) for i in range(4)}
            assert want <= committed, committed
            for n in net.nodes:
                if n.block_store.height() >= 6:
                    assert n.app.state.get(b"k0") == b"v0"
            st = sched.stats()
            # device lanes only: own votes (sync misses), proposals
            # (uncached); every peer's vote was a cache hit
            assert set(st["single_checks"]) <= {"sync", "uncached"}
            assert st["lanes_bad"] == 0
        finally:
            await net.stop()
        assert vsched.get_scheduler() is None   # released in stop()
        return True

    assert run(main())


def test_progress_with_one_node_down():
    async def main():
        net = await make_inproc_network(4, device="cpu")
        try:
            net.isolate("node3")
            await net.start()
            await net.wait_for_height(2, timeout=100, nodes=net.nodes[:3])
            assert net.nodes[3].block_store.height() == 0
            _agree(net.nodes[:3], 2)
        finally:
            await net.stop()
        return True

    assert run(main())


def test_no_progress_without_quorum():
    async def main():
        net = await make_inproc_network(4, device="cpu")
        try:
            net.isolate("node2")
            net.isolate("node3")
            await net.start()
            await asyncio.sleep(2.0)
            assert all(n.block_store.height() == 0 for n in net.nodes)
        finally:
            await net.stop()
        return True

    assert run(main())


def test_vote_extensions_enabled():
    async def main():
        net = await make_inproc_network(4, vote_extensions_height=1,
                                        device="cpu")
        try:
            await net.start()
            await net.wait_for_height(2, timeout=100)
            ext = net.nodes[0].block_store.load_block_extended_commit(1)
            assert ext is not None and ext.ensure_extensions(True)
            n_with_ext = sum(1 for e in ext.extended_signatures
                             if e.commit_sig.is_commit()
                             and e.extension_signature)
            assert n_with_ext >= 3
            _agree(net.nodes, 2)
        finally:
            await net.stop()
        return True

    assert run(main())


def test_invalid_proposal_is_rejected_and_chain_continues():
    async def main():
        from cometbft_tpu_torch.types import codec
        from cometbft_tpu_torch.types.block_id import BlockID
        from cometbft_tpu_torch.types.header import Block, Data, Header
        from cometbft_tpu_torch.types.part_set import PartSet
        from cometbft_tpu_torch.types.vote import Proposal

        net = await make_inproc_network(4, device="cpu")
        try:
            cs0 = net.nodes[0].consensus
            proposer_addr = cs0.state.validators.get_proposer().address
            byz = next(n for n in net.nodes
                       if n.pv.get_pub_key().address() == proposer_addr)
            net.isolate(byz.name)
            await net.start()
            header = Header(chain_id="test-net", height=1, time_ns=1,
                            validators_hash=b"\x11" * 32,
                            next_validators_hash=b"\x22" * 32,
                            proposer_address=proposer_addr)
            bad = Block(header=header, data=Data(txs=[b"evil"]),
                        evidence=[], last_commit=None)
            bad.fill_hashes(device="cpu")
            parts = PartSet.from_data(codec.pack(bad), device="cpu")
            bid = BlockID(bad.hash(), parts.header())
            prop = Proposal(height=1, round=0, pol_round=-1, block_id=bid,
                            timestamp_ns=bad.header.time_ns)
            await byz.pv.sign_proposal("test-net", prop)
            honest = [n for n in net.nodes if n is not byz]
            for node in honest:
                node.consensus.feed_proposal(prop, "byz")
                for i in range(parts.total):
                    node.consensus.feed_block_part(1, 0, parts.get_part(i),
                                                   "byz")
            await net.wait_for_height(2, timeout=100, nodes=honest)
            for node in honest:
                blk1 = node.block_store.load_block(1)
                assert blk1.hash() != bad.hash(), "garbage block committed!"
                assert b"evil" not in [bytes(t) for t in blk1.data.txs]
            _agree(honest, 2)
        finally:
            await net.stop()
        return True

    assert run(main())


def test_port_chain_replays_through_the_jax_executor():
    """The slice as a whole: the port network commits heights with txs;
    node 0's blocks, decoded by the JAX codec, are replayed through the
    JAX package's BlockExecutor (kvstore app, host verification of every
    last commit) from the same genesis, and each height's stored state
    bytes and app hash equal node 0's."""
    from cometbft_tpu.abci import types as JA
    from cometbft_tpu.abci.client import LocalClient as JLocal
    from cometbft_tpu.abci.kvstore import KVStoreApplication as JKV
    from cometbft_tpu.mempool.mempool import NopMempool as JNop
    from cometbft_tpu.sm.execution import BlockExecutor as JExecutor
    from cometbft_tpu.storage.blockstore import BlockStore as JBlockStore
    from cometbft_tpu.storage.db import MemDB as JMemDB
    from cometbft_tpu.storage.statestore import State as JState
    from cometbft_tpu.storage.statestore import StateStore as JStateStore
    from cometbft_tpu.types import codec as JC
    from cometbft_tpu.types.block_id import BlockID as JBlockID
    from cometbft_tpu.types.genesis import GenesisDoc as JGenesis
    from cometbft_tpu.types.genesis import GenesisValidator as JGenVal
    from cometbft_tpu.types.priv_validator import MockPV as JMockPV
    from cometbft_tpu_torch.mempool.clist_mempool import TxRejectedError
    from cometbft_tpu_torch.storage.statestore import K_STATE
    from cometbft_tpu_torch.types import codec as TC

    top = 4
    records = {}

    async def port_run():
        net = await make_inproc_network(4, chain_id="replay-net",
                                        device="cpu")
        node = net.nodes[0]
        save = node.state_store.save

        def recording_save(state):
            save(state)
            records[state.last_block_height] = (
                dict(node.state_store.db._data), state.app_hash)

        node.state_store.save = recording_save
        try:
            await net.start()
            # txs on every node, and a validator power change (node 3 to
            # 20) on node 0: the set changes two heights after its block
            pk3 = base64.b64encode(net.nodes[3].pv.get_pub_key().bytes())
            for i, n in enumerate(net.nodes):
                await n.mempool.check_tx(b"key%d=val%d" % (i, i))
                with pytest.raises(TxRejectedError):
                    await n.mempool.check_tx(b"malformed%d" % i)
            await net.nodes[0].mempool.check_tx(b"val:" + pk3 + b"!20")
            await net.wait_for_height(top, timeout=100)
        finally:
            await net.stop()
        _agree(net.nodes, top)
        return [(node.block_store.load_block(h),
                 node.block_store.load_block_parts(h, device="cpu"))
                for h in range(1, top + 1)]

    blocks = run(port_run())

    async def jax_replay():
        pvs = [JMockPV.from_secret(b"inproc%d" % i) for i in range(4)]
        doc = JGenesis(chain_id="replay-net", validators=[
            JGenVal(pv.get_pub_key(), 10) for pv in pvs])
        app = JKV()
        client = JLocal(app)
        await client.init_chain(JA.InitChainRequest(
            chain_id="replay-net", initial_height=1, time_ns=0,
            validators=[JA.ValidatorUpdate(v.pub_key.type(),
                                           v.pub_key.bytes(), v.power)
                        for v in doc.validators],
            app_state_bytes=doc.app_state))
        sdb = JMemDB()
        ex = JExecutor(JStateStore(sdb), JBlockStore(JMemDB()), client,
                       JNop(), backend="cpu")
        state = JState.from_genesis(doc)
        for h, (tblock, tparts) in enumerate(blocks, start=1):
            jblock = JC.unpack(TC.pack(tblock))
            assert jblock.hash() == tblock.hash()
            bid = JBlockID(jblock.hash(), JC.unpack(TC.pack(
                tparts.header())))
            state = await ex.apply_block(state, bid, jblock)
            tdb, tapp = records[h]
            assert state.app_hash == tapp
            assert sdb.get(K_STATE) == tdb[K_STATE], h
            assert dict(sdb._data) == tdb, h
        return state

    state = run(jax_replay())
    assert state.last_block_height == top
    txs = {bytes(t) for b, _ in blocks for t in b.data.txs}
    assert b"key0=val0" in txs and any(t.startswith(b"val:") for t in txs)
    assert sorted(v.voting_power for v in state.next_validators
                  .validators) == [10, 10, 10, 20]
