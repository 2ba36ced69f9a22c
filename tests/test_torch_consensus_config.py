"""The port's consensus in one process on the CPU, continued from
``tests/test_torch_consensus.py``: WAL crash recovery, proposer-based
timestamps, ``create_empty_blocks = false`` and ``skip_timeout_commit``
(``tests/test_consensus.py``'s cases on the port's harness with
``device="cpu"``).

A height of 4 validators takes several seconds here (the kernels' plain
versions check 12 lanes a height, about 0.4 s each), so the timing
cases keep the JAX package's assertions at this speed: the windows in
which a parked chain must not advance span several heights' worth of
time (15 s, not 1 s), and ``skip_timeout_commit`` is shown under a
ten-minute ``timeout_commit`` (not 2 s), which only skipping can pass."""

import asyncio

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
    def refuse(*a, **kw):
        raise AssertionError("host oracle called on the consensus path")

    monkeypatch.setattr(ref, "verify_zip215", refuse)
    vsched.set_scheduler(None)
    yield
    vsched.set_scheduler(None)


def _tcc():
    from cometbft_tpu_torch import config

    return config.test_consensus_config()


def test_wal_crash_recovery(tmp_path):
    """Stop a node, isolate it while the others pass its height, restart
    it from its WAL and stores: it rejoins and all agree."""

    async def main():
        from cometbft_tpu_torch.consensus.state import ConsensusState
        from cometbft_tpu_torch.consensus.wal import WAL

        net = await make_inproc_network(4, wal_dir=str(tmp_path),
                                        device="cpu")
        try:
            await net.start()
            await net.wait_for_height(2, timeout=60)
            victim = net.nodes[0]
            await victim.consensus.stop()
            net.isolate("node0")
            await net.wait_for_height(victim.block_store.height() + 1,
                                      timeout=40, nodes=net.nodes[1:])
            state = victim.state_store.load()
            cs2 = ConsensusState(
                _tcc(), state, victim.consensus.block_exec,
                victim.block_store, wal=WAL(victim.wal_path),
                priv_validator=victim.pv, event_bus=victim.event_bus,
                name="node0r")
            victim.consensus = cs2
            net._wire(victim)
            net.heal("node0")
            await cs2.start()
            target = max(n.block_store.height() for n in net.nodes) + 2
            await net.wait_for_height(target, timeout=70)
            hashes = {n.block_store.load_block(target).hash()
                      for n in net.nodes}
            assert len(hashes) == 1
        finally:
            await net.stop()
        return True

    assert run(main())


def test_pbts_enabled_network_commits():
    async def main():
        net = await make_inproc_network(4, pbts_height=1, device="cpu")
        try:
            await net.start()
            await net.wait_for_height(4, timeout=110)
            blocks = [net.nodes[0].block_store.load_block(h)
                      for h in range(1, 5)]
            for a, b in zip(blocks, blocks[1:]):
                assert b.header.time_ns > a.header.time_ns
        finally:
            await net.stop()
        return True

    assert run(main())


def test_create_empty_blocks_disabled_waits_for_txs():
    """After the proof block the chain parks until a tx arrives, commits
    a block with it (and the follow-up proof block for the new app
    hash), then parks again."""

    async def main():
        cfg = _tcc()
        cfg.create_empty_blocks = False
        net = await make_inproc_network(4, config=cfg, device="cpu")
        try:
            await net.start()
            await net.wait_for_height(1, timeout=30)
            h0 = max(n.block_store.height() for n in net.nodes)
            await asyncio.sleep(15.0)          # several heights' worth
            h1 = max(n.block_store.height() for n in net.nodes)
            assert h1 - h0 <= 1, f"empty blocks kept flowing: {h0}->{h1}"
            for n in net.nodes:
                await n.mempool.check_tx(b"wake=up")
            await net.wait_for_height(h1 + 1, timeout=30)
            found = None
            for h in range(h0, net.nodes[0].block_store.height() + 1):
                blk = net.nodes[0].block_store.load_block(h)
                if blk is not None and b"wake=up" in blk.data.txs:
                    found = h
            assert found, "tx never committed"
            await asyncio.sleep(8.0)           # the proof block
            h2 = max(n.block_store.height() for n in net.nodes)
            await asyncio.sleep(15.0)
            h3 = max(n.block_store.height() for n in net.nodes)
            assert h3 - h2 <= 1, f"chain did not re-park: {h2}->{h3}"
        finally:
            await net.stop()
        return True

    assert run(main())


def test_skip_timeout_commit_fast_heights():
    """With every precommit in hand the next height starts at once: under
    a ten-minute ``timeout_commit`` heights 2 and 3 can only come by
    skipping it.  The genesis wait of one ``timeout_commit`` is not
    skippable by design, so the nodes' first start time is set to now
    before they start."""

    async def main():
        cfg = _tcc()
        cfg.timeout_commit = 600_000_000_000       # 10 min: would dominate
        cfg.skip_timeout_commit = True
        net = await make_inproc_network(4, config=cfg, device="cpu")
        try:
            for n in net.nodes:
                n.consensus.rs.start_time_ns = n.consensus.now_ns()
            await net.start()
            await net.wait_for_height(3, timeout=100)
            assert len({n.block_store.load_block(3).hash()
                        for n in net.nodes}) == 1
        finally:
            await net.stop()
        return True

    assert run(main())
