"""The port's networked node (``cometbft_tpu_torch/node``) on the CPU:
the cases of ``tests/test_node_network.py`` with port ``Node``s on
``device="cpu"`` over real loopback TCP (secret connections,
MConnections, the consensus, mempool and evidence reactors), 4
validators to height 4: txs injected on one node reach the proposers by
mempool gossip and every node stores the same blocks; vote extensions
travel over TCP into the stored extended commits.  Every check is a
device lane (the plain versions): handshakes through the transport,
votes, proposals and evidence through the shared scheduler; the host
oracle is patched to raise.  Also: a node with no card and no
``device="cpu"`` raises, and a node stopped closes everything."""

import pytest
import torch

from cometbft_tpu_torch.abci.kvstore import KVStoreApplication
from cometbft_tpu_torch.config import Config
from cometbft_tpu_torch.crypto import scheduler as vsched
from cometbft_tpu_torch.node import Node
from cometbft_tpu_torch.p2p import secret_connection as psc

from torch_node_fixtures import (agree, genesis, make_node,  # noqa: F401
                                 no_host_verify, run, start_meshed,
                                 stop_all, wait_height)

torch.set_num_threads(1)

pytestmark = pytest.mark.timeout(120)


def test_four_nodes_commit_over_tcp():
    async def main():
        doc, pvs = genesis(4)
        nodes = [await make_node(doc, pv, i, "tn") for i, pv in
                 enumerate(pvs)]
        checks0 = psc.HANDSHAKE_CHECKS["cpu"]
        try:
            await start_meshed(nodes)
            sched = vsched.get_scheduler()
            assert sched is not None and sched.device == "cpu"
            assert psc.HANDSHAKE_CHECKS["cpu"] - checks0 == 12
            for i in range(4):
                await nodes[0].mempool.check_tx(b"gk%d=gv%d" % (i, i))
            await wait_height(nodes, 4)
            agree(nodes, 4)
            committed = {bytes(tx) for h in range(1, nodes[1].height() + 1)
                         for tx in nodes[1].block_store.load_block(h)
                         .data.txs}
            want = {b"gk%d=gv%d" % (i, i) for i in range(4)}
            if not want <= committed:
                await wait_height(nodes, nodes[1].height() + 2)
                committed = {bytes(tx) for h in range(
                    1, nodes[1].height() + 1) for tx in
                    nodes[1].block_store.load_block(h).data.txs}
            assert want <= committed, want - committed
            stats = sched.stats()
            # own votes miss the cache (one lane each), proposals are
            # fresh lanes, peers' votes are cache hits
            assert stats["single_checks"].get("sync", 0) > 0
            assert stats["single_checks"].get("uncached", 0) > 0
            assert stats["cache_hits"] > 0 and stats["lanes_bad"] == 0
            sent = sum(p.mconn.send_monitor.total
                       for p in nodes[0].switch.peers.values())
            assert sent > 0
        finally:
            await stop_all(nodes)
        for n in nodes:
            assert n.switch.n_peers() == 0
            assert n.transport._server is None

    run(main())


def test_vote_extensions_over_tcp():
    async def main():
        doc, pvs = genesis(4, chain_id="ext-net", tag=b"ext", ext_height=1)
        nodes = [await make_node(doc, pv, i, "te") for i, pv in
                 enumerate(pvs)]
        try:
            await start_meshed(nodes)
            await wait_height(nodes, 4)
            agree(nodes, 4)
            for n in nodes:
                ext = n.block_store.load_block_extended_commit(3)
                if ext is None:
                    continue
                assert ext.ensure_extensions(True)
                n_ext = sum(1 for e in ext.extended_signatures
                            if e.commit_sig.is_commit()
                            and e.extension_signature)
                assert n_ext >= 3, "extensions missing over TCP"
                break
            else:
                raise AssertionError("no node stored an extended commit")
        finally:
            await stop_all(nodes)

    run(main())


def test_node_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    doc, pvs = genesis(1)
    cfg = Config()
    assert cfg.base.device == "cuda"

    async def main():
        with pytest.raises(RuntimeError):
            await Node.create(doc, KVStoreApplication(device="cpu"),
                              priv_validator=pvs[0], config=cfg)
        with pytest.raises(ValueError):
            await Node.create(doc, None, priv_validator=pvs[0])

    run(main())


def test_home_lock_released_on_stop_and_refused_while_held(tmp_path):
    """A node holds its home's data-directory lock until stop; a second
    node on the same home is refused and leaves nothing open."""
    async def main():
        doc, pvs = genesis(1, tag=b"lock")
        home = str(tmp_path / "h")
        a = await make_node(doc, pvs[0], 0, "lk", home=home)
        with pytest.raises(RuntimeError):
            await make_node(doc, pvs[0], 1, "lk", home=home)
        await a.start()
        await wait_height([a], 1, timeout=60)
        await a.stop()
        await a.stop()                         # idempotent
        b = await make_node(doc, pvs[0], 0, "lk", home=home)
        assert b.height() >= 1                 # the LogDB stores reopened
        await b.stop()

    run(main())
