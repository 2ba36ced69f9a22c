"""The port's networked node against the JAX package's, on the CPU over
real loopback TCP: the slice held against the JAX package as a whole.
Two port nodes on ``device="cpu"`` and two JAX nodes
(``backend="cpu"``), each package's secret connections, MConnections,
reactors and messages talking to the other's, gossip txs, commit to
height 3 and store equal block hashes.  Helpers and timing notes:
``tests/torch_node_fixtures.py``."""

import asyncio

import pytest
import torch

from cometbft_tpu.abci.kvstore import KVStoreApplication as JKV
from cometbft_tpu.config import Config as JConfig
from cometbft_tpu.config import test_consensus_config as j_tcc
from cometbft_tpu.node import Node as JNode
from cometbft_tpu.p2p import NodeKey as JNodeKey
from cometbft_tpu.types.genesis import GenesisDoc as JGenesis
from cometbft_tpu.types.genesis import GenesisValidator as JGenVal
from cometbft_tpu.types.priv_validator import MockPV as JMockPV

from torch_node_fixtures import (agree, cpu_consensus_config,  # noqa: F401
                                 genesis, make_node, mesh, no_host_verify,
                                 run, stop_all, wait_height)

torch.set_num_threads(1)

pytestmark = pytest.mark.timeout(120)


def _jax_config():
    cfg = JConfig(consensus=j_tcc())
    port_cc = cpu_consensus_config()
    for name in ("timeout_propose", "timeout_prevote", "timeout_precommit"):
        setattr(cfg.consensus, name, getattr(port_cc, name))
    cfg.p2p.laddr = "tcp://127.0.0.1:0"
    cfg.p2p.pex = False
    cfg.rpc.laddr = ""
    cfg.rpc.overload_shed_lag_s = 0
    cfg.base.signature_backend = "cpu"
    cfg.base.device_warmup = False
    cfg.instrumentation.loop_stall_threshold_s = 0
    cfg.instrumentation.watchdog_stall_threshold_s = 0
    return cfg


def test_mixed_port_and_jax_network_commits():
    async def main():
        doc, pvs = genesis(4, chain_id="mixed-net", tag=b"mixed")
        jpvs = [JMockPV.from_secret(b"mixed%d" % i) for i in range(4)]
        jdoc = JGenesis(chain_id="mixed-net", validators=[
            JGenVal(pv.get_pub_key(), 10) for pv in jpvs])
        assert [v.pub_key.bytes() for v in jdoc.validators] == \
            [v.pub_key.bytes() for v in doc.validators]
        nodes = [await make_node(doc, pvs[i], i, "mx") for i in (0, 1)]
        for i in (2, 3):
            nodes.append(await JNode.create(
                jdoc, JKV(), priv_validator=jpvs[i], config=_jax_config(),
                node_key=JNodeKey.from_secret(b"mx%d" % i), name=f"jx{i}"))
        try:
            for n in nodes:
                await n.start()
            await mesh(nodes)
            for _ in range(200):           # the accept side lands async
                if all(n.switch.n_peers() == 3 for n in nodes):
                    break
                await asyncio.sleep(0.05)
            assert [n.switch.n_peers() for n in nodes] == [3] * 4
            await nodes[0].mempool.check_tx(b"port=tx")
            await nodes[2].mempool.check_tx(b"jax=tx")
            await wait_height(nodes, 3)
            agree(nodes, 3)
            for h in range(1, 4):
                a = nodes[0].block_store.load_block(h)
                b = nodes[3].block_store.load_block(h)
                assert a.hash() == b.hash()
                assert nodes[1].block_store.load_block_commit(h) \
                    is not None or h == nodes[1].height()
        finally:
            await stop_all(nodes)

    run(main())
