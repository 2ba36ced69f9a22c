"""The port's statesync (``cometbft_tpu_torch/statesync``) against the
JAX package's, on the CPU over real loopback TCP: the case of
``tests/test_statesync.py`` in both directions.  A fresh port node
restores a snapshot that two JAX validators serve, its state provider's
light client (``device="cpu"``) walking their headers over the port's
RPC provider against the JAX RPC server; and a fresh JAX node and a
fresh port node restore a snapshot that a port validator serves, over
the other package's RPC server.  Each restore skips the chain below the
snapshot (``block_store.base() > 1``, no fallback to genesis), answers
the restored keys, and follows to a height whose block hash every node
agrees on.  The snapshot, manifest, chunk and offer messages cross
between the packages' reactors as bytes.  Helpers:
``tests/torch_node_fixtures.py``."""

import asyncio

import pytest
import torch

from cometbft_tpu.abci.kvstore import KVStoreApplication as JKV
from cometbft_tpu.config import NS as J_NS
from cometbft_tpu.config import Config as JConfig
from cometbft_tpu.config import test_consensus_config as j_tcc
from cometbft_tpu.light import Client as JClient
from cometbft_tpu.light import TrustOptions as JTrust
from cometbft_tpu.light.rpc_provider import RPCProvider as JRPCProvider
from cometbft_tpu.node import Node as JNode
from cometbft_tpu.p2p import NodeKey as JNodeKey
from cometbft_tpu.statesync import StateProvider as JStateProvider
from cometbft_tpu.types.genesis import GenesisDoc as JGenesis
from cometbft_tpu.types.genesis import GenesisValidator as JGenVal
from cometbft_tpu.types.priv_validator import MockPV as JMockPV
from cometbft_tpu_torch.config import NS
from cometbft_tpu_torch.light import Client, RPCProvider, TrustOptions
from cometbft_tpu_torch.statesync import StateProvider

from torch_node_fixtures import (config, genesis, make_node,  # noqa: F401
                                 no_host_verify, run)

torch.set_num_threads(1)

pytestmark = pytest.mark.timeout(150)

PERIOD = 3600 * NS


def _jax_config():
    cfg = JConfig(consensus=j_tcc())
    cfg.p2p.laddr = "tcp://127.0.0.1:0"
    cfg.p2p.pex = False
    cfg.rpc.laddr = "tcp://127.0.0.1:0"
    cfg.rpc.overload_shed_lag_s = 0
    cfg.base.signature_backend = "cpu"
    cfg.base.device_warmup = False
    cfg.instrumentation.loop_stall_threshold_s = 0
    cfg.instrumentation.watchdog_stall_threshold_s = 0
    cfg.statesync.discovery_time_s = 1.0
    return cfg


def _jax_genesis(n, chain_id, tag):
    pvs = [JMockPV.from_secret(tag + b"%d" % i) for i in range(n)]
    return JGenesis(chain_id=chain_id, validators=[
        JGenVal(pv.get_pub_key(), 10) for pv in pvs]), pvs


async def _reach(nodes, h, timeout):
    async def all_reached():
        while not all(n.height() >= h for n in nodes):
            await asyncio.sleep(0.05)

    await asyncio.wait_for(all_reached(), timeout)


async def _mesh(a, b):
    await a.dial_peer(b.listen_addr, persistent=True)


async def _query(node, key):
    return (await node.app_conns.query.query("/key", key, 0, False)).value


def _restored(fresh):
    assert fresh.statesync_error is None
    assert fresh.block_store.base() > 1, \
        "node replayed from genesis instead of state syncing"


def _agree(nodes, h):
    hashes = {n.block_store.load_block(h).hash() for n in nodes}
    assert len(hashes) == 1, f"fork at height {h}"


def test_port_node_restores_a_jax_validator_sets_snapshot():
    async def main():
        doc, _ = genesis(2, chain_id="ss-net", tag=b"ssj")
        jdoc, jpvs = _jax_genesis(2, "ss-net", b"ssj")
        jdoc.genesis_time_ns = doc.genesis_time_ns
        vals = [await JNode.create(jdoc, JKV(), priv_validator=pv,
                                   config=_jax_config(),
                                   node_key=JNodeKey.from_secret(b"sj%d" % i),
                                   name=f"sj{i}")
                for i, pv in enumerate(jpvs)]
        fresh = None
        try:
            for n in vals:
                await n.start()
            await _mesh(vals[0], vals[1])
            for i in range(4):
                await vals[0].mempool.check_tx(b"sk%d=sv%d" % (i, i))
            await _reach(vals, 8, 60)
            for n in vals:       # one height every 2 s from here on
                n.consensus.cfg.create_empty_blocks_interval = 2 * J_NS
            trust_hash = vals[0].block_store.load_block(2).hash()
            light = Client("ss-net", TrustOptions(PERIOD, 2, trust_hash),
                           RPCProvider(*vals[0].rpc_addr), device="cpu")
            cfg = config()
            cfg.statesync.discovery_time_s = 1.0
            fresh = await make_node(doc, None, 9, "sp", config_=cfg,
                                    state_sync_provider=StateProvider(
                                        light, doc))
            await fresh.start()
            for v in vals:
                await _mesh(fresh, v)
            await asyncio.wait_for(fresh.statesync_done, 90)
            _restored(fresh)
            assert fresh.syncer.tallies["chunks_verified"] >= 1
            target = max(v.height() for v in vals) + 1
            await _reach([fresh], target, 60)
            _agree(vals + [fresh], target)
            return await _query(fresh, b"sk0"), await _query(fresh, b"sk3")
        finally:
            for n in ([fresh] if fresh else []) + vals:
                await n.stop()

    assert run(main()) == (b"sv0", b"sv3")


def test_jax_and_port_nodes_restore_a_port_validators_snapshot():
    async def main():
        doc, pvs = genesis(1, chain_id="ss-port", tag=b"ssp")
        jdoc, _ = _jax_genesis(1, "ss-port", b"ssp")
        jdoc.genesis_time_ns = doc.genesis_time_ns
        cfg = config()
        cfg.rpc.laddr = "tcp://127.0.0.1:0"
        val = await make_node(doc, pvs[0], 0, "pv", config_=cfg)
        fresh = []
        try:
            await val.start()
            for i in range(3):
                await val.mempool.check_tx(b"pk%d=pv%d" % (i, i))
            await _reach([val], 6, 90)
            val.consensus.cfg.create_empty_blocks_interval = 3 * NS
            trust_hash = val.block_store.load_block(2).hash()
            host, port = val.rpc_addr
            jlight = JClient("ss-port", JTrust(PERIOD, 2, trust_hash),
                             JRPCProvider(host, port), backend="cpu")
            jnode = await JNode.create(
                jdoc, JKV(), config=_jax_config(),
                node_key=JNodeKey.from_secret(b"jfresh"),
                state_sync_provider=JStateProvider(jlight, jdoc),
                name="jfresh")
            fresh.append(jnode)
            tlight = Client("ss-port", TrustOptions(PERIOD, 2, trust_hash),
                            RPCProvider(host, port), device="cpu")
            tcfg = config()
            tcfg.statesync.discovery_time_s = 1.0
            tnode = await make_node(doc, None, 8, "tf", config_=tcfg,
                                    state_sync_provider=StateProvider(
                                        tlight, doc))
            fresh.append(tnode)
            for n in fresh:
                await n.start()
                await _mesh(n, val)
            await asyncio.wait_for(asyncio.gather(
                *(n.statesync_done for n in fresh)), 100)
            for n in fresh:
                _restored(n)
            target = val.height() + 1
            await _reach(fresh, target, 60)
            _agree([val] + fresh, target)
            return [(await _query(n, b"pk0"), await _query(n, b"pk2"))
                    for n in fresh]
        finally:
            for n in fresh + [val]:
                await n.stop()

    assert run(main()) == [(b"pv0", b"pv2")] * 2
