"""The port's inspect mode (``cometbft_tpu_torch/rpc/inspect.py``)
against the JAX package's, on the CPU: the inspect case of
``tests/test_inspect_armor_proofops.py``.  A port validator with a home
and an RPC server commits a tx and is stopped; inspect mode over its
home serves ``block``, ``validators``, ``tx`` and ``genesis`` as the
live node served them, and each package's inspect server over copies of
the same home (the port's, and one a JAX node wrote) answers every read
route with the same JSON, the doctor's report-only pass included; the
live-only routes answer with an error."""

import asyncio
import shutil

import pytest
import torch

from cometbft_tpu.config import Config as JConfig
from cometbft_tpu.rpc import HTTPClient as JClient
from cometbft_tpu.rpc.inspect import run_inspect as j_run_inspect
from cometbft_tpu_torch.config import Config as TConfig
from cometbft_tpu_torch.rpc import HTTPClient, RPCError
from cometbft_tpu_torch.rpc.inspect import run_inspect as t_run_inspect

from torch_node_fixtures import (genesis, make_node,  # noqa: F401
                                 no_host_verify, run)

pytestmark = pytest.mark.timeout(150)

torch.set_num_threads(1)

READS = ("status", "block", "validators", "genesis", "blockchain",
         "commit", "block_results", "consensus_params", "dump_incidents")


async def _inspect_reads(run_inspect, cfg, home, doc, height, txh):
    server, addr = await run_inspect(home, cfg, doc)
    try:
        cli = HTTPClient(*addr)
        out = {}
        for route in READS:
            kw = {"height": height} if route in (
                "block", "commit", "block_results", "validators") else {}
            out[route] = await cli.call(route, **kw)
        # the home's own path aside (each package reads its own copy)
        out["dump_incidents"]["incident_dir"] = \
            out["dump_incidents"]["incident_dir"].replace(home, "<home>")
        out["tx"] = await cli.call("tx", hash=txh)
        out["live_only"] = []
        for route, kw in (("broadcast_tx_sync", {"tx": b"zz".hex()}),
                          ("num_unconfirmed_txs", {}),
                          ("consensus_state", {})):
            try:
                await cli.call(route, **kw)
                out["live_only"].append(None)
            except RPCError as e:
                out["live_only"].append(e.code)
        return out
    finally:
        await server.close()
        server.env.node.block_store.db.close()
        server.env.node.state_store.db.close()
        for ix in (server.env.node.tx_indexer,
                   server.env.node.block_indexer):
            if ix is not None:
                ix.db.close()


def _jax_doc(doc):
    from cometbft_tpu.types.genesis import GenesisDoc, GenesisValidator
    from cometbft_tpu.types.priv_validator import MockPV

    pvs = [MockPV.from_secret(b"ins%d" % i) for i in range(1)]
    jdoc = GenesisDoc(chain_id=doc.chain_id, validators=[
        GenesisValidator(pv.get_pub_key(), 10) for pv in pvs])
    jdoc.genesis_time_ns = doc.genesis_time_ns
    return jdoc, pvs


def test_inspect_serves_port_home_as_live_node_did(tmp_path):
    async def main():
        doc, pvs = genesis(1, chain_id="ins-net", tag=b"ins")
        home = str(tmp_path / "n0")
        node = await make_node(doc, pvs[0], 0, "ins", home=home)
        node.config.rpc.laddr = "tcp://127.0.0.1:0"
        try:
            await node.start()
            cli = HTTPClient(*node.rpc_addr)
            res = await cli.call("broadcast_tx_commit", tx=b"ik=iv".hex())
            h, txh = res["height"], res["hash"]
            while node.height() < h + 1:
                await asyncio.sleep(0.05)
            live = {r: await cli.call(r, height=h) for r in (
                "block", "validators", "commit")}
            live["tx"] = await cli.call("tx", hash=txh)
            live["genesis"] = await cli.call("genesis")
        finally:
            await node.stop()
        cfg = TConfig()
        tview = await _inspect_reads(t_run_inspect, cfg, home, doc, h, txh)
        jhome = str(tmp_path / "jcopy")
        shutil.copytree(home, jhome)
        jdoc, _ = _jax_doc(doc)
        jview = await _inspect_reads(j_run_inspect, JConfig(), jhome,
                                     jdoc, h, txh)
        return live, tview, jview, h

    live, tview, jview, h = run(main())
    for route in ("block", "validators", "commit", "tx", "genesis"):
        assert tview[route] == live[route], route
    assert tview == jview
    st = tview["status"]
    assert st["sync_info"]["latest_block_height"] >= h
    assert st["doctor"] is not None and st["doctor"]["ok"]
    assert st["doctor"]["heights"]["blockstore"] >= h
    assert tview["live_only"] == [-32603] * 3


def test_inspect_over_a_jax_home_matches_jax(tmp_path):
    """A home a JAX validator wrote, read by both packages' inspect."""
    from cometbft_tpu.abci.kvstore import KVStoreApplication as JKV
    from cometbft_tpu.config import test_consensus_config as j_tcc
    from cometbft_tpu.node import Node as JNode
    from cometbft_tpu.p2p import NodeKey as JNodeKey

    async def main():
        doc, _ = genesis(1, chain_id="ins-net", tag=b"ins")
        jdoc, jpvs = _jax_doc(doc)
        home = str(tmp_path / "j0")
        cfg = JConfig(consensus=j_tcc())
        cfg.p2p.laddr = "tcp://127.0.0.1:0"
        cfg.p2p.pex = False
        cfg.rpc.laddr = "tcp://127.0.0.1:0"
        cfg.base.signature_backend = "cpu"
        cfg.base.device_warmup = False
        node = await JNode.create(jdoc, JKV(), priv_validator=jpvs[0],
                                  config=cfg,
                                  node_key=JNodeKey.from_secret(b"jk"),
                                  home=home, name="jins")
        await node.start()
        try:
            res = await JClient(*node.rpc_addr).call(
                "broadcast_tx_commit", tx=b"jk=jv".hex())
            h, txh = res["height"], res["hash"]
            while node.height() < h + 2:
                await asyncio.sleep(0.02)
        finally:
            await node.stop()
        thome = str(tmp_path / "tcopy")
        shutil.copytree(home, thome)
        jview = await _inspect_reads(j_run_inspect, JConfig(), home, jdoc,
                                     h, txh)
        tview = await _inspect_reads(t_run_inspect, TConfig(), thome, doc,
                                     h, txh)
        return jview, tview

    jview, tview = run(main())
    assert tview == jview
    assert tview["status"]["doctor"]["ok"]
