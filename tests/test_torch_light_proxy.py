"""The port's light client over RPC (``light/rpc_provider.py``) and its
verified proxy (``light/proxy.py``) against a port node on the CPU.

- ``light.Client`` over ``RPCProvider``s, sequential and skipping to the
  tip; the JAX package's client over its own ``RPCProvider`` against the
  same port server verifies the same heights and leaves the same keys
  and bytes in its trusted store.
- A provider falls back to ``commit`` + paged ``validators`` on a server
  without the ``light_block`` route, and retries a shed call.
- ``run_light_proxy`` answers ``status``, ``header``, ``commit``,
  ``validators``, ``block`` and ``abci_query`` verified; an absent key
  cannot be verified.
- A primary that serves a forged header is refused by the client, and a
  primary that serves a block other than the verified header's by the
  proxy.
"""

import asyncio
import copy
import threading

import pytest
import torch

from cometbft_tpu.light import Client as JClient
from cometbft_tpu.light import TrustOptions as JTrust
from cometbft_tpu.light.rpc_provider import RPCProvider as JProvider
from cometbft_tpu_torch.crypto import _ed25519_py as ref
from cometbft_tpu_torch.light import (SEQUENTIAL, SKIPPING, Client,
                                      LightClientError, RPCProvider,
                                      TrustOptions, run_light_proxy)
from cometbft_tpu_torch.rpc import HTTPClient, RPCError, RPCServer
from cometbft_tpu_torch.rpc import core as TCore

from torch_node_fixtures import genesis, make_node

torch.set_num_threads(1)

pytestmark = pytest.mark.timeout(300)

PERIOD = 3600 * 1_000_000_000
NS = 1_000_000_000
CHAIN = "lpx-net"


class OneNode:
    """One validator with RPC on a loop in a thread of its own."""

    def __init__(self):
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever,
                                       daemon=True)
        self.thread.start()

    def run(self, coro, timeout=240):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(
            timeout)

    async def start(self):
        doc, pvs = genesis(1, chain_id=CHAIN, tag=b"lpxnode")
        self.node = n = await make_node(doc, pvs[0], 0, "lp")
        n.config.rpc.laddr = "tcp://127.0.0.1:0"
        n.config.consensus.create_empty_blocks_interval = 1 * NS
        await n.start()
        cli = HTTPClient(*n.rpc_addr)
        for _ in range(60):
            try:
                res = await cli.call("broadcast_tx_commit",
                                     tx=b"pq=pv".hex())
                break
            except RPCError as e:       # the overload shed: retry
                if e.code != -32099:
                    raise
                await asyncio.sleep(0.5)
        await cli.close()
        self.tx_height = res["height"]
        await self.wait_height(max(8, self.tx_height + 2))

    async def wait_height(self, h, timeout=120):
        async def reach():
            while self.node.height() < h:
                await asyncio.sleep(0.05)
        await asyncio.wait_for(reach(), timeout)


@pytest.fixture(scope="module", autouse=True)
def no_host_verify():
    """Every check is a device lane: the host oracle raises, for the
    whole module (its node runs across the cases)."""
    def refuse(*a, **kw):
        raise AssertionError("host oracle called on the node path")

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref, "verify_zip215", refuse)
        yield


@pytest.fixture(scope="module")
def one():
    o = OneNode()
    try:
        o.run(o.start())
        yield o
    finally:
        try:
            o.run(o.node.stop())
        finally:
            o.loop.call_soon_threadsafe(o.loop.stop)
            o.thread.join(10)
            o.loop.close()


def _trust(one, h=2):
    return h, one.node.block_store.load_block(h).hash()


@pytest.mark.parametrize("mode", [SEQUENTIAL, SKIPPING])
def test_client_over_rpc_matches_jax(one, mode):
    h0, hash0 = _trust(one)
    addr = one.node.rpc_addr

    async def port():
        primary = RPCProvider(*addr, "primary")
        witness = RPCProvider(*addr, "witness")
        c = Client(CHAIN, TrustOptions(PERIOD, h0, hash0), primary,
                   witnesses=[witness], mode=mode, device="cpu")
        lb = await c.verify_light_block_at_height(6)
        tip = await c.update()
        assert primary._has_light_block is True
        return lb, tip, dict(c.store.db._data)

    async def jax():
        c = JClient(CHAIN, JTrust(PERIOD, h0, hash0),
                    JProvider(*addr, "primary"), mode=mode, backend="cpu")
        await c.verify_light_block_at_height(6)
        return dict(c.store.db._data)

    lb, tip, store = one.run(port())
    assert lb.header.hash() == one.node.block_store.load_block(6).hash()
    assert tip is not None and tip.height >= 6
    jstore = asyncio.run(jax())
    common = set(store) & set(jstore)
    assert common and all(store[k] == jstore[k] for k in common)
    assert {k for k in jstore if k in store} == common


def test_provider_classic_fallback_and_retry(one):
    calls = {"n": 0}

    async def shed_once(env, height=None):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RPCError(-32000, "server overloaded; retry later")
        return await TCore.commit(env, height)

    async def main():
        routes = {"commit": shed_once, "validators": TCore.validators}
        srv = RPCServer(one.node, routes=routes)
        addr = await srv.listen()
        try:
            p = RPCProvider(*addr, "classic", backoff_s=0.01)
            lb = await p.light_block(5)
            assert p._has_light_block is False and calls["n"] == 2
            want = one.node.block_store.load_block(5)
            assert lb.header.hash() == want.hash()
            assert lb.validators.hash() == want.header.validators_hash
        finally:
            await srv.close()

    one.run(main())


def test_proxy_serves_verified_routes(one):
    h0, hash0 = _trust(one, 1)
    addr = one.node.rpc_addr

    async def main():
        c = Client(CHAIN, TrustOptions(PERIOD, h0, hash0),
                   RPCProvider(*addr, "primary"), device="cpu")
        server, paddr = await run_light_proxy(c, HTTPClient(*addr))
        try:
            cli = HTTPClient(*paddr)
            st = await cli.call("status")
            assert st["node_info"]["network"] == CHAIN
            hd = await cli.call("header", height=4)
            assert hd["verified"] is True and hd["header"]["h"] == 4
            cm = await cli.call("commit", height=4)
            assert cm["commit"]["h"] == 4 and cm["verified"] is True
            vals = await cli.call("validators", height=4)
            assert vals["total"] == 1 and vals["verified"] is True
            blk = await cli.call("block", height=4)
            want = one.node.block_store.load_block(4).hash().hex()
            assert blk["block_id"]["hash"]["~b"] == want
            q = await cli.call("abci_query", path="/key", data=b"pq".hex())
            assert q["verified"] is True
            assert bytes.fromhex(q["response"]["value"]) == b"pv"
            with pytest.raises(RPCError):
                await cli.call("abci_query", path="/key", data=b"no".hex())
            await cli.close()
        finally:
            await server.close()

    one.run(main())


def test_lying_primaries_are_refused(one):
    h0, hash0 = _trust(one, 1)
    node = one.node

    async def forged_light_block(env, height=None):
        res = await TCore.light_block(env, height)
        res = copy.deepcopy(res)
        hdr = res["light_block"]["header"]
        hdr["ah"] = {"~b": "77" * 32}         # a forged app hash
        return res

    class LyingPrimary:
        """The primary's client, serving another height's block."""

        def __init__(self, real):
            self.real = real

        async def call(self, method, **params):
            if method == "block":
                params = dict(params, height=params["height"] - 1)
            return await self.real.call(method, **params)

    async def main():
        srv = RPCServer(node, routes={"light_block": forged_light_block})
        addr = await srv.listen()
        try:
            c = Client(CHAIN, TrustOptions(PERIOD, h0, hash0),
                       RPCProvider(*node.rpc_addr, "honest"), device="cpu")
            await c.initialize()
            c.primary = RPCProvider(*addr, "liar")
            with pytest.raises(LightClientError):
                await c.verify_light_block_at_height(5)
            assert c.store.get(5) is None
        finally:
            await srv.close()
        c = Client(CHAIN, TrustOptions(PERIOD, h0, hash0),
                   RPCProvider(*node.rpc_addr, "primary"), device="cpu")
        server, paddr = await run_light_proxy(
            c, LyingPrimary(HTTPClient(*node.rpc_addr)))
        try:
            cli = HTTPClient(*paddr)
            with pytest.raises(RPCError) as e:
                await cli.call("block", height=4)
            assert "does not match the verified header" in e.value.message
            await cli.close()
        finally:
            await server.close()

    one.run(main())
