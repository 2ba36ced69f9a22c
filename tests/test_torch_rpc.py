"""The port's RPC surface (``cometbft_tpu_torch/rpc``) on the CPU.

One port node set serves the module (a validator and a follower, each
with an RPC server on its own loopback port, ``device="cpu"``), on an
event loop in a thread of its own; the cases drive it over HTTP (JSON-RPC
bodies, URI GETs, batches), over WebSockets, and with the JAX package's
clients.  The chain's stores are copied into the JAX package's stores
(the codecs are byte for byte the same), so that the JAX routes' JSON of
``block``, ``commit``, ``validators``, ``header`` and ``blockchain`` can
be held against the port's over the same chain; the port's clients talk
to a JAX server over that copy.  ``openapi_spec()`` equals the JAX
server's over the ported routes.  CORS, TLS and the admission gate's
503 run on servers of their own over a stub node.  The host oracle is
patched to raise: every signature check is a device lane (the plain
versions here)."""

import asyncio
import json
import shutil
import subprocess
import threading
from types import SimpleNamespace

import pytest
import torch

from cometbft_tpu.libs.pubsub import EventBus as JBus
from cometbft_tpu.rpc import HTTPClient as JHTTP
from cometbft_tpu.rpc import RPCServer as JServer
from cometbft_tpu.rpc import WSClient as JWS
from cometbft_tpu.rpc import core as JCore
from cometbft_tpu.storage import BlockStore as JBlockStore
from cometbft_tpu.storage import MemDB as JMemDB
from cometbft_tpu.storage import StateStore as JStateStore
from cometbft_tpu_torch.config import Config
from cometbft_tpu_torch.crypto import _ed25519_py as ref
from cometbft_tpu_torch.crypto.merkle import Proof, ProofOp, ProofOperators
from cometbft_tpu_torch.libs import metrics as tmetrics
from cometbft_tpu_torch.rpc import HTTPClient, RPCError, RPCServer, WSClient
from cometbft_tpu_torch.rpc import core as TCore
from cometbft_tpu_torch.types.header import tx_hash

from torch_node_fixtures import genesis, make_node

torch.set_num_threads(1)

pytestmark = pytest.mark.timeout(300)

TXS = [b"rk%d=rv%d" % (i, i) for i in range(3)]
NS = 1_000_000_000


async def submit(cli, method, **params):
    """A tx route called as a client would: the overload shed (-32099,
    the loop's lag past ``rpc.overload_shed_lag_s``; here a height's
    checks hold the loop for seconds) is retried after a pause."""
    for _ in range(60):
        try:
            return await cli.call(method, **params)
        except RPCError as e:
            if e.code != -32099:
                raise
            await asyncio.sleep(0.5)
    raise AssertionError(f"{method} shed 60 times")


class NodeSet:
    """A validator and a follower with RPC, on a loop in a thread."""

    def __init__(self):
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever,
                                       daemon=True)
        self.thread.start()

    def run(self, coro, timeout=240):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(
            timeout)

    async def start(self):
        doc, pvs = genesis(1, chain_id="rpc-net", tag=b"rpcnode")
        self.doc = doc
        self.nodes = []
        for i, pv in enumerate((pvs[0], None)):
            n = await make_node(doc, pv, i, "rp")
            n.config.rpc.laddr = "tcp://127.0.0.1:0"
            # a height's checks hold the shared loop for about 1.5 s
            # here: between heights the servers answer without waiting
            n.config.consensus.create_empty_blocks_interval = 3 * NS
            self.nodes.append(n)
        for n in self.nodes:
            await n.start(consensus=False)
        await self.nodes[1].dial_peer(self.nodes[0].listen_addr)
        for n in self.nodes:
            await n.start_consensus()
        cli = HTTPClient(*self.nodes[0].rpc_addr)
        self.committed = {}
        for tx in TXS:
            res = await submit(cli, "broadcast_tx_commit", tx=tx.hex())
            assert res["tx_result"]["code"] == 0, res
            self.committed[tx] = res["height"]
        await cli.close()
        await self.wait_height(max(self.committed.values()) + 2)

    async def wait_height(self, h, timeout=120):
        async def reach():
            while not all(n.height() >= h for n in self.nodes):
                await asyncio.sleep(0.05)
        await asyncio.wait_for(reach(), timeout)

    async def jax_copy(self):
        """The validator's stores as the JAX package's stores (copied on
        the loop's thread, where they are written)."""
        n = self.nodes[0]
        bdb, sdb = JMemDB(), JMemDB()
        bdb._data.update(n.block_store.db._data)
        sdb._data.update(n.state_store.db._data)
        return JBlockStore(bdb), JStateStore(sdb), n.height()

    async def stop(self):
        for n in self.nodes:
            await n.stop()


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
def net():
    ns = NodeSet()
    try:
        ns.run(ns.start())
        jbs, jss, top = ns.run(ns.jax_copy())
        ns.jax = SimpleNamespace(block_store=jbs, state_store=jss, top=top)
        yield ns
    finally:
        try:
            ns.run(ns.stop())
        finally:
            ns.loop.call_soon_threadsafe(ns.loop.stop)
            ns.thread.join(10)
            ns.loop.close()


async def _raw(host, port, req: bytes, ssl_ctx=None) -> bytes:
    reader, writer = await asyncio.open_connection(host, port, ssl=ssl_ctx)
    writer.write(req)
    await writer.drain()
    data = await asyncio.wait_for(reader.read(-1), 20)
    writer.close()
    return data


def _body(raw: bytes):
    head, _, body = raw.partition(b"\r\n\r\n")
    return head.decode(), (json.loads(body) if body else None)


# ------------------------------------------------------------ HTTP routes

def test_routes_over_http(net):
    async def main():
        v, f = net.nodes
        cli = HTTPClient(*v.rpc_addr)
        h = net.committed[TXS[0]]
        assert await cli.call("health") == {}
        st = await cli.call("status")
        assert st["node_info"]["network"] == "rpc-net"
        assert st["sync_info"]["latest_block_height"] >= h
        assert st["doctor"]["ok"] and st["doctor"]["refused"] is None
        assert st["compile_bundle"] == {"status": "skipped_no_device"}
        assert st["light_serve"]["anchors_ok"] >= 0
        ni = await cli.call("net_info")
        assert ni["n_peers"] == 1 and ni["peers"][0]["quality"] is not None
        blk = await cli.call("block", height=h)
        assert {"~b": TXS[0].hex()} in blk["block"]["data"]["txs"]
        bh = blk["block_id"]["hash"]["~b"]
        assert (await cli.call("block_by_hash", hash=bh))["block"] == \
            blk["block"]
        assert (await cli.call("header_by_hash", hash=bh))["header"] == \
            blk["block"]["hdr"]
        br = await cli.call("block_results", height=h)
        assert br["height"] == h and br["tx_results"][0]["code"] == 0
        assert (await cli.call("validators"))["total"] == 1
        cp = await cli.call("consensus_params", height=h)
        assert cp["consensus_params"]["validator"]["pub_key_types"]
        cs = await cli.call("dump_consensus_state")
        assert cs["round_state"]["height"] >= h
        assert (await cli.call("num_unconfirmed_txs"))["n_txs"] >= 0
        assert (await cli.call("unconfirmed_txs"))["n_txs"] >= 0
        assert (await cli.call("check_tx", tx=b"ck=cv".hex()))["code"] == 0
        sync = await submit(cli, "broadcast_tx_sync", tx=b"sk=sv".hex())
        assert sync["code"] == 0
        asy = await submit(cli, "broadcast_tx_async", tx=b"ak=av".hex())
        assert asy["code"] == 0
        info = await cli.call("abci_info")
        assert info["response"]["last_block_height"] >= h
        gen = await cli.call("genesis")
        assert gen["genesis"]["chain_id"] == "rpc-net"
        ch = await cli.call("genesis_chunked", chunk=0)
        assert json.loads(__import__("base64").b64decode(ch["data"])) == \
            gen["genesis"]
        assert (await cli.call("retain_heights"))["store_base"] == 1
        assert (await cli.call("dump_trace"))["enabled"] is False
        with pytest.raises(RPCError) as e:
            await cli.call("no_such_route")
        assert e.value.code == -32601
        with pytest.raises(RPCError) as e:
            await cli.call("block", height=10 ** 6)
        assert e.value.code == -32603
        with pytest.raises(RPCError) as e:
            await cli.call("tx_search", query="tx.height >")
        assert e.value.code == -32602
        # the follower serves the same chain
        fcli = HTTPClient(*f.rpc_addr)
        assert (await fcli.call("block", height=h))["block"] == blk["block"]
        await fcli.close()
        await cli.close()

    net.run(main())


def test_indexed_txs_proofs_and_query_proofs(net):
    async def main():
        v = net.nodes[0]
        cli = HTTPClient(*v.rpc_addr)
        for tx, h in net.committed.items():
            key = tx.split(b"=")[0]
            res = await cli.call("tx", hash=tx_hash(tx).hex(), prove=True)
            assert res["height"] == h and bytes.fromhex(res["tx"]) == tx
            pf = res["proof"]["proof"]
            proof = Proof(pf["total"], pf["index"],
                          bytes.fromhex(pf["leaf_hash"]),
                          tuple(bytes.fromhex(a) for a in pf["aunts"]))
            header = v.block_store.load_block(h).header
            assert res["proof"]["root_hash"] == header.data_hash.hex()
            assert proof.verify(header.data_hash, tx_hash(tx))
            found = await cli.call("tx_search",
                                   query=f"app.key='{key.decode()}'")
            assert [t["hash"] for t in found["txs"]] == [res["hash"]]
            q = await cli.call("abci_query", data=key.hex(), prove=True)
            r = q["response"]
            assert bytes.fromhex(r["value"]) == tx.split(b"=")[1]
            await net.wait_height(r["height"] + 1)
            nxt = v.block_store.load_block(r["height"] + 1).header
            ops = ProofOperators.decode(
                [ProofOp(o["type"], bytes.fromhex(o["key"]),
                         bytes.fromhex(o["data"])) for o in r["proof_ops"]])
            ops.verify(nxt.app_hash, [key], bytes.fromhex(r["value"]))
        page = await cli.call("tx_search", query="tx.height >= 1",
                              per_page=2, order_by="desc")
        assert page["total_count"] >= len(TXS) and len(page["txs"]) == 2
        hs = sorted(net.committed.values())
        bs = await cli.call("block_search",
                            query=f"block.height >= {hs[0]}", per_page=100)
        assert hs[0] in bs["heights"] and bs["total_count"] >= 1
        await cli.close()

    net.run(main())


def test_light_routes(net):
    async def main():
        v = net.nodes[0]
        cli = HTTPClient(*v.rpc_addr)
        h = net.committed[TXS[1]]
        lb = await cli.call("light_block", height=h)
        assert lb["light_block"]["header"]["h"] == h
        many = await cli.call("light_blocks", heights=[1, h, 10 ** 6])
        assert "error" in many["light_blocks"][2]
        pr = await cli.call("light_proofs", height=h, kind="tx")
        header = v.block_store.load_block(h).header
        assert pr["root"] == header.data_hash.hex()
        vp = await cli.call("light_proofs", height=h, kind="validator")
        assert vp["root"] == header.validators_hash.hex()
        anchors = [{"height": x, "commit": (await cli.call(
            "commit", height=x))["commit"]} for x in (1, h)]
        first = await cli.call("light_verify", anchors=anchors)
        assert first["ok"] == 2 and first["failed"] == 0
        again = await cli.call("light_verify", anchors=anchors)
        assert [r["cached"] for r in again["results"]] == [True, True]
        await cli.close()

    net.run(main())


def test_uri_batch_head_and_route_list(net):
    async def main():
        host, port = net.nodes[0].rpc_addr
        h = net.committed[TXS[0]]
        head, body = _body(await _raw(host, port, (
            f"GET /block?height={h} HTTP/1.1\r\nHost: x\r\n"
            "Connection: close\r\n\r\n").encode()))
        assert "200 OK" in head and body["id"] == -1
        assert body["result"]["block"]["hdr"]["h"] == h
        head, body = _body(await _raw(host, port, (
            "GET / HTTP/1.1\r\nHost: x\r\nConnection: close\r\n\r\n"
        ).encode()))
        assert body["result"]["routes"] == sorted(TCore.ROUTES)
        head, body = _body(await _raw(host, port, (
            f"GET /tx?hash=0x{tx_hash(TXS[0]).hex()} HTTP/1.1\r\n"
            "Host: x\r\nConnection: close\r\n\r\n").encode()))
        assert body["result"]["height"] == h
        head, body = _body(await _raw(host, port, (
            "HEAD /status HTTP/1.1\r\nHost: x\r\nConnection: close\r\n\r\n"
        ).encode()))
        assert "200 OK" in head and body is None
        cli = HTTPClient(host, port)
        out = await cli.call_batch([("health", {}), ("block", {"height": h}),
                                    ("nope", {}), ("status", {})])
        assert out[0] == {} and out[1]["block"]["hdr"]["h"] == h
        assert isinstance(out[2], RPCError) and out[2].code == -32601
        assert out[3]["node_info"]["network"] == "rpc-net"
        raw = json.dumps([{"jsonrpc": "2.0", "id": 7, "method": "health"},
                          {"jsonrpc": "2.0", "method": "health"}]).encode()
        head, body = _body(await _raw(host, port, (
            f"POST / HTTP/1.1\r\nHost: x\r\nContent-Length: {len(raw)}\r\n"
            "Connection: close\r\n\r\n").encode() + raw))
        assert body == [{"jsonrpc": "2.0", "id": 7, "result": {}}]
        await cli.close()

    net.run(main())


def test_metrics_text(net):
    async def main():
        host, port = net.nodes[0].rpc_addr
        raw = await _raw(host, port, (
            "GET /metrics HTTP/1.1\r\nHost: x\r\nConnection: close\r\n\r\n"
        ).encode())
        head, _, text = raw.partition(b"\r\n\r\n")
        return head.decode(), text.decode()

    head, text = net.run(main())
    assert "text/plain; version=0.0.4" in head
    assert "# TYPE lightserve_anchors_verified_total counter" in text
    assert "# TYPE lightserve_request_seconds histogram" in text
    assert 'lightserve_request_seconds_bucket{le="+Inf",route=' in text
    assert text == text.rstrip("\n") + "\n"
    assert tmetrics.DEFAULT.collect().startswith("# HELP ")


def test_prometheus_listener_of_its_own():
    """``instrumentation.prometheus``'s listener serves the registry's
    text on any path."""
    from cometbft_tpu_torch.node.node import _serve_prometheus

    async def main():
        srv = await _serve_prometheus("tcp://127.0.0.1:0")
        host, port = srv.sockets[0].getsockname()[:2]
        try:
            raw = await _raw(host, port, b"GET /metrics HTTP/1.1\r\n"
                             b"Host: x\r\n\r\n")
        finally:
            srv.close()
            await srv.wait_closed()
        head, _, text = raw.partition(b"\r\n\r\n")
        assert b"200 OK" in head and b"version=0.0.4" in head
        assert text.startswith(b"# HELP ") and b"\n# TYPE " in text

    asyncio.run(main())


def test_overload_shed_is_retryable(net):
    async def main():
        v = net.nodes[0]
        cli = HTTPClient(*v.rpc_addr)
        wd = v.loop_watchdog
        assert wd is not None
        saved = wd.last_lag_s
        wd.last_lag_s = 10 * v.config.rpc.overload_shed_lag_s
        try:
            with pytest.raises(RPCError) as e:
                await cli.call("broadcast_tx_sync", tx=b"shed=1".hex())
            assert e.value.code == -32099
            assert await cli.call("health") == {}       # not a tx route
        finally:
            wd.last_lag_s = saved
        assert (await submit(cli, "broadcast_tx_sync",
                             tx=b"shed=2".hex()))["code"] == 0
        await cli.close()

    net.run(main())


# -------------------------------------------------------------- websocket

def test_websocket_subscriptions(net):
    async def main():
        v, f = net.nodes
        ws = await WSClient.connect(*f.rpc_addr)
        await ws.subscribe("tm.event='NewBlock'")
        tx = b"wsk=wsv"
        key = tx_hash(tx).hex()
        ws2 = await WSClient.connect(*v.rpc_addr)
        await ws2.subscribe(f"tm.event='Tx' AND tx.hash='{key}'")
        with pytest.raises(RPCError):
            await ws2.subscribe("tm.event =")
        with pytest.raises(RPCError):
            await ws2.subscribe(f"tm.event='Tx' AND tx.hash='{key}'")
        cli = HTTPClient(*v.rpc_addr)
        res = await submit(cli, "broadcast_tx_commit", tx=tx.hex())
        evt = await ws2.next_event(timeout=60)
        assert evt["data"]["type"] == "Tx"
        assert evt["data"]["value"]["height"] == res["height"]
        assert evt["events"]["tx.hash"] == key
        seen = []
        while len(seen) < 2:
            e = await ws.next_event(timeout=60)
            assert e["query"] == "tm.event='NewBlock'"
            seen.append(e["data"]["value"]["block"]["hdr"]["h"])
        assert seen[1] == seen[0] + 1
        await ws.send("unsubscribe_all")
        await ws.send("health")
        while True:
            r = await ws.recv()
            if r.get("id") == 2:
                assert r["result"] == {}
                break
        await ws.close()
        await ws2.close()
        await cli.close()
        await asyncio.sleep(0.2)
        assert all(not k.startswith("ws-")
                   for n in net.nodes for k in n.event_bus._subs)

    net.run(main())


# --------------------------------------------------- parity with the JAX JSON

def test_json_equals_jax_routes(net):
    jenv = JCore.Environment(SimpleNamespace(
        block_store=net.jax.block_store, state_store=net.jax.state_store))
    top = net.jax.top - 1

    async def jax_results():
        out = {}
        for h in range(1, top + 1):
            out[h] = {"block": await JCore.block(jenv, h),
                      "header": await JCore.header(jenv, h),
                      "commit": await JCore.commit(jenv, h),
                      "validators": await JCore.validators(jenv, h),
                      "block_results": await JCore.block_results(jenv, h),
                      "consensus_params":
                          await JCore.consensus_params(jenv, h)}
        out["blockchain"] = await JCore.blockchain(jenv, 1, top)
        return out

    want = asyncio.run(jax_results())

    async def port_results():
        cli = HTTPClient(*net.nodes[0].rpc_addr)
        out = {}
        for h in range(1, top + 1):
            out[h] = {name: await cli.call(name, height=h)
                      for name in want[h]}
        out["blockchain"] = await cli.call("blockchain", min_height=1,
                                           max_height=top)
        await cli.close()
        return out

    got = net.run(port_results())
    # the live chain has grown past the copy: last_height only differs
    assert got["blockchain"]["block_metas"] == \
        want["blockchain"]["block_metas"]
    assert len(want["blockchain"]["block_metas"]) == min(top, 20)
    assert got["blockchain"]["last_height"] >= \
        want["blockchain"]["last_height"]
    for h in range(1, top + 1):
        for name in want[h]:
            assert got[h][name] == want[h][name], (h, name)


def test_openapi_equals_jax():
    node = SimpleNamespace(config=None)
    tsrv = RPCServer(node)
    jsrv = JServer(node, routes={k: JCore.ROUTES[k] for k in TCore.ROUTES})
    assert set(TCore.ROUTES) == set(JCore.ROUTES)
    assert tsrv.openapi_spec() == jsrv.openapi_spec()


def test_jax_clients_against_port_server(net):
    async def main():
        v = net.nodes[0]
        h = net.committed[TXS[2]]
        jc = JHTTP(*v.rpc_addr)
        blk = await jc.call("block", height=h)
        assert {"~b": TXS[2].hex()} in blk["block"]["data"]["txs"]
        out = await jc.call_batch([("health", {}), ("header", {"height": h})])
        assert out[1]["header"]["h"] == h
        ws = await JWS.connect(*v.rpc_addr)
        await ws.subscribe("tm.event='NewBlock'")
        e = await ws.next_event(timeout=60)
        assert e["data"]["type"] == "NewBlock"
        await ws.close()
        await jc.close()

    net.run(main())


def test_port_clients_against_jax_server(net):
    jbus = JBus()
    jnode = SimpleNamespace(block_store=net.jax.block_store,
                            state_store=net.jax.state_store, config=None,
                            event_bus=jbus)
    h = net.committed[TXS[0]]

    async def main():
        srv = JServer(jnode)
        addr = await srv.listen("127.0.0.1", 0)
        try:
            cli = HTTPClient(*addr)
            blk = await cli.call("block", height=h)
            assert {"~b": TXS[0].hex()} in blk["block"]["data"]["txs"]
            out = await cli.call_batch([("commit", {"height": h}),
                                        ("validators", {"height": h})])
            assert out[0]["commit"]["h"] == h and out[1]["total"] == 1
            ws = await WSClient.connect(*addr)
            await ws.subscribe("tm.event='Tx' AND app.key EXISTS")
            jbus.publish("Tx", {"height": 5}, {"app.key": "k"})
            e = await ws.next_event(timeout=30)
            assert e["data"]["value"] == {"height": 5}
            await ws.close()
            await cli.close()
        finally:
            await srv.close()

    asyncio.run(main())


# ------------------------------------------------ CORS, TLS, admission gate

def _stub(**rpc):
    cfg = Config()
    for k, val in rpc.items():
        setattr(cfg.rpc, k, val)
    return SimpleNamespace(config=cfg, home=None, event_bus=None)


def test_cors():
    async def main():
        srv = RPCServer(_stub(cors_allowed_origins=["https://*.example.com"]))
        host, port = await srv.listen()
        try:
            head, _ = _body(await _raw(host, port, (
                "OPTIONS / HTTP/1.1\r\nHost: x\r\n"
                "Origin: https://app.example.com\r\n"
                "Connection: close\r\n\r\n").encode()))
            assert "204 No Content" in head
            assert "Access-Control-Allow-Origin: https://app.example.com" \
                in head
            assert "Access-Control-Allow-Methods: HEAD, GET, POST" in head
            head, body = _body(await _raw(host, port, (
                "GET /health HTTP/1.1\r\nHost: x\r\n"
                "Origin: https://evil.test\r\nConnection: close\r\n\r\n"
            ).encode()))
            assert "Vary: Origin" in head
            assert "Access-Control-Allow-Origin" not in head
            assert body["result"] == {}
        finally:
            await srv.close()
        srv = RPCServer(_stub())
        host, port = await srv.listen()
        try:
            head, _ = _body(await _raw(host, port, (
                "GET /health HTTP/1.1\r\nHost: x\r\n"
                "Origin: https://app.example.com\r\nConnection: close\r\n"
                "\r\n").encode()))
            assert "Vary" not in head and "Access-Control" not in head
        finally:
            await srv.close()

    asyncio.run(main())


def _self_signed(tmp_path):
    if shutil.which("openssl") is not None:
        cert, key = tmp_path / "rpc.crt", tmp_path / "rpc.key"
        subprocess.run(
            ["openssl", "req", "-x509", "-newkey", "ec", "-pkeyopt",
             "ec_paramgen_curve:prime256v1", "-keyout", str(key), "-out",
             str(cert), "-days", "1", "-nodes", "-subj", "/CN=localhost"],
            check=True, capture_output=True)
        return str(cert), str(key)
    try:
        import datetime

        from cryptography import x509
        from cryptography.hazmat.primitives import hashes, serialization
        from cryptography.hazmat.primitives.asymmetric import ec
        from cryptography.x509.oid import NameOID
    except ImportError:
        pytest.skip("needs the openssl CLI or the cryptography package")
    k = ec.generate_private_key(ec.SECP256R1())
    name = x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, "localhost")])
    now = datetime.datetime.now(datetime.timezone.utc)
    c = (x509.CertificateBuilder().subject_name(name).issuer_name(name)
         .public_key(k.public_key()).serial_number(1)
         .not_valid_before(now - datetime.timedelta(minutes=5))
         .not_valid_after(now + datetime.timedelta(days=1))
         .sign(k, hashes.SHA256()))
    cert, key = tmp_path / "rpc.crt", tmp_path / "rpc.key"
    cert.write_bytes(c.public_bytes(serialization.Encoding.PEM))
    key.write_bytes(k.private_bytes(
        serialization.Encoding.PEM, serialization.PrivateFormat.PKCS8,
        serialization.NoEncryption()))
    return str(cert), str(key)


def test_tls(tmp_path):
    cert, key = _self_signed(tmp_path)

    async def main():
        srv = RPCServer(_stub(tls_cert_file=cert, tls_key_file=key))
        host, port = await srv.listen()
        try:
            cli = HTTPClient(host, port, tls=True, tls_verify=False)
            assert await cli.call("health") == {}
            assert (await cli.clone().call("health")) == {}
            await cli.close()
            plain = HTTPClient(host, port)
            with pytest.raises((ConnectionError, OSError, RPCError,
                                asyncio.IncompleteReadError)):
                await asyncio.wait_for(plain.call("health"), 10)
            await plain.close()
        finally:
            await srv.close()

    asyncio.run(main())


def _health_body(size: int) -> bytes:
    raw = json.dumps({"jsonrpc": "2.0", "id": 1, "method": "health",
                      "params": {}}).encode()
    return raw[:-1] + b" " * (size - len(raw)) + b"}"


def _post(raw: bytes) -> bytes:
    return (f"POST / HTTP/1.1\r\nHost: x\r\nContent-Length: {len(raw)}"
            "\r\nConnection: close\r\n\r\n").encode() + raw


async def _dropped(host, port, req: bytes) -> bool:
    """True when the server closes the connection with no answer."""
    try:
        return await _raw(host, port, req) == b""
    except ConnectionResetError:
        return True


def test_body_cap_drops_oversized_requests(monkeypatch):
    """A body within ``MAX_BODY`` (the JAX package's 10 MiB) is served; a
    body past it is served while ``LARGE_BODY_BUDGET``, shared by the
    whole server, has room for it, and drops its connection unanswered
    when it has not; the budget comes back when the request is done."""
    from cometbft_tpu_torch.rpc import server as srv_mod

    assert srv_mod.MAX_BODY == 10 << 20
    assert srv_mod.LARGE_BODY_BUDGET >= 31 << 20
    monkeypatch.setattr(srv_mod, "MAX_BODY", 2000)
    monkeypatch.setattr(srv_mod, "LARGE_BODY_BUDGET", 5000)

    async def main():
        srv = RPCServer(_stub())
        host, port = await srv.listen()
        try:
            for size in (1500, 4000):
                head, body = _body(await _raw(host, port,
                                              _post(_health_body(size))))
                assert "200 OK" in head and body["result"] == {}, size
            assert await _dropped(host, port, _post(_health_body(6000)))
            # one large body half sent holds 4,000 of the 5,000 bytes
            big = _post(_health_body(4000))
            reader, writer = await asyncio.open_connection(host, port)
            writer.write(big[:-100])
            await writer.drain()
            await asyncio.sleep(0.2)
            assert srv._large_free == 1000
            assert await _dropped(host, port, _post(_health_body(4000)))
            head, _ = _body(await _raw(host, port,
                                       _post(_health_body(1500))))
            assert "200 OK" in head               # small bodies still flow
            writer.write(big[-100:])
            await writer.drain()
            head, body = _body(await asyncio.wait_for(reader.read(-1), 20))
            writer.close()
            assert "200 OK" in head and body["result"] == {}
            for _ in range(100):
                if srv._large_free == 5000:
                    break
                await asyncio.sleep(0.02)
            assert srv._large_free == 5000
            head, _ = _body(await _raw(host, port,
                                       _post(_health_body(4000))))
            assert "200 OK" in head
        finally:
            await srv.close()

    asyncio.run(main())


def test_max_open_connections():
    """Connections past ``rpc.max_open_connections`` are closed on accept;
    a slot freed by a closed connection is taken again."""
    async def main():
        srv = RPCServer(_stub(max_open_connections=2))
        host, port = await srv.listen()
        try:
            held = [await asyncio.open_connection(host, port)
                    for _ in range(2)]
            await asyncio.sleep(0.2)
            assert len(srv._conn_tasks) == 2
            req = ("GET /health HTTP/1.1\r\nHost: x\r\n"
                   "Connection: close\r\n\r\n").encode()
            assert await _dropped(host, port, req)
            held[0][1].close()
            for _ in range(100):
                if len(srv._conn_tasks) < 2:
                    break
                await asyncio.sleep(0.02)
            head, body = _body(await _raw(host, port, req))
            assert "200 OK" in head and body["result"] == {}
            held[1][1].close()
        finally:
            await srv.close()

    asyncio.run(main())


def test_admission_gate_sheds_with_503():
    async def main():
        release = asyncio.Event()

        async def slow(env):
            await release.wait()
            return {"slow": True}

        async def health(env):
            return {}

        srv = RPCServer(_stub(max_concurrent_requests=1,
                              max_queued_requests=1, shed_retry_after_s=2),
                        routes={"slow": slow, "health": health,
                                "status": health})
        host, port = await srv.listen()
        try:
            clients = [HTTPClient(host, port) for _ in range(2)]
            running = [asyncio.create_task(c.call("slow")) for c in clients]
            await asyncio.sleep(0.2)            # one runs, one waits
            head, body = _body(await _raw(host, port, (
                "GET /slow HTTP/1.1\r\nHost: x\r\nConnection: close\r\n\r\n"
            ).encode()))
            assert "503 Service Unavailable" in head
            assert "Retry-After: 2" in head
            assert body["error"]["code"] == -32000
            head, body = _body(await _raw(host, port, (
                "GET /status HTTP/1.1\r\nHost: x\r\nConnection: close\r\n"
                "\r\n").encode()))
            assert "200 OK" in head               # diagnostics bypass it
            release.set()
            assert [await t for t in running] == [{"slow": True}] * 2
            for c in clients:
                await c.close()
        finally:
            await srv.close()

    asyncio.run(main())
