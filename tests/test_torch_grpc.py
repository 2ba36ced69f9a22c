"""The port's gRPC transports (``abci/grpc.py``, ``rpc/grpc.py``, over
``libs/_grpc.py`` and ``libs/_h2.py``) against the JAX package's, which
run on grpcio: the five cases of ``tests/test_grpc.py``, each through
every pairing of a client and a server of the two packages (grpcio
client to port server, port client to grpcio server, port to port), and
each pairing gives the JAX pair's results, error texts and status codes
included.

- ABCI: echo, info, finalize_block and 10 concurrent queries; an app
  error's text; ``RESOURCE_EXHAUSTED`` for a request and a response over
  4 MiB; ``UNIMPLEMENTED`` for an unknown method, the channel going on.
- The node's services over a live single validator of each package
  (the port's on ``device="cpu"``, through ``torch_node_fixtures``):
  version, block and block results at height 1, the retain height set
  and read back, the latest-height stream, whose event-bus subscription
  goes when the client leaves the stream and when the server stops.
- A node over an app served by the other package, over gRPC and over
  the socket protocol.
- The port's channel: a refused connect is ``UNAVAILABLE`` and a later
  call connects once a server is up."""

import asyncio
import dataclasses
import gc

import grpc
import grpc.aio
import pytest

import torch_node_fixtures as tnf
from cometbft_tpu.abci import grpc as JG
from cometbft_tpu.abci import server as JS
from cometbft_tpu.abci import types as JA
from cometbft_tpu.abci.client import ABCIClientError as JErr
from cometbft_tpu.abci.kvstore import KVStoreApplication as JApp
from cometbft_tpu.rpc import grpc as JRG
from cometbft_tpu_torch.abci import grpc as PG
from cometbft_tpu_torch.abci import server as PS
from cometbft_tpu_torch.abci import types as PA
from cometbft_tpu_torch.abci.client import ABCIClientError as PErr
from cometbft_tpu_torch.abci.kvstore import KVStoreApplication as PApp
from cometbft_tpu_torch.libs import _grpc
from cometbft_tpu_torch.rpc import grpc as PRG
from torch_node_fixtures import no_host_verify  # noqa: F401

pytestmark = pytest.mark.timeout(150)

PKG = {"jax": (JG, JA, JApp, JErr, JRG), "port": (PG, PA, PApp, PErr, PRG)}
# (client, server)
PAIRS = [("jax", "jax"), ("jax", "port"), ("port", "jax"),
         ("port", "port")]
PAIR_IDS = [f"{c}-client-{s}-server" for c, s in PAIRS]


def run(coro):
    return tnf.run(coro)


def _app(pkg, cls=None):
    cls = cls or PKG[pkg][2]
    return cls(device="cpu") if pkg == "port" else cls()


def _norm(x):
    """A response as plain data (the packages' dataclasses have the same
    fields in the same order)."""
    if dataclasses.is_dataclass(x):
        return {f.name: _norm(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, (list, tuple)):
        return [_norm(v) for v in x]
    if isinstance(x, dict):
        return {k: _norm(v) for k, v in x.items()}
    return x


async def _serve(pkg, app):
    server = PKG[pkg][0].GRPCABCIServer(app, port=0)
    await server.start()
    return server


def _channel(pkg, port):
    target = f"127.0.0.1:{port}"
    return (grpc.aio.insecure_channel(target) if pkg == "jax"
            else _grpc.insecure_channel(target))


# ------------------------------------------------------------------ ABCI

async def _roundtrip(client_pkg, server_pkg):
    """tests/test_grpc.py::test_abci_grpc_roundtrip"""
    app = _app(server_pkg)
    server = await _serve(server_pkg, app)
    G, A = PKG[client_pkg][:2]
    client = await G.GRPCClient.connect(port=server.port)
    try:
        out = {"echo": await client.echo("hello"),
               "info": _norm(await client.info())}
        fin = await client.finalize_block(A.FinalizeBlockRequest(
            txs=[b"k=v"], height=1, time_ns=0, misbehavior=[]))
        assert fin.tx_results[0].is_ok and fin.app_hash == app.app_hash
        out["finalize_block"] = _norm(fin)
        # HTTP/2 multiplexing: concurrent calls resolve correctly
        results = await asyncio.gather(*[
            client.query("/k", b"k", 0, False) for _ in range(10)])
        assert all(r.value == b"v" for r in results)
        out["queries"] = _norm(results)
        return out
    finally:
        await client.close()
        await server.stop()


@pytest.fixture(scope="module")
def jax_pair_roundtrip():
    return run(_roundtrip("jax", "jax"))


@pytest.mark.parametrize("client_pkg,server_pkg", PAIRS, ids=PAIR_IDS)
def test_abci_grpc_roundtrip(client_pkg, server_pkg, jax_pair_roundtrip):
    got = run(_roundtrip(client_pkg, server_pkg))
    assert got == jax_pair_roundtrip
    assert got["echo"] == "hello" and got["info"]["data"] == "kvstore"


class _JExploding(JApp):
    async def info(self):
        raise RuntimeError("boom")


class _PExploding(PApp):
    async def info(self):
        raise RuntimeError("boom")


class _JBig(JApp):
    async def info(self):
        return JA.InfoResponse(data="x" * (5 << 20))


class _PBig(PApp):
    async def info(self):
        return PA.InfoResponse(data="x" * (5 << 20))


async def _errors(client_pkg, server_pkg):
    """tests/test_grpc.py::test_abci_grpc_app_error_propagates, and the
    transport's refusals: what each call raised, as (type, text)."""
    G, _, _, Err, _ = PKG[client_pkg]
    out = {}
    for case, cls in (("app_error", (_JExploding, _PExploding)),
                      ("limits", (_JBig, _PBig))):
        app = _app(server_pkg, cls[server_pkg == "port"])
        server = await _serve(server_pkg, app)
        client = await G.GRPCClient.connect(port=server.port)
        try:
            calls = {"info": client.info}
            if case == "limits":
                calls["echo_5mib"] = lambda: client.echo("y" * (5 << 20))
                calls["echo_after"] = lambda: client.echo("ok")
            for name, call in calls.items():
                try:
                    out[f"{case}.{name}"] = ("ok", _norm(await call()))
                except Err as e:
                    out[f"{case}.{name}"] = ("ABCIClientError", str(e))
            if case == "limits":
                ch = _channel(client_pkg, server.port)
                err_cls = (grpc.aio.AioRpcError if client_pkg == "jax"
                           else _grpc.RpcError)
                try:
                    await ch.unary_unary(
                        f"/{JG.SERVICE}/NoSuchMethod")(b"")
                    out["unimplemented"] = "ok"
                except err_cls as e:
                    out["unimplemented"] = (e.code().name,
                                            e.code().value, e.details())
                await ch.close()
        finally:
            await client.close()
            await server.stop()
    return out


@pytest.fixture(scope="module")
def jax_pair_errors():
    return run(_errors("jax", "jax"))


@pytest.mark.parametrize("client_pkg,server_pkg", PAIRS, ids=PAIR_IDS)
def test_abci_grpc_app_error_propagates(client_pkg, server_pkg,
                                        jax_pair_errors):
    got = run(_errors(client_pkg, server_pkg))
    assert got == jax_pair_errors
    assert got["app_error.info"] == ("ABCIClientError",
                                     "RuntimeError('boom')")
    assert got["limits.echo_5mib"] == (
        "ABCIClientError", "grpc transport error: StatusCode."
        "RESOURCE_EXHAUSTED: SERVER: Received message larger than max "
        "(5242890 vs. 4194304)")
    assert got["limits.info"][1].startswith(
        "grpc transport error: StatusCode.RESOURCE_EXHAUSTED: CLIENT: "
        "Received message larger than max (")
    assert got["limits.echo_after"] == ("ok", "ok")
    assert got["unimplemented"] == ("UNIMPLEMENTED", (12, "unimplemented"),
                                    "Method not found!")


# ------------------------------------------------------------- services

async def _jax_node(cfg):
    from cometbft_tpu.node import Node
    from cometbft_tpu.p2p import NodeKey
    from cometbft_tpu.types.genesis import GenesisDoc, GenesisValidator
    from cometbft_tpu.types.priv_validator import MockPV

    pv = MockPV.from_secret(b"grpcnode0")
    doc = GenesisDoc(chain_id="grpc-net",
                     validators=[GenesisValidator(pv.get_pub_key(), 10)])
    node = await Node.create(
        doc, JApp() if cfg.base.abci == "builtin" else None,
        priv_validator=pv, config=cfg,
        node_key=NodeKey.from_secret(b"gnk0"), name="gnode0")
    await node.start()
    return node


def _jax_config():
    from cometbft_tpu.config import Config, test_consensus_config

    cfg = Config(consensus=test_consensus_config())
    cfg.p2p.laddr = "tcp://127.0.0.1:0"
    cfg.rpc.laddr = ""
    return cfg


async def _port_node(cfg):
    from cometbft_tpu_torch.node import Node
    from cometbft_tpu_torch.p2p import NodeKey

    doc, pvs = tnf.genesis(1, chain_id="grpc-net", tag=b"grpcnode")
    if cfg.base.abci == "builtin":
        node = await tnf.make_node(doc, pvs[0], 0, tag="gnode",
                                   config_=cfg)
    else:
        node = await Node.create(doc, None, priv_validator=pvs[0],
                                 config=cfg,
                                 node_key=NodeKey.from_secret(b"gnk0"),
                                 name="gnode0")
    await node.start()
    return node


async def _wait_height(node, h, timeout=100.0):
    async def reached():
        while node.height() < h:
            await asyncio.sleep(0.05)
    await asyncio.wait_for(reached(), timeout)


def _grpc_subs(node) -> list:
    return [k for k in node.event_bus._subs
            if k.startswith("grpc-latest-height")]


async def _wait_subs(node, n, timeout=30.0):
    """Until the node's bus holds ``n`` latest-height subscriptions (a
    grpcio stream call left behind is cancelled when it is collected)."""
    async def reached():
        while len(_grpc_subs(node)) != n:
            gc.collect()
            await asyncio.sleep(0.05)
    await asyncio.wait_for(reached(), timeout)


async def _services(node, client_pkg):
    """tests/test_grpc.py::test_node_grpc_services through one client."""
    R = PKG[client_pkg][4]
    client = await R.GRPCServicesClient.connect("127.0.0.1",
                                                node.grpc_server.port)
    try:
        out = {"version": await client.get_version(),
               "block_1": await client.get_block_by_height(1),
               "block_results_1": await client.get_block_results(height=1)}
        latest = await client.get_block_by_height()
        assert latest["block"]["hdr"]["h"] >= 1
        assert out["version"]["abci"] == "2.0.0"
        assert out["block_results_1"]["height"] == 1
        out["set_retain"] = await client.set_block_retain_height(1)
        assert out["set_retain"]["data_companion_retain_height"] == 1
        out["get_retain"] = await client.get_block_retain_height()
        assert out["get_retain"]["pruning_service_retain_height"] == 1

        heights = []
        stream = client.latest_height_stream()

        async def consume():
            async for h in stream:
                heights.append(h["height"])
                if len(heights) >= 2:
                    return

        await asyncio.wait_for(consume(), timeout=60)
        assert heights[0] >= 1 and heights[1] == heights[0] + 1
        # the client left the stream: the server's subscription goes
        await stream.aclose()
        await _wait_subs(node, 0)
        out["stream_steps"] = heights[1] - heights[0]
        return out
    finally:
        await client.close()


async def _services_both_clients(server_pkg):
    if server_pkg == "jax":
        cfg = _jax_config()
        cfg.rpc.grpc_laddr = "tcp://127.0.0.1:0"
        node = await _jax_node(cfg)
    else:
        cfg = tnf.config()
        cfg.rpc.grpc_laddr = "tcp://127.0.0.1:0"
        node = await _port_node(cfg)
    try:
        await _wait_height(node, 2)
        got = {c: await _services(node, c) for c in ("jax", "port")}
        # a stream open when the server stops: its subscription goes too
        R = PKG["port"][4]
        client = await R.GRPCServicesClient.connect("127.0.0.1",
                                                    node.grpc_server.port)
        stream = client.latest_height_stream()
        await asyncio.wait_for(stream.__anext__(), 30)
        await _wait_subs(node, 1)   # subscribed once the first is sent
        await node.grpc_server.stop()
        await _wait_subs(node, 0)

        async def drain():
            async for _ in stream:
                pass

        with pytest.raises(_grpc.RpcError):
            await asyncio.wait_for(drain(), 30)
        await client.close()
        return got
    finally:
        await node.stop()


@pytest.mark.parametrize("server_pkg", ["jax", "port"])
def test_node_grpc_services(server_pkg):
    """Both clients against one node's server: equal answers (so grpcio
    against the port's server answers as the port's client does, and the
    port's client against grpcio's as grpcio's own)."""
    got = run(_services_both_clients(server_pkg))
    assert got["jax"] == got["port"]
    assert got["port"]["stream_steps"] == 1


# ------------------------------------------------- nodes over remote apps

async def _node_over_app(node_pkg, server_pkg, protocol, top):
    app = _app(server_pkg)
    if protocol == "grpc":
        server = await _serve(server_pkg, app)
    else:
        server = (JS if server_pkg == "jax" else PS).ABCIServer(app, port=0)
        await server.start()
    cfg = _jax_config() if node_pkg == "jax" else tnf.config()
    cfg.base.abci = protocol
    cfg.base.proxy_app = f"tcp://127.0.0.1:{server.port}"
    node = await (_jax_node(cfg) if node_pkg == "jax" else _port_node(cfg))
    try:
        await _wait_height(node, top)
        return [node.block_store.load_block(h).header.app_hash
                for h in range(1, top + 1)]
    finally:
        await node.stop()
        await server.stop()


@pytest.fixture(scope="module")
def jax_pair_app_hashes():
    return run(_node_over_app("jax", "jax", "grpc", 2))


@pytest.mark.parametrize("node_pkg,server_pkg", PAIRS, ids=[
    f"{n}-node-{s}-app" for n, s in PAIRS])
def test_node_over_grpc_app(node_pkg, server_pkg, jax_pair_app_hashes):
    """tests/test_grpc.py::test_node_over_grpc_app: a node driven by an
    out-of-process app over gRPC commits; its blocks carry the JAX
    pair's app hashes."""
    hashes = jax_pair_app_hashes if (node_pkg, server_pkg) == (
        "jax", "jax") else run(_node_over_app(node_pkg, server_pkg,
                                              "grpc", 2))
    assert len(hashes) == 2 and hashes == jax_pair_app_hashes


@pytest.mark.parametrize("server_pkg", ["jax", "port"])
def test_node_over_socket_app(server_pkg):
    """tests/test_grpc.py::test_node_over_socket_app: a port node over
    each package's socket server commits to height 3 (the Commit trees
    of PrepareProposal.local_last_commit through the shared frames)."""
    hashes = run(_node_over_app("port", server_pkg, "socket", 3))
    assert len(hashes) == 3


# --------------------------------------------------------- the channel

def test_refused_connect_is_unavailable_and_the_next_call_connects():
    import socket

    async def main():
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        client = await PG.GRPCClient.connect(port=port)
        with pytest.raises(PErr) as e:
            await client.echo("x")
        refused = str(e.value)
        server = PG.GRPCABCIServer(_app("port"), port=port)
        await server.start()
        try:
            echoed = await client.echo("x")
        finally:
            await server.stop()
        with pytest.raises(PErr) as e2:
            await client.echo("y")          # the server is gone
        await client.close()
        return refused, echoed, str(e2.value)

    refused, echoed, gone = run(main())
    assert refused.startswith(
        "grpc transport error: StatusCode.UNAVAILABLE: failed to connect "
        "to all addresses; last error: UNKNOWN: ipv4:127.0.0.1:")
    assert "Connection refused" in refused
    assert echoed == "x"
    assert gone.startswith("grpc transport error: StatusCode.UNAVAILABLE")
