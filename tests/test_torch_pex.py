"""The port's peer exchange (``cometbft_tpu_torch/p2p/pex.py``) against
the JAX package's, on the CPU: its messages are ``msgpack.packb``'s
bytes; driven through the same stub switch and peers, with the JAX
reactor's module ``random`` seeded as the port reactor's and book's
shared generator, both reactors send the same bytes, dial the same
addresses, hang up the same peers in seed mode and leave the same
address book (``tests/test_addrbook.py::test_seed_crawl_dials_and_
hangs_up``, the anti-poisoning gate, ``ensure_peers``); and over real
TCP a port node finds a third node through a JAX node's pex
(``tests/test_pex.py``)."""

import asyncio
import random

import msgpack
import numpy as np
import pytest
import torch

from cometbft_tpu.p2p import addrbook as jab
from cometbft_tpu.p2p import pex as jpex
from cometbft_tpu_torch.crypto import _ed25519_py as ref
from cometbft_tpu_torch.crypto import scheduler as vsched
from cometbft_tpu_torch.p2p import addrbook as pab
from cometbft_tpu_torch.p2p import pex as ppex

torch.set_num_threads(1)

pytestmark = pytest.mark.timeout(60)

SALT = "0123456789abcdef"


def run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


@pytest.fixture(autouse=True)
def no_host_verify(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("host oracle called on the p2p path")

    monkeypatch.setattr(ref, "verify_zip215", refuse)
    vsched.set_scheduler(None)
    yield
    vsched.set_scheduler(None)


def nid(i: int) -> str:
    return f"{i:040x}"


class _NodeInfo:
    def __init__(self, listen_addr):
        self.listen_addr = listen_addr


class _Peer:
    def __init__(self, i, outbound=False, remote="8.8.8.8:41234"):
        self.id = nid(i)
        self.node_info = _NodeInfo(f"12.{i % 7}.0.{i}:26656")
        self.outbound = outbound
        self.remote_addr = remote
        self.dial_addr = f"12.{i % 7}.0.{i}:26656" if outbound else None
        self.sent = []

    def send(self, ch, msg):
        self.sent.append((ch, bytes(msg)))
        return True


class _Switch:
    def __init__(self):
        self.peers = {}
        self.dialed = []
        self.stopped = []

    async def dial_peer(self, addr, persistent=False):
        self.dialed.append(addr)

    async def stop_peer_gracefully(self, peer):
        self.stopped.append(peer.id)
        self.peers.pop(peer.id, None)


def _reactor(pkg, seed, **kw):
    """A reactor and its book: the JAX pair draws from the module
    ``random`` (seeded here), the port pair from one shared generator."""
    if pkg == "jax":
        random.seed(seed)
        book = jab.AddrBook(None)
        book._salt = SALT
        return jpex.PexReactor(book, nid(99), **kw), book
    rng = random.Random(seed)
    book = pab.AddrBook(None, salt=SALT, rng=rng)
    return ppex.PexReactor(book, nid(99), rng=rng, **kw), book


def _book_view(book):
    return sorted((k, tuple(v)) for k, v in book._where.items())


def test_messages_are_msgpack_bytes():
    req = msgpack.packb({"@": "pex_req"}, use_bin_type=True)
    addrs = [{"id": nid(i), "addr": f"10.{i}.0.1:26656"} for i in range(40)]
    res = msgpack.packb({"@": "pex_res", "addrs": addrs},
                        use_bin_type=True)
    assert ppex._msgpack.packb({"@": "pex_req"}) == req
    assert ppex._msgpack.packb({"@": "pex_res", "addrs": addrs}) == res
    assert ppex._msgpack.unpackb(res) == msgpack.unpackb(res, raw=False)
    assert ppex.PEX_CHANNEL == jpex.PEX_CHANNEL == 0
    assert [(d.channel_id, d.priority, d.send_queue_capacity, d.name)
            for d in ppex.PexReactor(pab.AddrBook(None), nid(1))
            .get_channels()] == \
        [(d.channel_id, d.priority, d.send_queue_capacity, d.name)
         for d in jpex.PexReactor(jab.AddrBook(None), nid(1))
         .get_channels()]


@pytest.mark.parametrize("seed", [int(s) for s in np.random.default_rng(
    161).integers(0, 2**31, 3)])
def test_request_response_and_gate_match(seed):
    """Peers arrive (inbound and outbound), ask and answer: the same
    bytes out, the same book; an unsolicited response, one with no
    proven source and our own id are dropped alike."""
    rng = np.random.default_rng(seed)
    plan = [(int(rng.integers(0, 60)), bool(rng.integers(0, 2)))
            for _ in range(12)]

    def scenario(pkg):
        r, book = _reactor(pkg, seed)
        sw = _Switch()
        r.set_switch(sw)
        for i in range(30):
            book.add(nid(200 + i), f"99.{i}.1.1:26656", persist=False)
        peers = []
        for i, outbound in plan:
            p = _Peer(i, outbound=outbound)
            if p.id in sw.peers:
                continue
            sw.peers[p.id] = p
            r.add_peer(p)
            peers.append(p)
        q = peers[0]
        r.receive(0, q, msgpack.packb({"@": "pex_req"}, use_bin_type=True))
        resp = msgpack.packb({"@": "pex_res", "addrs": [
            {"id": nid(300 + k), "addr": f"77.{k}.0.1:26656"}
            for k in range(5)] + [{"id": nid(99), "addr": "1.1.1.1:1"}]},
            use_bin_type=True)
        r.receive(0, q, resp)                        # solicited
        r.receive(0, q, resp.replace(b"77.", b"66."))  # no longer
        anon = peers[1]
        anon.remote_addr = ""
        r.receive(0, anon, resp.replace(b"77.", b"55."))
        r.remove_peer(peers[2], None)
        return ([p.sent for p in peers], _book_view(book),
                sorted(r._requested), book.is_banned(nid(99)))

    j, p = scenario("jax"), scenario("port")
    assert j == p
    assert any(b"pex_res" in m for _, m in j[0][0])


def test_seed_crawl_dials_and_hangs_up(monkeypatch):
    """A seed-mode reactor crawls its book and hangs up on a harvested
    inbound peer after the linger, not vetting its advertised address;
    an outbound one is vetted: the same in both packages."""
    monkeypatch.setattr(jpex, "CRAWL_LINGER", 0.05)
    monkeypatch.setattr(ppex, "CRAWL_LINGER", 0.05)

    async def scenario(pkg):
        r, book = _reactor(pkg, 5, seed_mode=True, request_interval=0.02)
        for i in range(6):
            book.add(nid(i), f"12.0.0.{i}:26656")
        sw = _Switch()
        r.switch = sw
        await r.start()
        await asyncio.sleep(0.06)
        crawled = list(sw.dialed)
        p = _Peer(50)
        sw.peers[p.id] = p
        r.add_peer(p)
        vetted_inbound = book.is_good(p.id)
        await asyncio.sleep(0.12)
        po = _Peer(51, outbound=True)
        sw.peers[po.id] = po
        r.add_peer(po)
        await r.stop()
        return (bool(crawled), p.sent, vetted_inbound, p.id in sw.stopped,
                book.is_good(po.id), po.sent)

    j, p = run(scenario("jax")), run(scenario("port"))
    assert j == p
    assert j[0] and j[1] and b"pex_req" in j[1][0][1]
    assert j[2] is False and j[3] is True and j[4] is True


def test_ensure_peers_match():
    """Under-connected: ask one connected peer (chosen by the generator)
    and dial picks from the book, the same in both packages."""
    async def scenario(pkg):
        r, book = _reactor(pkg, 21, max_outbound=4)
        sw = _Switch()
        r.switch = sw
        for i in range(12):
            book.add(nid(i), f"13.{i}.0.1:26656", persist=False)
        for i in (3, 7):
            p = _Peer(i, outbound=True)
            sw.peers[p.id] = p
        r._ensure_peers()
        await asyncio.sleep(0.01)
        return (sorted(sw.dialed), [p.sent for p in sw.peers.values()],
                sorted(r._requested))

    j, p = run(scenario("jax")), run(scenario("port"))
    assert j == p and len(j[0]) == 2


def _jax_config():
    from cometbft_tpu.config import Config as JConfig
    from cometbft_tpu.config import test_consensus_config as j_tcc

    cfg = JConfig(consensus=j_tcc())
    cfg.p2p.laddr = "tcp://127.0.0.1:0"
    cfg.p2p.pex = True
    cfg.p2p.pex_interval_seconds = 0.5
    cfg.rpc.laddr = ""
    cfg.rpc.overload_shed_lag_s = 0
    cfg.base.signature_backend = "cpu"
    cfg.base.device_warmup = False
    cfg.instrumentation.loop_stall_threshold_s = 0
    cfg.instrumentation.watchdog_stall_threshold_s = 0
    return cfg


def _port_config():
    from cometbft_tpu_torch.config import Config

    cfg = Config()
    cfg.base.device = "cpu"
    cfg.p2p.laddr = "tcp://127.0.0.1:0"
    cfg.p2p.pex = True
    cfg.p2p.pex_interval_seconds = 0.5
    cfg.rpc.laddr = ""
    return cfg


def test_port_node_finds_a_third_peer_through_a_jax_node():
    """Port A dials JAX B, port C dials B; pex connects A and C with no
    dial from the test, and A's book holds C (tests/test_pex.py).  The
    set's one validator is held by no node, so no consensus runs."""
    from cometbft_tpu.abci.kvstore import KVStoreApplication as JKV
    from cometbft_tpu.node import Node as JNode
    from cometbft_tpu.p2p import NodeKey as JNodeKey
    from cometbft_tpu.types.genesis import GenesisDoc as JGenesis
    from cometbft_tpu.types.genesis import GenesisValidator as JGenVal
    from cometbft_tpu.types.priv_validator import MockPV as JMockPV
    from cometbft_tpu_torch.abci.kvstore import KVStoreApplication
    from cometbft_tpu_torch.node import Node
    from cometbft_tpu_torch.p2p import NodeKey
    from cometbft_tpu_torch.types.genesis import (GenesisDoc,
                                                  GenesisValidator)
    from cometbft_tpu_torch.types.priv_validator import MockPV

    async def main():
        pv, jpv = MockPV.from_secret(b"px-v"), JMockPV.from_secret(b"px-v")
        doc = GenesisDoc(chain_id="pex-net", validators=[
            GenesisValidator(pv.get_pub_key(), 10)])
        jdoc = JGenesis(chain_id="pex-net", validators=[
            JGenVal(jpv.get_pub_key(), 10)])
        a = await Node.create(doc, KVStoreApplication(device="cpu"),
                              config=_port_config(),
                              node_key=NodeKey.from_secret(b"px-a"),
                              name="pxa")
        b = await JNode.create(jdoc, JKV(), config=_jax_config(),
                               node_key=JNodeKey.from_secret(b"px-b"),
                               name="pxb")
        c = await Node.create(doc, KVStoreApplication(device="cpu"),
                              config=_port_config(),
                              node_key=NodeKey.from_secret(b"px-c"),
                              name="pxc")
        nodes = [a, b, c]
        try:
            for n in nodes:
                await n.start()
            await a.dial_peer(b.listen_addr, persistent=False)
            await c.dial_peer(b.listen_addr, persistent=False)
            cid = c.node_key.id

            async def connected():
                while cid not in a.switch.peers:
                    await asyncio.sleep(0.05)

            await asyncio.wait_for(connected(), 25)
            assert any(i == cid for i, _ in a.addr_book.sample(100))
            assert a.addr_book.is_good(b.node_key.id)
        finally:
            for n in nodes:
                await n.stop()

    run(main())
