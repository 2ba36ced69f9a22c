"""The port's connection fuzzer (``cometbft_tpu_torch/p2p/fuzz.py``)
against the JAX package's, on the CPU: for one ``fuzz_seed`` the same
drop, delay and kill decisions over the same IO (the delays recorded,
not slept), over the decision routine and over real loopback sockets;
the cases of ``tests/test_fuzz.py::test_fuzzed_connection_drop_and_kill``
on both packages; a fuzzed port transport handshaking with a JAX one;
and ``p2p.test_fuzz`` reaching the port node's transport."""

import asyncio

import numpy as np
import pytest
import torch

from cometbft_tpu.libs import clock as jclock
from cometbft_tpu.p2p import fuzz as jfuzz
from cometbft_tpu_torch.crypto import _ed25519_py as ref
from cometbft_tpu_torch.libs import clock as pclock
from cometbft_tpu_torch.p2p import fuzz as pfuzz

torch.set_num_threads(1)

pytestmark = pytest.mark.timeout(60)


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


@pytest.fixture
def recorded_sleeps(monkeypatch):
    """Both packages' clock sleeps recorded, not slept."""
    slept = {"jax": [], "port": []}

    def rec(key):
        async def sleep(delay, result=None):
            slept[key].append(delay)
            return result
        return sleep

    monkeypatch.setattr(jclock, "sleep", rec("jax"))
    monkeypatch.setattr(pclock, "sleep", rec("port"))
    return slept


class _W:
    def __init__(self):
        self.closed = 0

    def close(self):
        self.closed += 1


CASES = [
    dict(mode="drop", prob_drop_rw=0.01),                 # the defaults
    dict(mode="drop", prob_drop_rw=0.2, prob_drop_conn=0.1,
         prob_sleep=0.3, max_delay_s=0.5),
    dict(mode="delay", max_delay_s=3.0),
    dict(mode="drop", prob_drop_rw=0.0, prob_drop_conn=0.0,
         prob_sleep=1.0, max_delay_s=1.0),
]


@pytest.mark.parametrize("case", range(len(CASES)))
def test_same_seed_same_decisions(case, recorded_sleeps):
    """2,000 writes and 500 reads through each package's fuzzer under
    seeds from numpy: the swallowed writes, the kills, the delays (to
    the bit) and the decision stream's next draw are equal."""
    seeds = np.random.default_rng(40 + case).integers(0, 2**31, 3)

    async def drive(mod):
        out = []
        for seed in seeds:
            cfg = mod.FuzzConnConfig(start_after_s=0.0, seed=int(seed),
                                     **CASES[case])
            w = _W()
            fz = mod._Fuzzer(cfg, w)
            reader = mod.FuzzedReader(_Reader(), fz)
            swallowed = []
            for i in range(2000):
                swallowed.append(await fz.fuzz())
                if i % 4 == 0:
                    await reader.readexactly(3)
            out.append((swallowed, w.closed, cfg.rng.random()))
        return out

    j = run(drive(jfuzz))
    p = run(drive(pfuzz))
    assert j == p
    assert recorded_sleeps["jax"] == recorded_sleeps["port"]


class _Reader:
    async def readexactly(self, n):
        return b"x" * n


def test_counts_by_kind(recorded_sleeps):
    """The port config's tallies add up to its decisions."""
    cfg = pfuzz.FuzzConnConfig(prob_drop_rw=0.2, prob_drop_conn=0.1,
                               prob_sleep=0.3, seed=7)
    w = _W()
    fz = pfuzz._Fuzzer(cfg, w)
    swallowed = [run(fz.fuzz()) for _ in range(500)]
    c = cfg.counts
    assert c["drop"] + c["kill"] == sum(swallowed)
    assert c["kill"] == w.closed
    assert sum(c.values()) == 500
    assert len(recorded_sleeps["port"]) == c["delay"]


def test_not_active_before_start_after(recorded_sleeps):
    for mod in (jfuzz, pfuzz):
        cfg = mod.FuzzConnConfig(prob_drop_rw=1.0, start_after_s=3600.0)
        fz = mod._Fuzzer(cfg, _W())
        assert run(fz.fuzz()) is False


async def _pair():
    q = asyncio.Queue()

    async def on_conn(r, w):
        await q.put((r, w))

    server = await asyncio.start_server(on_conn, "127.0.0.1", 0)
    host, port = server.sockets[0].getsockname()[:2]
    cr, cw = await asyncio.open_connection(host, port)
    sr, sw = await q.get()
    return server, (cr, cw), (sr, sw)


@pytest.mark.parametrize("mod", [jfuzz, pfuzz], ids=["jax", "port"])
def test_fuzzed_connection_drop_and_kill(mod):
    """Dropped writes are swallowed whole, prob_drop_conn kills the
    stream, delay mode only slows IO down (tests/test_fuzz.py)."""
    async def main():
        server, (cr, cw), (sr, sw) = await _pair()
        fr, fw = mod.fuzz_streams(cr, cw, mod.FuzzConnConfig(
            prob_drop_rw=1.0, start_after_s=0.0, seed=1))
        fw.write(b"swallowed")
        await fw.drain()
        with pytest.raises(asyncio.TimeoutError):
            await asyncio.wait_for(sr.readexactly(9), 0.3)
        server.close()

        server, (cr, cw), (sr, sw) = await _pair()
        fr, fw = mod.fuzz_streams(cr, cw, mod.FuzzConnConfig(
            prob_drop_rw=0.0, prob_drop_conn=1.0, start_after_s=0.0,
            seed=2))
        fw.write(b"x")
        await fw.drain()
        assert await sr.read(16) == b""
        server.close()

        server, (cr, cw), (sr, sw) = await _pair()
        fr, fw = mod.fuzz_streams(cr, cw, mod.FuzzConnConfig(
            mode=mod.MODE_DELAY, max_delay_s=0.02, start_after_s=0.0,
            seed=3))
        for _ in range(5):
            fw.write(b"abc")
            await fw.drain()
        assert await sr.readexactly(15) == b"abc" * 5
        sw.close(), cw.close(), server.close()

    run(main())


def test_same_bytes_reach_the_peer():
    """Over real sockets, 300 seeded writes through each package's
    fuzzed writer (drop mode, 10% drops): the peer reads the same bytes."""
    rng = np.random.default_rng(7)
    msgs = [rng.bytes(int(rng.integers(1, 60))) for _ in range(300)]

    async def main(mod):
        server, (cr, cw), (sr, sw) = await _pair()
        fr, fw = mod.fuzz_streams(cr, cw, mod.FuzzConnConfig(
            prob_drop_rw=0.1, start_after_s=0.0, seed=11))
        for m in msgs:
            fw.write(m)
            await fw.drain()
        fw.close()
        got = await sr.read()
        server.close()
        return got

    j, p = run(main(jfuzz)), run(main(pfuzz))
    assert j == p and 0 < len(p) < sum(map(len, msgs))


def test_fuzzed_port_transport_handshakes_with_jax():
    """A port transport with a fuzz config (delay mode) dials a JAX
    transport and the reverse: the upgrade completes through the fuzzed
    streams, and the port's challenge check runs on its device."""
    from cometbft_tpu.p2p import NodeInfo as JNodeInfo
    from cometbft_tpu.p2p import NodeKey as JNodeKey
    from cometbft_tpu.p2p import Transport as JTransport
    from cometbft_tpu_torch.p2p import NodeInfo, NodeKey, Transport

    async def main():
        pk, jk = NodeKey.from_secret(b"fz-p"), JNodeKey.from_secret(b"fz-j")
        fc = pfuzz.FuzzConnConfig(mode=pfuzz.MODE_DELAY, max_delay_s=0.01,
                                  start_after_s=0.0, seed=5)
        pt = Transport(pk, lambda: NodeInfo(
            node_id=pk.id, listen_addr=pt.listen_addr or "",
            network="fz", channels=b"\x20", moniker="p"), device="cpu",
            fuzz_config=fc)
        jt = JTransport(jk, lambda: JNodeInfo(
            node_id=jk.id, listen_addr=jt.listen_addr or "",
            network="fz", channels=b"\x20", moniker="j"))
        got = asyncio.get_running_loop().create_future()

        async def on_accept(conn, ni):
            got.set_result((conn, ni))

        jt.on_accept = on_accept
        await jt.listen("127.0.0.1", 0)
        conn, ni = await pt.dial(jt.listen_addr)
        assert ni.node_id == jk.id
        jconn, jni = await asyncio.wait_for(got, 10)
        assert jni.node_id == pk.id
        assert isinstance(conn._writer, pfuzz.FuzzedWriter)
        assert fc.counts["delay"] > 0
        conn.close(), jconn.close()
        await jt.close()

    run(main())


def test_node_test_fuzz_reaches_the_transport():
    """``p2p.test_fuzz`` and the ``fuzz_*`` fields become the port
    transport's FuzzConnConfig, as in the JAX node."""
    from cometbft_tpu_torch.abci.kvstore import KVStoreApplication
    from cometbft_tpu_torch.config import Config
    from cometbft_tpu_torch.node import Node
    from cometbft_tpu_torch.types.genesis import (GenesisDoc,
                                                  GenesisValidator)
    from cometbft_tpu_torch.types.priv_validator import MockPV

    async def main():
        pv = MockPV.from_secret(b"fz-node")
        doc = GenesisDoc(chain_id="fz", validators=[
            GenesisValidator(pv.get_pub_key(), 10)])
        cfg = Config()
        cfg.base.device = "cpu"
        cfg.p2p.test_fuzz = True
        cfg.p2p.fuzz_mode = "delay"
        cfg.p2p.fuzz_max_delay_s = 0.25
        cfg.p2p.fuzz_start_after_s = 5.0
        cfg.p2p.fuzz_seed = 99
        cfg.validate()
        node = await Node.create(doc, KVStoreApplication(device="cpu"),
                                 priv_validator=pv, config=cfg)
        try:
            fc = node.transport.fuzz_config
            assert isinstance(fc, pfuzz.FuzzConnConfig)
            assert (fc.mode, fc.max_delay_s, fc.start_after_s) == \
                ("delay", 0.25, 5.0)
            assert fc.rng.random() == pfuzz.FuzzConnConfig(
                seed=99).rng.random()
        finally:
            await node.stop()
        cfg.p2p.fuzz_mode = "sometimes"
        from cometbft_tpu_torch.config import ConfigError

        with pytest.raises(ConfigError):
            cfg.validate()

    run(main())
