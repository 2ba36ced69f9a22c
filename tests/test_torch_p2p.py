"""The port's p2p layer (``cometbft_tpu_torch/p2p``) against the JAX
package's over real loopback TCP, on the CPU: a port ``SecretConnection``
and a JAX one complete the handshake in both roles, exchange frames and
detect tampering; ``MConnection`` multiplexing and reassembly across
the packages; a port switch and a JAX switch connect and broadcast, and
a switch on another network is refused; ``NodeInfo`` bytes are equal.
The port checks a peer's challenge signature on its device (the plain
versions here), never on the host: the oracle is patched to raise.
Also the cases of ``tests/test_flowrate.py`` and the scorer cases of
``tests/test_peer_quality.py`` that need no address book, on the port's
``Monitor`` and ``PeerScorer`` beside the JAX package's."""

import asyncio
import time

import numpy as np
import pytest
import torch

from cometbft_tpu.crypto.keys import Ed25519PrivKey as JPriv
from cometbft_tpu.libs.flowrate import Monitor as JMonitor
from cometbft_tpu.p2p import ChannelDescriptor as JDesc
from cometbft_tpu.p2p import NodeInfo as JNodeInfo
from cometbft_tpu.p2p import NodeKey as JNodeKey
from cometbft_tpu.p2p import Reactor as JReactor
from cometbft_tpu.p2p import Switch as JSwitch
from cometbft_tpu.p2p import Transport as JTransport
from cometbft_tpu.p2p import secret_connection as jsc
from cometbft_tpu.p2p.conn import MConnection as JMConn
from cometbft_tpu.p2p.quality import PeerScorer as JScorer
from cometbft_tpu_torch.crypto import _ed25519_py as ref
from cometbft_tpu_torch.crypto.keys import Ed25519PrivKey
from cometbft_tpu_torch.libs.flowrate import Monitor
from cometbft_tpu_torch.p2p import (ChannelDescriptor, NodeInfo, NodeKey,
                                    Reactor, Switch, Transport)
from cometbft_tpu_torch.p2p import secret_connection as psc
from cometbft_tpu_torch.p2p.conn import MConnection
from cometbft_tpu_torch.p2p.node_info import NodeInfoError
from cometbft_tpu_torch.p2p.quality import PeerScorer

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
        raise AssertionError("host oracle called on the p2p path")

    monkeypatch.setattr(ref, "verify_zip215", refuse)


async def _tcp_pair():
    accepted = asyncio.get_running_loop().create_future()

    async def on_conn(r, w):
        accepted.set_result((r, w))

    server = await asyncio.start_server(on_conn, "127.0.0.1", 0)
    host, port = server.sockets[0].getsockname()[:2]
    r1, w1 = await asyncio.open_connection(host, port)
    r2, w2 = await accepted
    return server, (r1, w1), (r2, w2)


async def _handshake_pair(port_dials: bool, secrets=(b"p", b"j")):
    """(port conn, JAX conn, server, port writer, JAX writer) after a
    handshake; the port side dials when ``port_dials``."""
    server, a, b = await _tcp_pair()
    (pr, pw), (jr, jw) = (a, b) if port_dials else (b, a)
    pk = Ed25519PrivKey.from_secret(secrets[0])
    jk = JPriv.from_secret(secrets[1])
    pc, jc = await asyncio.gather(psc.handshake(pr, pw, pk, "cpu"),
                                  jsc.handshake(jr, jw, jk))
    assert pc.remote_pub_key.bytes() == jk.pub_key().bytes()
    assert jc.remote_pub_key.bytes() == pk.pub_key().bytes()
    return pc, jc, server, pw, jw


# ------------------------------------------------------ secret connection

@pytest.mark.parametrize("port_dials", [True, False])
def test_secret_connection_interop(port_dials):
    async def main():
        before = psc.HANDSHAKE_CHECKS["cpu"]
        pc, jc, server, _, _ = await _handshake_pair(port_dials)
        assert psc.HANDSHAKE_CHECKS["cpu"] == before + 1
        rng = np.random.default_rng(11)
        big = rng.integers(0, 256, 10240, dtype=np.uint8).tobytes()
        await pc.write_msg(b"hello")
        await jc.write_msg(big)
        assert await jc.read_msg() == b"hello"
        assert await pc.read_msg() == big
        await jc.write_msg(b"")
        await pc.write_msg(big[:1022])
        assert await pc.read_msg() == b""
        assert await jc.read_msg() == big[:1022]
        pc.close(), jc.close()
        server.close()

    run(main())


@pytest.mark.parametrize("port_sends", [True, False])
def test_secret_connection_tamper_detected(port_sends):
    async def main():
        pc, jc, server, pw, jw = await _handshake_pair(port_sends)
        sender, receiver, w = (pc, jc, pw) if port_sends else (jc, pc, jw)
        orig = w.write

        def corrupt(data):
            b = bytearray(data)
            b[5] ^= 0x01
            orig(bytes(b))

        w.write = corrupt
        await sender.write_msg(b"attack at dawn")
        err = jsc.SecretConnectionError if port_sends \
            else psc.SecretConnectionError
        with pytest.raises(err):
            await receiver.read_msg()
        pc.close(), jc.close()
        server.close()

    run(main())


def test_bad_challenge_signature_refused_on_device(monkeypatch):
    """A JAX peer whose challenge signature is wrong is refused by the
    port's device check."""
    jk = JPriv.from_secret(b"liar")
    real = type(jk).sign

    def bad_sign(self, msg):
        sig = bytearray(real(self, msg))
        sig[3] ^= 1
        return bytes(sig)

    monkeypatch.setattr(type(jk), "sign", bad_sign)

    async def main():
        server, (pr, pw), (jr, jw) = await _tcp_pair()
        pk = Ed25519PrivKey.from_secret(b"honest")
        res = await asyncio.gather(psc.handshake(pr, pw, pk, "cpu"),
                                   jsc.handshake(jr, jw, jk),
                                   return_exceptions=True)
        assert isinstance(res[0], psc.SecretConnectionError)
        pw.close(), jw.close()
        server.close()

    run(main())


# ------------------------------------------------------------ mconnection

@pytest.mark.parametrize("port_dials", [True, False])
def test_mconnection_multiplex_and_reassembly(port_dials):
    async def main():
        pc, jc, server, _, _ = await _handshake_pair(port_dials)
        got_p, got_j = [], []
        pm = MConnection(pc, [ChannelDescriptor(0x20, priority=5),
                              ChannelDescriptor(0x30, priority=1)],
                         lambda ch, m: got_p.append((ch, m)),
                         lambda e: got_p.append(("err", e)))
        jm = JMConn(jc, [JDesc(0x20, priority=5), JDesc(0x30, priority=1)],
                    lambda ch, m: got_j.append((ch, m)),
                    lambda e: got_j.append(("err", e)))
        pm.start(), jm.start()
        rng = np.random.default_rng(5)
        big = rng.integers(0, 256, 5000, dtype=np.uint8).tobytes()
        assert pm.send(0x20, b"vote") and pm.send(0x30, big)
        assert jm.send(0x30, b"tx1") and jm.send(0x20, big[::-1])
        assert not pm.send(0x99, b"nope")
        for _ in range(300):
            if len(got_j) >= 2 and len(got_p) >= 2:
                break
            await asyncio.sleep(0.01)
        assert sorted(got_j) == sorted([(0x20, b"vote"), (0x30, big)])
        assert sorted(got_p) == sorted([(0x30, b"tx1"),
                                        (0x20, big[::-1])])
        tel = pm.telemetry()
        assert tel["channels"]["0x30"]["sent_bytes"] == len(big)
        assert tel["channels"]["0x20"]["recv_msgs"] == 1
        assert tel["send_bytes_total"] > len(big)
        await pm.stop(), await jm.stop()
        server.close()

    run(main())


# ---------------------------------------------------------------- switch

class _Echo:
    CHAN = 0x42

    def __init__(self):
        super().__init__()
        self.received, self.peers = [], []

    def get_channels(self):
        return [self.DESC(self.CHAN, priority=3)]

    def add_peer(self, peer):
        self.peers.append(peer)

    def receive(self, chan, peer, msg):
        self.received.append((peer.id, msg))
        if msg.startswith(b"ping:"):
            peer.send(chan, b"echo:" + msg[5:])


class PortEcho(_Echo, Reactor):
    DESC = ChannelDescriptor


class JaxEcho(_Echo, JReactor):
    DESC = JDesc


def _switch(port: bool, network: str, secret: bytes):
    Key, Info, Tr, Sw = (NodeKey, NodeInfo, Transport, Switch) if port \
        else (JNodeKey, JNodeInfo, JTransport, JSwitch)
    nk = Key.from_secret(secret)
    box = {}

    def node_info():
        return Info(node_id=nk.id, listen_addr=box.get("addr", ""),
                    network=network, channels=box["sw"].channel_ids)

    tr = Tr(nk, node_info, device="cpu") if port else Tr(nk, node_info)
    sw = Sw(tr)
    box["sw"] = sw
    echo = PortEcho() if port else JaxEcho()
    sw.add_reactor("echo", echo)

    async def listen():
        box["addr"] = await tr.listen("127.0.0.1", 0)
        return box["addr"]

    return sw, echo, listen


async def _until(cond, n=300):
    for _ in range(n):
        if cond():
            return True
        await asyncio.sleep(0.01)
    return False


@pytest.mark.parametrize("port_dials", [True, False])
def test_switch_interop_connect_and_broadcast(port_dials):
    async def main():
        psw, pe, plisten = _switch(True, "net1", b"sw-port")
        jsw, je, jlisten = _switch(False, "net1", b"sw-jax")
        paddr, jaddr = await plisten(), await jlisten()
        await psw.start(), await jsw.start()
        try:
            if port_dials:
                await psw.dial_peer(jaddr)
            else:
                await jsw.dial_peer(paddr)
            assert await _until(lambda: psw.n_peers() == 1
                                and jsw.n_peers() == 1)
            psw.peers[jsw.transport.node_key.id].send(_Echo.CHAN,
                                                      b"ping:port")
            jsw.peers[psw.transport.node_key.id].send(_Echo.CHAN,
                                                      b"ping:jax")
            assert await _until(lambda: len(pe.received) >= 2
                                and len(je.received) >= 2)
            assert (jsw.transport.node_key.id, b"echo:port") in pe.received
            assert (psw.transport.node_key.id, b"echo:jax") in je.received
            psw.broadcast(_Echo.CHAN, b"announce-port")
            jsw.broadcast(_Echo.CHAN, b"announce-jax")
            assert await _until(
                lambda: any(m == b"announce-port" for _, m in je.received)
                and any(m == b"announce-jax" for _, m in pe.received))
        finally:
            await psw.stop(), await jsw.stop()
        assert psw.n_peers() == 0

    run(main())


@pytest.mark.parametrize("jax_peer", [True, False])
def test_switch_rejects_wrong_network(jax_peer):
    async def main():
        psw, _, plisten = _switch(True, "chain-A", b"swa")
        other, _, olisten = _switch(not jax_peer, "chain-B", b"swb")
        paddr = await plisten()
        oaddr = await olisten()
        await psw.start(), await other.start()
        try:
            with pytest.raises(Exception):
                await psw.dial_peer(oaddr)
            with pytest.raises(Exception):
                await other.dial_peer(paddr)
            await asyncio.sleep(0.05)
            assert psw.n_peers() == 0 and other.n_peers() == 0
        finally:
            await psw.stop(), await other.stop()

    run(main())


def test_transport_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError):
        Transport(NodeKey.from_secret(b"x"), lambda: None)


# --------------------------------------------------------------- node info

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_node_info_bytes_equal(seed):
    rng = np.random.default_rng(seed)
    kw = dict(node_id=rng.integers(0, 256, 20, dtype=np.uint8).tobytes()
              .hex(), listen_addr=f"127.0.0.1:{int(rng.integers(1, 65535))}",
              network=f"net-{seed}", moniker="m" * int(rng.integers(0, 40)),
              channels=bytes(sorted({int(x) for x in
                                     rng.integers(0, 256, 9)})))
    ours, theirs = NodeInfo(**kw), JNodeInfo(**kw)
    assert ours.encode() == theirs.encode()
    assert NodeInfo.decode(theirs.encode()) == ours
    assert JNodeInfo.decode(ours.encode()) == theirs
    ours.validate_basic()
    with pytest.raises(NodeInfoError):
        ours.compatible_with(NodeInfo(**dict(kw, network="other")))
    with pytest.raises(NodeInfoError):
        NodeInfo.decode(b"\xc1")


def test_node_key_files_equal(tmp_path):
    nk = NodeKey.from_secret(b"keyfile")
    nk.save(str(tmp_path / "port.json"))
    JNodeKey.from_secret(b"keyfile").save(str(tmp_path / "jax.json"))
    assert (tmp_path / "port.json").read_bytes() == \
        (tmp_path / "jax.json").read_bytes()
    assert JNodeKey.load(str(tmp_path / "port.json")).id == nk.id
    assert NodeKey.load(str(tmp_path / "jax.json")).id == nk.id


# ---------------------------------------------------------------- flowrate

PERIOD = 0.125
STEP = 1 / 64


class FakeClock:
    def __init__(self, t=1024.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


@pytest.fixture(params=["port", "jax"])
def monitor(request):
    cls = Monitor if request.param == "port" else JMonitor

    def make(alpha=0.25):
        clk = FakeClock()
        return cls(sample_period=PERIOD, ema_alpha=alpha, now=clk), clk

    return make


def test_ema_converges_to_steady_rate(monitor):
    m, clk = monitor()
    for _ in range(60):
        clk.advance(PERIOD)
        m.update(1000)
    assert m.rate == pytest.approx(8000, rel=0.01)
    assert m.total == 60_000


def test_ema_window_sub_period_updates_accumulate(monitor):
    a, clk_a = monitor()
    for _ in range(8):
        clk_a.advance(STEP)
        a.update(125)
    b, clk_b = monitor()
    clk_b.advance(PERIOD)
    b.update(1000)
    assert a._rate == b._rate
    assert a.rate == pytest.approx(b.rate)


def test_ema_weights_recent_samples(monitor):
    m, clk = monitor()
    for _ in range(40):
        clk.advance(PERIOD)
        m.update(10_000)
    fast = m.rate
    for _ in range(5):
        clk.advance(PERIOD)
        m.update(100)
    assert 800 < m.rate < fast * 0.3


def test_idle_decay_converges_to_zero(monitor):
    m, clk = monitor()
    for _ in range(40):
        clk.advance(PERIOD)
        m.update(10_000)
    busy = m.rate
    assert busy == pytest.approx(80_000, rel=0.05)
    clk.advance(5 * PERIOD)
    idle5 = m.rate
    assert idle5 < busy * 0.5
    assert m.rate == pytest.approx(idle5)
    clk.advance(45 * PERIOD)
    assert m.rate < busy * 0.001
    for _ in range(40):
        clk.advance(PERIOD)
        m.update(10_000)
    assert m.rate == pytest.approx(80_000, rel=0.05)


def test_rate_inside_first_period_is_last_ema(monitor):
    m, clk = monitor()
    clk.advance(PERIOD)
    m.update(1000)
    ema = m._rate
    clk.advance(PERIOD / 2)
    assert m.rate == ema


def test_limit_at_startup_grants_one_period_burst(monitor):
    m, _ = monitor()
    assert m.limit(500, 10_000) == 500
    assert m.limit(5000, 10_000) == 1250
    assert m.limit(12345, None) == 12345
    assert m.limit(12345, 0) == 12345


def test_limit_enforces_average_rate(monitor):
    m, clk = monitor()
    sent = 0
    for _ in range(1000):
        allowed = m.limit(400, 10_000)
        if allowed:
            m.update(allowed)
            sent += allowed
        clk.advance(STEP)
    elapsed = 1000 * STEP
    assert sent <= 10_000 * (elapsed + PERIOD) + 400
    assert sent >= 10_000 * elapsed * 0.9


def test_update_at_exact_period_boundary(monitor):
    m, clk = monitor()
    clk.advance(PERIOD)
    m.update(300)
    assert m._sample_bytes == 0
    assert m._rate == pytest.approx(0.25 * (300 / PERIOD))


def test_status_reports_totals_and_decayed_rate(monitor):
    m, clk = monitor()
    clk.advance(PERIOD)
    m.update(1000)
    clk.advance(1.0 - PERIOD)
    st = m.status()
    assert st["bytes"] == 1000
    assert st["duration_s"] == pytest.approx(1.0)
    assert st["avg_rate"] == pytest.approx(1000.0)
    assert st["inst_rate"] == m.rate


@pytest.mark.parametrize("seed", [0, 1])
def test_monitor_trace_matches_jax(seed):
    """A seeded random trace of updates, reads and limits gives equal
    numbers on the two packages' monitors."""
    rng = np.random.default_rng(seed)
    ca, cb = FakeClock(), FakeClock()
    a = Monitor(sample_period=PERIOD, now=ca)
    b = JMonitor(sample_period=PERIOD, now=cb)
    for _ in range(400):
        dt = float(rng.integers(0, 16)) * STEP
        ca.advance(dt), cb.advance(dt)
        n = int(rng.integers(0, 3000))
        a.update(n), b.update(n)
        assert a.rate == b.rate and a.total == b.total
        assert a.limit(n, 20_000) == b.limit(n, 20_000)
        assert a.status() == b.status()


# ------------------------------------------------------------------ scorer

@pytest.fixture(params=["port", "jax"])
def scorer(request):
    return PeerScorer if request.param == "port" else JScorer


def test_scorer_thresholds_and_actions(scorer):
    s = scorer(disconnect_score=5.0, ban_score=10.0, half_life_s=1000.0,
               ban_ttl_s=5.0)
    assert s.report("p1", "invalid_vote") is None
    assert s.report("p1", "invalid_vote") is None
    assert s.report("p1", "invalid_vote") == "disconnect"
    assert s.score("p1") == pytest.approx(6.0, rel=0.01)
    assert s.report("p2", "bad_block") == "disconnect"
    assert s.report("p2", "bad_block") == "ban"
    assert s.is_banned("p2")
    assert not s.is_banned("p1")
    assert s.score("p2") == 0.0


def test_scorer_decay(scorer):
    s = scorer(disconnect_score=5.0, ban_score=10.0, half_life_s=0.05)
    s.report("p1", "invalid_vote")
    s.report("p1", "invalid_vote")
    assert s.score("p1") > 3.0
    time.sleep(0.12)
    assert s.score("p1") < 1.5
    assert s.report("p1", "invalid_vote") is None


def test_scorer_ban_ttl_escalates_per_repeat(scorer):
    s = scorer(disconnect_score=5.0, ban_score=5.0, half_life_s=1000.0,
               ban_ttl_s=10.0, ban_ttl_max_s=25.0)
    for ttl in (10.0, 20.0, 25.0):
        assert s.report("p1", "bad_block") == "ban"
        assert s._bans["p1"]["ttl_s"] == ttl
    assert s.peer_info("p1")["ban_count"] == 3
    bans = s.bans_snapshot()
    assert bans and bans[0]["node_id"] == "p1"


def test_scorer_persistent_peers_never_banned(scorer):
    s = scorer(disconnect_score=2.0, ban_score=4.0, half_life_s=1000.0)
    for _ in range(10):
        assert s.report("pin", "bad_block", persistent=True) == "disconnect"
    assert not s.is_banned("pin")


def test_scorer_unknown_event_and_ledger_bound(scorer):
    s = scorer(half_life_s=1000.0, max_tracked=4)
    s.report("px", "brand_new_event")
    assert s.score("px") == pytest.approx(1.0, rel=0.01)
    for i in range(10):
        s.report(f"peer-{i}", "invalid_tx")
    assert len(s._peers) <= 4
