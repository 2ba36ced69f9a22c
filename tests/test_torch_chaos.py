"""The port's fault plane (``cometbft_tpu_torch/libs/failures.py``) and
its MConnection sites against the JAX package's, on the CPU: the plane
cases of ``tests/test_chaos.py`` (triggers, same-seed event logs, spec
parsing, ``CMT_CHAOS`` over the ``[chaos]`` section, phased arm and
disarm) run on both planes with equal ``events()``, ``signature()`` and
``stats()``; the send and receive sites of a port MConnection talking
to a JAX one, armed on the sender's (or receiver's) plane, deliver the
same messages and log the same events as the JAX package's sites in the
other direction; ``node=<name>`` selects one node's links; armed
``p2p.fuzz.*`` sites override the fuzzer's draw; and the node arms the
plane from its config at create."""

import asyncio
import time

import numpy as np
import pytest
import torch

from cometbft_tpu.crypto.keys import Ed25519PrivKey as JPriv
from cometbft_tpu.libs import failures as JF
from cometbft_tpu.p2p import ChannelDescriptor as JDesc
from cometbft_tpu.p2p import secret_connection as jsc
from cometbft_tpu.p2p.conn import MConnection as JMConn
from cometbft_tpu_torch.crypto import _ed25519_py as ref
from cometbft_tpu_torch.crypto.keys import Ed25519PrivKey
from cometbft_tpu_torch.libs import failures as PF
from cometbft_tpu_torch.p2p import ChannelDescriptor
from cometbft_tpu_torch.p2p import secret_connection as psc
from cometbft_tpu_torch.p2p.conn import MConnection

torch.set_num_threads(1)

pytestmark = pytest.mark.timeout(60)

PLANES = {"jax": JF, "port": PF}


@pytest.fixture(autouse=True)
def _clean_planes(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("host oracle called on the p2p path")

    monkeypatch.setattr(ref, "verify_zip215", refuse)
    JF.reset(), PF.reset()
    yield
    JF.reset(), PF.reset()


def run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


def both(scenario):
    out = [scenario(F) for F in (JF, PF)]
    assert out[0] == out[1]
    return out[0]


# ------------------------------------------------------------ the plane


def test_disabled_plane_is_a_noop():
    def scenario(F):
        return (F.is_enabled(), F.fire("wal.fsync.eio"), F.events(),
                F.signature(), F.stats(), F.armed_prefix("wal."))

    assert both(scenario) == (False, None, [], [], {"enabled": False},
                              False)


def test_rule_triggers_at_count_every_after_max():
    def scenario(F):
        F.configure(enabled=True, seed=1, faults=[
            "a:at=2:at=5", "b:count=3", "c:every=3:max=2",
            "d:after=2:count=2"])
        fired = {s: [] for s in "abcd"}
        for n in range(1, 10):
            for s in "abcd":
                if F.fire(s) is not None:
                    fired[s].append(n)
        return fired, F.signature(), F.stats()

    fired, _, _ = both(scenario)
    assert fired == {"a": [2, 5], "b": [1, 2, 3], "c": [3, 6],
                     "d": [3, 4]}


@pytest.mark.parametrize("seed", [int(s) for s in
                                  np.random.default_rng(16).integers(
                                      0, 2**31, 4)])
def test_same_seed_same_event_log(seed):
    """Seeds from numpy: probabilistic, periodic and indexed sites with
    selectors and params give the same events, signature and stats on
    both planes, and a same-seed rerun reproduces them."""
    rng = np.random.default_rng(seed)
    calls = [("p.q", {}), ("r.s", {"chan": "vote"}),
             ("r.s", {"chan": "data"}), ("t.u", {"node": "v1"}),
             ("t.u", {"node": "v2"})]
    order = rng.integers(0, len(calls), 400)

    def scenario(F):
        def drive():
            F.configure(enabled=True, seed=seed, faults=[
                "p.q:prob=0.25:max=6", "r.s:every=7:chan=vote",
                "t.u:prob=0.5:node=v2:delay=2.5", "v.w:at=3"])
            fires = []
            for k in order:
                site, detail = calls[k]
                f = F.fire(site, **detail)
                fires.append(None if f is None else sorted(f.items()))
            return fires, F.events(), F.signature(), F.stats(), [
                F.site_rng("p.q").random() for _ in range(3)]

        first = drive()
        assert drive() == first
        return first

    out = both(scenario)
    assert out[2]


def test_fault_spec_parsing_and_errors():
    def scenario(F):
        r = F.parse_fault_spec("x:prob=0.5:max=3:delay=1.5:cut=header")
        out = [(r.site, r.prob, r.max_fires, r.params, r.selectors)]
        r = F.parse_fault_spec("p2p.send.drop:node=validator03:prob=1")
        out.append((r.site, r.prob, r.params, r.selectors))
        for bad in ("", "prob=1", "x:notakv", "x:prob=2", "x:at=abc"):
            with pytest.raises(F.FaultSpecError) as e:
                F.parse_fault_spec(bad)
            out.append(str(e.value))
        return out

    both(scenario)
    from cometbft_tpu_torch.config import Config, ConfigError

    cfg = Config()
    cfg.chaos.enable = True
    cfg.chaos.faults = ["x:prob=2"]
    with pytest.raises(ConfigError):
        cfg.validate()
    cfg.chaos.faults = ["p2p.send.drop:prob=0.5"]
    cfg.validate()


ENVS = ["seed=9;log=4096;wal.fsync.eio:at=2;p.q:prob=0.1",
        "p2p.send.drop:node=validator03;p2p.recv.drop:node=validator03",
        " seed=3 ; ;device.dispatch.hang:at=1:delay=9",
        "seed=1;bogus=3", "seed=1;a:at=1;a:at=2"]


@pytest.mark.parametrize("env", ENVS)
def test_cmt_chaos_parsed_alike(env, monkeypatch):
    """``CMT_CHAOS`` is parsed to the same plane, or the same error, and
    wins over a disabled ``[chaos]`` section; ``device.dispatch.*``
    specs are accepted and, with no caller, never fire."""
    from cometbft_tpu.config import ChaosConfig as JChaos
    from cometbft_tpu_torch.config import ChaosConfig

    monkeypatch.setenv(JF.ENV_VAR, env)
    assert JF.ENV_VAR == PF.ENV_VAR
    out = []
    for F, cfg in ((JF, JChaos()), (PF, ChaosConfig())):
        try:
            F.configure_from_config(cfg)
            out.append((F.is_enabled(), F.stats()))
        except F.FaultSpecError as e:
            out.append(("error", str(e)))
    assert out[0] == out[1]


def test_config_section_arms_the_plane(monkeypatch):
    from cometbft_tpu.config import ChaosConfig as JChaos
    from cometbft_tpu_torch.config import ChaosConfig

    monkeypatch.delenv(JF.ENV_VAR, raising=False)
    out = []
    for F, C in ((JF, JChaos), (PF, ChaosConfig)):
        F.configure_from_config(C())
        obs = [F.is_enabled()]
        F.configure_from_config(C(enable=True, seed=3,
                                  faults=["a.b:at=1"], log_size=64))
        obs += [F.is_enabled(), F.stats(), F.fire("a.b") is not None]
        out.append(obs)
    assert out[0] == out[1] == [False, True, {
        "enabled": True, "seed": 3, "sites": {"a.b": {"calls": 0,
                                                        "fired": 0}},
        "events": 0}, True]


def test_phased_arm_disarm_keeps_log_and_counters():
    def scenario(F):
        with pytest.raises(F.FaultSpecError):
            F.arm("a:at=1")                # no plane yet
        F.configure(enabled=True, seed=4, faults=["a:at=1"])
        obs = [F.fire("a") is not None]
        F.arm("b:at=2")
        with pytest.raises(F.FaultSpecError):
            F.arm("b:at=3")
        obs += [F.fire("b") is None, F.fire("b") is not None,
                F.armed_prefix("b"), F.armed_prefix("c")]
        F.disarm("b")
        obs += [F.fire("b") is None, F.armed_prefix("b"), F.signature(),
                F.stats()]
        return obs

    obs = both(scenario)
    assert obs[7] == [("a", 1, 1), ("b", 2, 1)]


# -------------------------------------------------------- MConnection sites


async def _mconn_pair(port_sends: bool):
    """A port and a JAX MConnection over a secret connection; returns
    (sender, receiver, delivered-to-receiver list, server)."""
    accepted = asyncio.get_running_loop().create_future()

    async def on_conn(r, w):
        accepted.set_result((r, w))

    server = await asyncio.start_server(on_conn, "127.0.0.1", 0)
    host, port = server.sockets[0].getsockname()[:2]
    r1, w1 = await asyncio.open_connection(host, port)
    r2, w2 = await accepted
    pc, jc = await asyncio.gather(
        psc.handshake(r1, w1, Ed25519PrivKey.from_secret(b"cp"), "cpu"),
        jsc.handshake(r2, w2, JPriv.from_secret(b"cj")))
    got_p, got_j = [], []
    pm = MConnection(pc, [ChannelDescriptor(0x20, name="vote"),
                          ChannelDescriptor(0x30, name="data")],
                     lambda ch, m: got_p.append((ch, m)),
                     lambda e: got_p.append(("err", repr(e))))
    jm = JMConn(jc, [JDesc(0x20, name="vote"), JDesc(0x30, name="data")],
                lambda ch, m: got_j.append((ch, m)),
                lambda e: got_j.append(("err", repr(e))))
    pm.start(), jm.start()
    if port_sends:
        return pm, jm, got_j, server
    return jm, pm, got_p, server


async def _until(cond, timeout=5.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, "condition never met"
        await asyncio.sleep(0.01)


def _events(F):
    return [(e["site"], e.get("chan"), e.get("node"), e["n"], e["fire"])
            for e in F.events()]


def _mconn_case(port_sends: bool, send_side: bool, specs, script):
    """Run ``script(send, got)`` over a port->JAX (or JAX->port) pair
    with ``specs`` armed on the sender's plane (``send_side``) or the
    receiver's; returns what arrived and the armed plane's events."""
    sender_pkg = "port" if port_sends else "jax"
    recv_pkg = "jax" if port_sends else "port"
    F = PLANES[sender_pkg if send_side else recv_pkg]

    async def main():
        snd, rcv, got, server = await _mconn_pair(port_sends)
        if send_side:
            snd.chaos_scope = "n1"
        else:
            rcv.chaos_scope = "n1"
        F.configure(enabled=True, seed=7, faults=list(specs))
        await script(snd, got)
        await snd.stop(), await rcv.stop()
        server.close()
        return list(got), _events(F)

    return run(main())


async def _drop_then_corrupt(snd, got):
    snd.send(0x20, b"swallowed")
    await asyncio.sleep(0.2)
    snd.send(0x20, b"alive")
    snd.send(0x30, b"data-1")
    await _until(lambda: len(got) >= 2)
    snd.send(0x20, b"corrupt-me")
    await _until(lambda: len(got) >= 3)


async def _dup_and_reorder(snd, got):
    snd.send(0x20, b"twice")
    await _until(lambda: len(got) >= 2)
    snd.send(0x20, b"A")
    snd.send(0x20, b"B")
    await _until(lambda: len(got) >= 4)
    snd.send(0x30, b"lonely")
    await _until(lambda: len(got) >= 5, timeout=3.0)


SEND_CASES = {
    "drop_corrupt": (["p2p.send.drop:at=1", "p2p.send.corrupt:at=3"],
                     _drop_then_corrupt),
    "dup_reorder": (["p2p.send.duplicate:at=1", "p2p.send.reorder:at=2",
                     "p2p.send.delay:at=3:delay=0.05"],
                    _dup_and_reorder),
}


@pytest.mark.parametrize("case", sorted(SEND_CASES))
def test_send_sites_match(case):
    """The port's send sites over port->JAX equal the JAX package's over
    JAX->port: what arrives, and the plane's events."""
    specs, script = SEND_CASES[case]
    p = _mconn_case(True, True, specs, script)
    j = _mconn_case(False, True, specs, script)
    assert p == j
    if case == "drop_corrupt":
        got = p[0]
        assert sorted(got[:2]) == [(0x20, b"alive"), (0x30, b"data-1")]
        assert len(got[2][1]) == len(b"corrupt-me") and \
            got[2][1] != b"corrupt-me"
    else:
        assert [m for _, m in p[0]] == [b"twice", b"twice", b"B", b"A",
                                        b"lonely"]


def test_recv_sites_match():
    """``p2p.recv.drop`` and ``p2p.recv.corrupt`` on the receiver's
    plane, JAX->port against port->JAX."""
    specs = ["p2p.recv.drop:at=1", "p2p.recv.corrupt:at=2:chan=vote"]
    p = _mconn_case(False, False, specs, _drop_then_corrupt)
    j = _mconn_case(True, False, specs, _drop_then_corrupt)
    assert p == j
    assert sorted(p[0][:2]) == [(0x20, b"alive"), (0x30, b"data-1")]
    assert p[0][2][1] != b"corrupt-me"


def test_node_selector_arms_one_nodes_links():
    """``node=validator03`` drops only the links scoped to validator03
    (the partition phase 17 of the smoke arms), on both planes."""
    async def script(snd, got):
        for i in range(5):
            snd.send(0x20, b"m%d" % i)
        await asyncio.sleep(0.3)

    specs = ["p2p.send.drop:node=validator03"]
    for scope, want in (("validator03", 0), ("validator01", 5)):
        outs = []
        for port_sends in (True, False):
            F = PF if port_sends else JF

            async def main():
                snd, rcv, got, server = await _mconn_pair(port_sends)
                snd.chaos_scope = scope
                F.configure(enabled=True, seed=1, faults=specs)
                await script(snd, got)
                await snd.stop(), await rcv.stop()
                server.close()
                return list(got), _events(F)

            outs.append(run(main()))
            F.reset()
        assert outs[0] == outs[1]
        assert len(outs[0][0]) == want


def test_fuzzer_routes_through_fault_plane():
    """Armed ``p2p.fuzz.*`` sites decide before the local draw, and log
    the same events on both planes."""
    from cometbft_tpu.p2p.fuzz import FuzzConnConfig as JFC
    from cometbft_tpu.p2p.fuzz import _Fuzzer as JFuzzer
    from cometbft_tpu_torch.p2p.fuzz import FuzzConnConfig, _Fuzzer

    class _W:
        closed = False

        def close(self):
            self.closed = True

    out = []
    for F, Fz, C in ((JF, JFuzzer, JFC), (PF, _Fuzzer, FuzzConnConfig)):
        F.configure(enabled=True, seed=5,
                    faults=["p2p.fuzz.drop:at=2", "p2p.fuzz.kill:at=3",
                            "p2p.fuzz.delay:at=4:delay=0.01"])
        w = _W()
        fz = Fz(C(prob_drop_rw=0.0, start_after_s=0.0, seed=1), w)
        res = [run(fz.fuzz()) for _ in range(5)]
        out.append((res, w.closed, _events(F)))
    assert out[0] == out[1]
    assert out[0][0] == [False, True, True, False, False] and out[0][1]


def test_node_arms_the_plane_at_create():
    """``config.chaos`` reaches the plane at ``Node.create``, before the
    stores open, as in the JAX node; the node's name scopes its links."""
    from cometbft_tpu_torch.abci.kvstore import KVStoreApplication
    from cometbft_tpu_torch.config import Config
    from cometbft_tpu_torch.node import Node
    from cometbft_tpu_torch.types.genesis import (GenesisDoc,
                                                  GenesisValidator)
    from cometbft_tpu_torch.types.priv_validator import MockPV

    async def main():
        pv = MockPV.from_secret(b"ch-node")
        doc = GenesisDoc(chain_id="ch", validators=[
            GenesisValidator(pv.get_pub_key(), 10)])
        cfg = Config()
        cfg.base.device = "cpu"
        cfg.chaos.enable = True
        cfg.chaos.seed = 11
        cfg.chaos.faults = ["p2p.send.drop:node=chaos01:prob=0.5"]
        node = await Node.create(doc, KVStoreApplication(device="cpu"),
                                 priv_validator=pv, config=cfg,
                                 name="chaos01")
        try:
            assert PF.is_enabled() and PF.stats()["seed"] == 11
            assert node.switch.chaos_scope == "chaos01"
        finally:
            await node.stop()

    run(main())
