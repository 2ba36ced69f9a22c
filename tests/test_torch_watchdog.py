"""The port's liveness watchdog (``cometbft_tpu_torch/node/watchdog.py``)
against the JAX package's, on the CPU: the cases of
``tests/test_watchdog.py`` run through both packages on the same stub
node, their incident bundles, listings and ``/dump_incidents`` answers
compared exactly (wall times and bundle names held equal by one clock);
the WAL tail over WALs of either package; and a port node with a home
that cannot commit (one of two validators), whose watchdog writes a
bundle that ``/dump_incidents`` lists and serves."""

import asyncio
import json
import os
from types import SimpleNamespace

import pytest

import cometbft_tpu.config as j_config
import cometbft_tpu.consensus.wal as j_wal
import cometbft_tpu.libs.clock as j_clock
import cometbft_tpu.node.watchdog as j_wd
import cometbft_tpu.rpc.core as j_core
import cometbft_tpu_torch.config as t_config
import cometbft_tpu_torch.consensus.wal as t_wal
import cometbft_tpu_torch.libs.clock as t_clock
import cometbft_tpu_torch.node.watchdog as t_wd
import cometbft_tpu_torch.rpc.core as t_core

from torch_node_fixtures import (genesis, make_node,  # noqa: F401
                                 no_host_verify)

pytestmark = pytest.mark.timeout(120)

JAX = SimpleNamespace(wd=j_wd, clock=j_clock, core=j_core, wal=j_wal,
                      config=j_config)
PORT = SimpleNamespace(wd=t_wd, clock=t_clock, core=t_core, wal=t_wal,
                       config=t_config)


def run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


class _Clock:
    """One fixed clock for both packages: bundle names and wall times
    come out equal."""

    def __init__(self):
        self.mono = 5000.0

    def monotonic(self):
        return self.mono

    def walltime_ns(self):
        return 1_800_000_000_000_000_000 + int(self.mono * 1e9)

    def monotonic_ns(self):
        return int(self.mono * 1e9)

    def walltime(self):
        return self.walltime_ns() / 1e9

    async def sleep(self, delay, result=None):
        await asyncio.sleep(0)
        return result

    async def wait_for(self, aw, timeout):
        return await asyncio.wait_for(aw, timeout)


@pytest.fixture
def clocks():
    clk = _Clock()
    for P in (JAX, PORT):
        P.clock.install(clk)
    yield clk
    for P in (JAX, PORT):
        P.clock.uninstall()


class _StubRS:
    height, round = 7, 2

    def step_name(self):
        return "Prevote"


class _StubConsensus:
    def __init__(self, step_age=999.0, commit_age_s=999.0):
        self.rs = _StubRS()
        self.fatal_error = None
        self.wal = None
        self._task = object()
        self._step_age = step_age
        self._now = 1_000_000 * 10**9
        self._last_commit_wall_ns = self._now - int(commit_age_s * 1e9)

    def step_age_s(self):
        return self._step_age

    def now_ns(self):
        return self._now


def _stub_node(step_age=999.0, peers_quiet_age=None, commit_age_s=999.0):
    switch = SimpleNamespace(
        peers={"p1": object()} if peers_quiet_age is not None else {},
        peer_snapshot=lambda: [{"node_id": "p1", "connection_status": {}}],
        quietest_peer_recv_age_s=lambda: peers_quiet_age,
        scorer=SimpleNamespace(snapshot=lambda: {"peers": {}, "bans": [],
                                                 "bans_total": 0}))
    return SimpleNamespace(
        name="stub", consensus=_StubConsensus(step_age, commit_age_s),
        switch=switch, block_store=SimpleNamespace(height=lambda: 7))


def _watchdog(P, node, root, **kw):
    kw.setdefault("stall_threshold_s", 1.0)
    kw.setdefault("check_interval_s", 0.05)
    kw.setdefault("min_interval_s", 60.0)
    d = os.path.join(str(root), P is JAX and "jax" or "port")
    os.makedirs(d, exist_ok=True)
    return P.wd.LivenessWatchdog(node, d, **kw)


SCENARIOS = {
    "stall_all_reasons": dict(node=dict(step_age=999.0,
                                        peers_quiet_age=500.0)),
    "no_stall": dict(node=dict(step_age=0.01, commit_age_s=0.0)),
    "unstarted": dict(node=dict(step_age=999.0), unstarted=True),
    "fatal_error": dict(node=dict(step_age=0.01, commit_age_s=0.0),
                        fatal=True),
    "rate_limit": dict(node=dict(step_age=999.0), checks=6,
                       wd=dict(min_interval_s=3600.0), advance=3601),
    "pruning": dict(node=dict(step_age=999.0), checks=6,
                    wd=dict(min_interval_s=0.0, max_bundles=3)),
}


@pytest.mark.parametrize("case", sorted(SCENARIOS))
def test_watchdog_scenarios_match_jax(case, tmp_path, clocks):
    spec = SCENARIOS[case]

    def scenario(P):
        node = _stub_node(**spec["node"])
        if spec.get("unstarted"):
            node.consensus._task = None
        if spec.get("fatal"):
            node.consensus.fatal_error = RuntimeError("boom")
        wd = _watchdog(P, node, tmp_path, **spec.get("wd", {}))
        paths = []
        for _ in range(spec.get("checks", 1)):
            paths.append(wd.check())
            clocks.mono += 1.0
        if spec.get("advance"):
            clocks.mono += spec["advance"]
            paths.append(wd.check())
        names = [os.path.basename(p) if p else None for p in paths]
        bundles = [json.load(open(p)) for p in paths
                   if p and os.path.exists(p)]
        listing = P.wd.list_incidents(wd.incident_dir)
        return dict(names=names, bundles=bundles, listing=listing,
                    trips=wd.trips, written=wd.bundles_written,
                    reasons=wd.last_reasons)

    j = scenario(JAX)
    clocks.mono = 5000.0
    t = scenario(PORT)
    assert t == j
    if case == "stall_all_reasons":
        b = t["bundles"][0]
        assert b["reasons"] == ["consensus_step_stalled",
                                "no_recent_commit", "peers_quiet"]
        assert b["consensus"]["step"] == "Prevote"
        assert b["wal_tail"] == [] and b["height"] == 7
    if case in ("no_stall", "unstarted"):
        assert t["names"] == [None] and t["trips"] == 0
    if case == "fatal_error":
        assert t["bundles"][0]["reasons"] == ["consensus_fatal_error"]
    if case == "rate_limit":
        assert t["trips"] == 7 and t["written"] == 2
    if case == "pruning":
        assert len(t["listing"]) == 3


def test_wal_tail_matches_jax_over_either_wal(tmp_path):
    """The tail of a rotated WAL, written by either package, read by
    either package's ``wal_tail``."""
    tails = []
    for writer in (JAX, PORT):
        wal = writer.wal.WAL(os.path.join(str(tmp_path), writer is JAX
                                          and "j" or "t", "cs.wal"),
                             max_segment_bytes=2048)
        for i in range(300):
            wal.write({"seq": i, "pad": b"x" * 32})
        for reader in (JAX, PORT):
            tails.append([reader.wd.wal_tail(wal, n) for n in (50, 10_000,
                                                               0)])
            tails[-1].append(reader.wd.wal_tail(None, 50))
        wal.close()
    assert all(t == tails[0] for t in tails)
    assert [r["seq"] for r in tails[0][0]] == list(range(250, 300))
    assert tails[0][0][0]["pad"] == (b"x" * 32).hex()


def test_dump_incidents_route_and_loading_match_jax(tmp_path, clocks):
    node = _stub_node(step_age=999.0)
    wd = _watchdog(JAX, node, tmp_path, min_interval_s=0.0)
    wd.check()
    clocks.mono += 1
    wd.check()
    d = wd.incident_dir
    host = SimpleNamespace(liveness_watchdog=wd, incident_dir=lambda: d)
    outs = []
    for P in (JAX, PORT):
        env = SimpleNamespace(node=host)
        name = P.wd.list_incidents(d)[1]["name"]
        outs.append([run(P.core.dump_incidents(env)),
                     run(P.core.dump_incidents(env, limit=1, name=name)),
                     P.wd.load_incident(d, "../secrets.json"),
                     P.wd.load_incident(d, "incident-x.json"),
                     P.wd.list_incidents(os.path.join(str(tmp_path), "no"))])
        env_off = SimpleNamespace(node=SimpleNamespace())
        outs[-1].append(run(P.core.dump_incidents(env_off)))
    assert outs[0] == outs[1]
    assert outs[1][0]["enabled"] and len(outs[1][0]["incidents"]) == 2
    assert outs[1][1]["bundle"]["reasons"][0] == "consensus_step_stalled"
    assert outs[1][-1] == {"enabled": False, "incident_dir": "",
                           "trips": 0, "incidents": []}


def test_incident_dir_resolution_matches_jax():
    for home, path in ((None, "data/incidents"), ("/tmp/home-x",
                                                  "data/incidents"),
                       (None, "/var/incidents"), ("/h", "/abs")):
        got = []
        for P in (JAX, PORT):
            cfg = P.config.Config()
            cfg.instrumentation.watchdog_incident_dir = path
            got.append(P.wd.resolve_incident_dir(cfg, home))
        assert got[0] == got[1]


def test_config_watchdog_bounds_match_jax():
    import dataclasses

    j_inst = dataclasses.asdict(j_config.InstrumentationConfig())
    t_inst = dataclasses.asdict(t_config.InstrumentationConfig())
    assert {k: v for k, v in j_inst.items() if k.startswith("watchdog")} \
        == {k: v for k, v in t_inst.items() if k.startswith("watchdog")}
    for field_, value in (("watchdog_stall_threshold_s", -1.0),
                          ("watchdog_check_interval_s", 0.0),
                          ("watchdog_min_interval_s", -1.0),
                          ("watchdog_max_bundles", 0),
                          ("watchdog_wal_tail", -1)):
        errs = []
        for P in (JAX, PORT):
            cfg = P.config.Config()
            setattr(cfg.instrumentation, field_, value)
            try:
                cfg.validate()
                errs.append(None)
            except P.config.ConfigError as e:
                errs.append(str(e))
        assert errs[0] == errs[1] and errs[0] is not None


def test_port_node_stall_writes_bundle_served_by_dump_incidents(tmp_path):
    """A port validator holding half the power never commits: its
    watchdog trips and writes a bundle with its WAL tail, which the
    node's ``/dump_incidents`` lists and serves."""
    async def main():
        doc, pvs = genesis(2, chain_id="wd-net", tag=b"wd")
        node = await make_node(doc, pvs[0], 0, "wd",
                               home=str(tmp_path / "h"))
        inst = node.config.instrumentation
        inst.watchdog_stall_threshold_s = 2.0
        inst.watchdog_check_interval_s = 0.5
        try:
            await node.start()
            assert node.liveness_watchdog is not None
            env = t_core.Environment(node)
            for _ in range(100):
                out = await t_core.dump_incidents(env)
                if out["incidents"]:
                    break
                await asyncio.sleep(0.2)
            name = out["incidents"][0]["name"]
            one = await t_core.dump_incidents(env, name=name)
        finally:
            await node.stop()
        return out, one

    out, one = run(main())
    assert out["enabled"] and out["trips"] >= 1
    assert out["incident_dir"] == str(tmp_path / "h" / "data" /
                                      "incidents")
    b = one["bundle"]
    assert "consensus_step_stalled" in b["reasons"]
    assert b["node"] == "wd0" and b["consensus"]["height"] == 1
    assert b["wal_tail"], "bundle without the WAL tail"
