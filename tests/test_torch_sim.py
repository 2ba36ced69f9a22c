"""The port's scenario lab (``cometbft_tpu_torch/sim``) on the CPU, held
against the JAX package's (``tests/test_sim.py``'s cases): the virtual
clock and the in-memory transport's link policies on both packages, the
two-node commit over the mem wire, and ``t-replay`` (5 nodes, a ``prob=``
fault site) with the port's verdict JSON and fault signature equal to the
JAX package's and replay-identical on the port.  The adversary and fault
scenarios are in ``test_torch_sim_adversary.py`` and
``test_torch_sim_faults.py``.

Every check of a port node is one synchronous device call of the plain
versions (about 0.2 s here) that blocks the loop's thread, so virtual
time stands still during it: the verdicts match however slow the host,
and only wall time grows (about 5 s a virtual height at 5 validators).
The host oracle is patched to raise."""

import asyncio
import json
import time

import pytest
import torch

from cometbft_tpu import sim as jsim
from cometbft_tpu.libs import clock as jclock
from cometbft_tpu.libs import failures as jfailures
from cometbft_tpu.sim import vtime as jvtime
from cometbft_tpu_torch import sim as tsim
from cometbft_tpu_torch.crypto import batch as cryptobatch
from cometbft_tpu_torch.libs import clock as tclock
from cometbft_tpu_torch.libs import failures as tfailures
from cometbft_tpu_torch.sim import scenario as tscenario
from cometbft_tpu_torch.sim import vtime as tvtime

from torch_node_fixtures import no_host_verify  # noqa: F401
from torch_sim_fixtures import both, canon, scenario

torch.set_num_threads(1)

pytestmark = pytest.mark.timeout(120)

PKGS = {"jax": (jsim, jvtime, jclock, jfailures),
        "port": (tsim, tvtime, tclock, tfailures)}


# -------------------------------------------------------- virtual clock

@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_virtual_clock_sleep_and_timeout_cost_no_real_time(pkg):
    _, vtime, clock, _ = PKGS[pkg]

    async def main():
        t0 = clock.monotonic()
        await clock.sleep(3600)
        with pytest.raises(asyncio.TimeoutError):
            await clock.wait_for(asyncio.Event().wait(), 1800)
        return clock.monotonic() - t0, clock.walltime_ns()

    real0 = time.monotonic()
    virt, wall = vtime.run(main, seed=1)
    assert time.monotonic() - real0 < 5.0      # vs 5400 s simulated
    assert virt == pytest.approx(5400.0)
    assert wall == vtime.VIRTUAL_EPOCH_NS + int(5400e9)
    assert clock.installed() is None
    assert abs(clock.monotonic() - time.monotonic()) < 1.0


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_virtual_clock_timer_order_is_deterministic(pkg):
    _, vtime, clock, _ = PKGS[pkg]

    def make():
        async def main():
            out = []
            for i, d in enumerate((0.3, 0.1, 0.2, 0.1, 0.0)):
                async def tick(i=i, d=d):
                    await clock.sleep(d)
                    out.append(i)
                asyncio.get_running_loop().create_task(tick())
            await clock.sleep(1.0)
            return out

        return vtime.run(main, seed=5)

    assert make() == make() == [4, 1, 3, 2, 0]


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_virtual_deadlock_detected(pkg, monkeypatch):
    sim, vtime, _, _ = PKGS[pkg]
    monkeypatch.setattr(vtime, "_MAX_IDLE_ROUNDS", 3)
    monkeypatch.setattr(vtime, "_IDLE_SLICE_S", 0.01)

    async def main():
        await asyncio.Event().wait()       # can never fire

    with pytest.raises(sim.VirtualTimeDeadlock):
        vtime.run(main, seed=0)


def test_device_await_freezes_virtual_time():
    """A job on the device-owner thread awaited through
    ``crypto/batch.py:device_await`` holds virtual time still: a 0.01 s
    virtual timer fires after a 0.2 s (real) job, not during it."""
    seen = []

    async def main():
        fired = []
        asyncio.get_running_loop().call_later(
            0.01, lambda: fired.append(tclock.monotonic()))

        def job():
            time.sleep(0.2)
            seen.append(list(fired))
            return "done"

        out = await cryptobatch.device_await(job)
        at = tclock.monotonic()
        await tclock.sleep(0.05)
        return out, at, fired

    out, at, fired = tvtime.run(main, seed=0)
    assert out == "done"
    assert seen == [[]], "the timer fired while the device job ran"
    assert at == 0.0
    assert fired == [pytest.approx(0.01)]
    assert cryptobatch.device_jobs_in_flight() == 0


def test_sim_entry_points_need_a_card_or_cpu():
    """With no card visible the lab's entry points raise unless given
    ``device="cpu"``: nothing falls back to a host verifier."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the entry points run on it")
    scn = scenario(tscenario, "t-replay")
    with pytest.raises(RuntimeError):
        tscenario.run_scenario(scn)
    with pytest.raises(RuntimeError):
        tscenario.chaos_signature_of(scn)
    from cometbft_tpu_torch.sim import statesync_lab

    with pytest.raises(RuntimeError):
        statesync_lab.run_statesync_scenario(
            statesync_lab.curated_statesync_scenario(small=True))

    async def build():
        doc, pvs = tsim.make_genesis(1)
        return await tsim.make_sim_node(0, doc, pvs[0], tsim.MemNetwork())

    with pytest.raises(RuntimeError):
        tvtime.run(build, seed=0)
    assert tclock.installed() is None


# ------------------------------------------------------- mem transport

@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_mem_network_policy_resolution_and_specs(pkg):
    sim, _, _, failures = PKGS[pkg]
    net = sim.MemNetwork(default_latency_s=0.01)
    net.apply_spec("link:node=a:peer=b:delay=0.2")
    net.apply_spec("link:node=c:delay=0.05")           # c -> * wildcard
    assert net.policy("a", "b").latency_s == pytest.approx(0.2)
    assert net.policy("b", "a").latency_s == pytest.approx(0.01)
    assert net.policy("c", "zz").latency_s == pytest.approx(0.05)
    net.apply_spec("link:node=a:peer=b:cut=fwd")
    assert net.policy("a", "b").cut and not net.policy("b", "a").cut
    net.heal()
    assert not net.policy("a", "b").cut
    net.partition(["a"], ["b", "c"], one_way=True)
    assert net.policy("a", "b").cut and not net.policy("b", "a").cut
    with pytest.raises(failures.FaultSpecError):
        net.apply_spec("notlink:delay=1")


def _pair(pkg):
    """Two sim nodes of ``pkg`` over MemTransport to height 2: the
    Switch's handshake (NodeInfo exchange, identity check), MConnection
    packets, blocks committed.  Returns (dialled peer id == node 1's id,
    the two nodes' block-1 hashes)."""
    sim, vtime, clock, failures = PKGS[pkg]
    kw = {"device": "cpu"} if pkg == "port" else {}

    async def main():
        failures.reset()
        failures.configure(enabled=True, seed=3)
        if pkg == "port":
            from cometbft_tpu_torch.crypto import scheduler as vsched

            vsched.set_scheduler(vsched.VerificationScheduler(device="cpu"))
        try:
            net = sim.MemNetwork()
            doc, pvs = sim.make_genesis(2, chain_id="mem-pair")
            nodes = [await sim.make_sim_node(i, doc, pv, net, **kw)
                     for i, pv in enumerate(pvs)]
            for n in nodes:
                await n.start()
            peer = await nodes[0].dial(nodes[1], persistent=True)
            deadline = clock.monotonic() + 60
            while min(n.height() for n in nodes) < 2:
                assert clock.monotonic() < deadline, "no commits over mem"
                await clock.sleep(0.1)
            hashes = [n.block_store.load_block(1).hash() for n in nodes]
            for n in nodes:
                await n.stop()
            return peer.id == nodes[1].node_key.id, hashes
        finally:
            failures.reset()
            if pkg == "port":
                vsched.set_scheduler(None)

    return vtime.run(main, seed=3)


def test_mem_transport_full_stack_commits():
    ok, hashes = _pair("port")
    assert ok and len(set(hashes)) == 1
    # the same pair in the JAX package commits the same first block
    assert _pair("jax")[1] == hashes


# ----------------------------------------------------------- scenarios

def test_scenario_json_round_trip_keeps_tuning():
    """The port's curated suite is the JAX package's, dict for dict, and
    survives the JSON round trip with its tuning."""
    from cometbft_tpu.sim.scenario import curated_suite as jsuite

    ours = tscenario.curated_suite()
    assert [s.to_dict() for s in ours] == [s.to_dict() for s in jsuite()]
    for scn in ours:
        back = tsim.Scenario.from_dict(json.loads(json.dumps(scn.to_dict())))
        assert back.tuning == scn.tuning, scn.name
        assert back.to_dict() == scn.to_dict(), scn.name
    legacy = tsim.Scenario(name="t", seed=1).to_dict()
    del legacy["tuning"]
    assert tsim.Scenario.from_dict(legacy).tuning == tsim.SimTuning()


def test_replay_identical_verdict_and_signature_with_prob_site():
    """t-replay: the port's verdict and fault signature equal the JAX
    package's, and a second port run gives the same JSON and the same
    signature, a ``prob=`` site included."""
    v1, sig1 = both("t-replay")
    v2, sig2 = tscenario.chaos_signature_of(scenario(tscenario, "t-replay"),
                                            device="cpu")
    assert sig1 == sig2 and len(sig1) > 0
    assert canon(v1) == canon(v2)
    assert v1["fork_free"] and v1["reached_target"]
    assert any(site == "p2p.recv.corrupt" for site, _, _ in sig1)


# ----------------------------------------------- clock seam (real mode)

def test_clock_seam_real_mode_matches_time_module():
    assert tclock.installed() is None
    assert abs(tclock.monotonic() - time.monotonic()) < 0.5
    assert abs(tclock.walltime_ns() - time.time_ns()) < int(5e8)
    assert abs(tclock.walltime() - time.time()) < 0.5


def test_scorer_ban_ttl_runs_on_virtual_clock():
    """The port's PeerScorer decay and ban TTL ride the seam: a ban
    expires after virtual seconds."""
    from cometbft_tpu_torch.p2p.quality import PeerScorer

    async def main():
        sc = PeerScorer(ban_ttl_s=5.0)
        for _ in range(3):
            sc.report("peerX", "bad_block")
        assert sc.is_banned("peerX")
        await tclock.sleep(6.0)
        return sc.is_banned("peerX")

    assert tvtime.run(main, seed=0) is False
