"""The port's e2e manifests, generator and runner (``cometbft_tpu_torch/
e2e``) against the JAX package's: the same validation errors, the same
generated manifests for seeds 1-50 (and their TOML round trip), the same
homes from ``Runner.setup`` for ``networks/ci.toml`` apart from the
device, a grpc node's setup and app command, the free port helper, and
live runs on the CPU: a node process that cannot reach its device fails
the run, and validator01, full01 (start_at 2, kill:3, restart:4) and light01
(start_at 3) reach height 6 with the runner's invariants, every process
started through ``python -m cometbft_tpu_torch --device cpu``."""

import asyncio
import dataclasses
import os
import random

import pytest

import cometbft_tpu.e2e as j_e2e
import cometbft_tpu.e2e.generator as j_gen
import cometbft_tpu.e2e.manifest as j_man
import cometbft_tpu_torch.e2e as t_e2e
import cometbft_tpu_torch.e2e.generator as t_gen
import cometbft_tpu_torch.e2e.manifest as t_man
from cometbft_tpu_torch.config import Config
from cometbft_tpu_torch.types.genesis import GenesisDoc

pytestmark = pytest.mark.timeout(120)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CI = os.path.join(ROOT, "networks", "ci.toml")

BAD = {
    "no nodes": {},
    "no validators": {"node": {"f": {"mode": "full"}}},
    "stray validator": {"validators": {"x": 1}, "node": {"v": {}}},
    "bad mode": {"node": {"v": {}, "w": {"mode": "archive"}}},
    "bad db": {"node": {"v": {"database": "rocks"}}},
    "bad abci": {"node": {"v": {"abci_protocol": "http"}}},
    "memdb kill": {"node": {"v": {"database": "memdb",
                                  "perturb": ["kill:3"]}}},
    "bad perturb": {"node": {"v": {"perturb": ["explode:3"]}}},
    "bad height": {"node": {"v": {"perturb": ["kill:x"]}}},
    "update height": {"node": {"v": {}}, "validator_update": {"0": {"v": 1}}},
    "update light": {"node": {"v": {}, "l": {"mode": "light"}},
                     "validator_update": {"3": {"l": 5}}},
    "update power": {"node": {"v": {}}, "validator_update": {"3": {"v": -1}}},
    "update secp": {"node": {"v": {"key_type": "secp256k1"}},
                    "validator_update": {"3": {"v": 5}}},
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_manifest_validation_errors_alike(case):
    errs = []
    for M in (j_man, t_man):
        with pytest.raises(M.ManifestError) as e:
            M.manifest_from_dict(BAD[case])
        errs.append(str(e.value))
    assert errs[0] == errs[1]


@pytest.mark.parametrize("seed", range(1, 51))
def test_generated_manifests_alike(seed, tmp_path):
    compact = seed % 5 == 0
    text = t_man.manifest_to_toml(t_gen.generate_manifest(
        seed, compact=compact))
    assert text == j_man.manifest_to_toml(j_gen.generate_manifest(
        seed, compact=compact))
    path = tmp_path / "m.toml"
    path.write_text(text)
    back = t_man.load_manifest(str(path))
    assert t_man.manifest_to_toml(back) == text
    assert dataclasses.asdict(back) == dataclasses.asdict(
        j_man.load_manifest(str(path)))


def test_ci_setup_alike(tmp_path):
    """Both runners' homes for ci.toml: the same ports, peers and config
    (a JAX-written config loads in the port; it differs only in keys the
    port drops), the same genesis powers and names."""
    runners = [P.Runner(P.load_manifest(CI), str(tmp_path / tag),
                        base_port=40000, log=lambda *_: None)
               for P, tag in ((j_e2e, "j"), (t_e2e, "t"))]
    for r in runners:
        r.setup()
    j, t = runners
    assert (j.names, j.ports) == (t.names, t.ports)
    assert set(j.node_ids) == set(t.node_ids)
    for name in t.names:
        if t.m.nodes[name].mode == "light":
            continue
        cfgs = [Config.load(os.path.join(r.home(name), "config",
                                         "config.toml")) for r in runners]
        assert cfgs[0] == cfgs[1], name
        assert cfgs[1].p2p.persistent_peers and \
            cfgs[1].base.moniker == name
        docs = [GenesisDoc.load(os.path.join(r.home(name), "config",
                                             "genesis.json"))
                for r in runners]
        assert [(v.name, v.power) for v in docs[0].validators] == \
            [(v.name, v.power) for v in docs[1].validators]
        assert docs[0].chain_id == docs[1].chain_id == "e2e-ci"


def test_grpc_node_refused(tmp_path, monkeypatch):
    """A grpc node is run, not refused: the first generated manifest
    with one sets up in both runners alike (its config names the gRPC
    app at its app port), and the port's runner starts its app as
    ``abci kvstore --grpc`` on that port."""
    import cometbft_tpu_torch.e2e.runner as t_runner

    seed = next(s for s in range(1, 51) if any(
        nd.abci_protocol == "grpc"
        for nd in t_gen.generate_manifest(s).nodes.values()))
    runners = [P.Runner(G.generate_manifest(seed), str(tmp_path / tag),
                        base_port=40000, log=lambda *_: None)
               for P, G, tag in ((j_e2e, j_gen, "j"), (t_e2e, t_gen, "t"))]
    for r in runners:
        r.setup()
    t = runners[1]
    name = next(n for n in t.names
                if t.m.nodes[n].abci_protocol == "grpc")
    cfgs = [Config.load(os.path.join(r.home(name), "config",
                                     "config.toml")) for r in runners]
    assert cfgs[0] == cfgs[1]
    assert cfgs[1].base.abci == "grpc"
    assert cfgs[1].base.proxy_app == f"127.0.0.1:{t.app_port(name)}"
    started = []

    class Proc:
        def __init__(self, cmd, **kw):
            started.append(cmd)

    monkeypatch.setattr(t_runner.subprocess, "Popen", Proc)
    monkeypatch.setattr(t, "_wait_for_port", lambda port, timeout: None)
    t._spawn(name)
    assert started[0][1:] == ["-m", "cometbft_tpu_torch", "abci", "kvstore",
                              "--port", str(t.app_port(name)), "--grpc"]
    assert started[1][-1] == "start"


def test_processes_get_the_runners_device(tmp_path):
    m = t_man.load_manifest(CI)
    card = t_e2e.Runner(m, str(tmp_path / "a"))
    cpu = t_e2e.Runner(m, str(tmp_path / "b"), device="cpu")
    assert card._cli("start")[1:] == ["-m", "cometbft_tpu_torch", "start"]
    assert cpu._cli("start")[1:] == ["-m", "cometbft_tpu_torch", "--device",
                                     "cpu", "start"]
    cpu._trust_anchor = (2, "ab" * 32)
    light = cpu._light_cmd("light01")
    assert light[3:6] == ["--device", "cpu", "light"]


def test_free_port_base_steps_past_a_taken_port():
    import socket

    port = t_e2e.free_port_base(1)
    held = socket.socket()
    held.bind(("127.0.0.1", port))
    try:
        start = port - 1
        base = t_e2e.free_port_base(3, start=start)
        assert base >= start + 3 and (base - start) % 3 == 0
        assert not base <= port < base + 3
        base = t_e2e.free_port_base(4)
        assert 20000 <= base < 30000
    finally:
        held.close()


def _run(manifest, tmp_path, device, deadline_s, log=None):
    """The runner over ``manifest`` on ``device``; its processes (which
    inherit the environment, ``OMP_NUM_THREADS=1`` in these tests) on a
    free port range."""
    base = t_e2e.free_port_base(3 * len(manifest.nodes))
    r = t_e2e.Runner(manifest, str(tmp_path / "net"), base_port=base,
                     fast_timeouts=False, device=device,
                     rng=random.Random(7),
                     log=log.append if log is not None else lambda *_: None)
    r.setup()
    try:
        return asyncio.run(r.run(deadline_s=deadline_s)), r
    finally:
        r.stop()


def test_node_that_cannot_reach_its_device_fails_the_run(tmp_path,
                                                          monkeypatch):
    """A runner on a card no process can reach (``cuda:99``, on a host
    with cards or without) starts validator01 there: the node raises at
    ``Node.create``, its process exits, and the run fails naming it,
    without waiting out the RPC timeouts."""
    m = t_man.manifest_from_dict({"node": {"validator01": {}},
                                  "final_height": 3,
                                  "load": {"rate": 0.0}})
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    with pytest.raises(t_e2e.RunnerError,
                       match="validator01 exited with code"):
        _run(m, tmp_path, "cuda:99", 60.0)


def test_live_run_on_the_cpu(tmp_path, monkeypatch):
    m = t_man.manifest_from_dict({
        "chain_id": "e2e-cpu", "final_height": 6,
        "validators": {"validator01": 10},
        "node": {"validator01": {},
                 "full01": {"mode": "full", "start_at": 2,
                            "perturb": ["kill:3", "restart:4"]},
                 "light01": {"mode": "light", "start_at": 3}},
        "load": {"rate": 2.0, "duration": 4.0, "size": 64}})
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    log = []
    report, r = _run(m, tmp_path, "cpu", 100.0, log)
    assert report["final_height"] == 6
    assert set(report["heights"]) == {"validator01", "full01"}
    assert min(report["heights"].values()) >= 6
    assert report["light_verified"] == {"light01": True}
    assert report["agreement_hash"]
    assert not r.killed                    # full01 was restarted
    assert log.count("[e2e] starting full01 (full)") == 2
    assert "[e2e] perturb kill full01" in log
    heights = [int(x.split()[-1]) for x in log
               if x.startswith("[e2e] height ")]
    assert heights == sorted(set(heights)) and heights[-1] >= 6


def test_perturbations_hold_until_the_chain_moves(monkeypatch, tmp_path):
    """A node's next action waits until the chain has passed the height
    its previous one fired at: polls that see the chain jump from 1 to 5
    fire validator02's pause:2 at 5 and its resume:3 only once the chain
    is at 6 (the JAX runner fires both in the poll that sees 5, and the
    pause holds for no time); validator03's kill:2 and restart:4 alike.
    Scripted ``status`` answers stand in for the processes."""
    import cometbft_tpu_torch.rpc as t_rpc

    script = iter([1, 1, 5, 5, 5, 6, 6, 7])

    class FakeClient:
        def __init__(self, *a, **kw):
            pass

        async def call(self, method, **kw):
            if method == "status":
                h = next(script, 7)
                return {"sync_info": {"latest_block_height": h},
                        "node_info": {}}
            return {}

        async def close(self):
            pass

    monkeypatch.setattr(t_rpc, "HTTPClient", FakeClient)
    fired = []

    class ScriptedRunner(t_e2e.Runner):
        def _spawn(self, name):
            pass

        def _perturb(self, name, action):
            fired.append((action, name, h_now[0]))

    m = t_man.manifest_from_dict({
        "final_height": 7, "load": {"rate": 0.0},
        "node": {"validator01": {},
                 "validator02": {"perturb": ["pause:2", "resume:3"]},
                 "validator03": {"perturb": ["kill:2", "restart:4"]}}})
    r = ScriptedRunner(m, str(tmp_path / "net"), log=lambda *_: None)
    h_now = [0]
    inner = FakeClient.call

    async def call(self, method, **kw):
        out = await inner(self, method, **kw)
        if method == "status":
            h_now[0] = out["sync_info"]["latest_block_height"]
        return out

    monkeypatch.setattr(FakeClient, "call", call)
    asyncio.run(r.run(deadline_s=30))
    assert fired == [("kill", "validator03", 5), ("pause", "validator02", 5),
                     ("resume", "validator02", 6),
                     ("restart", "validator03", 6)]


@pytest.mark.parametrize("name", ["ci.toml", "chaos.toml", "large.toml"])
def test_loads_toml_alike(name):
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "networks", name)
    text = open(path).read()
    assert t_man.loads_toml(text) == j_man.loads_toml(text)
    assert t_man.manifest_from_dict(t_man.loads_toml(text)) == \
        t_man.load_manifest(path)

