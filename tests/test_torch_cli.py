"""The port's command line (``cometbft_tpu_torch/cmd``) against the JAX
package's (``cometbft_tpu/cmd``), through ``main(argv)`` of each:

- ``init``, ``testnet``, the key tools, ``unsafe-reset-all`` and
  ``version``: the genesis and keys of each package's home load in the
  other, and ``show-node-id`` and ``show-validator`` print the same for
  the same home (a JAX-written ``config.toml`` loads in the port; the
  port's carries ``base.device``, which the JAX loader refuses);
- ``rollback``, ``reindex-event``, ``compact-db``, ``doctor`` and
  ``debug wal`` on two copies of one home that a short port chain
  committed (a solo validator in process, on the CPU): each package's
  command on its own copy prints the same and leaves the same store
  bytes (the JAX copy gets the JAX package's ``config.toml``);
- a live run: ``testnet --v 2``, two ``start --device cpu`` processes to
  height 3, the kernel-dispatch series on a node's ``/metrics``, ``load``
  and ``load-report`` at a low rate (the JAX package's report against
  the port's node alike), and a SIGTERM exit of 0;
- ``abci kvstore --device cpu`` as a process, ``abci test`` and
  ``abci echo`` from both packages against it; ``abci kvstore --grpc``
  answering both packages' gRPC clients alike."""

import asyncio
import json
import os
import re
import shutil
import signal
import socket
import subprocess
import sys
import time
import urllib.request

import pytest
import torch

import cometbft_tpu.cmd as j_cmd
import cometbft_tpu.config as j_config
import cometbft_tpu_torch.cmd as t_cmd
from cometbft_tpu.crypto import keys as j_keys
from cometbft_tpu.p2p import NodeKey as JNodeKey
from cometbft_tpu.privval import FilePV as JFilePV
from cometbft_tpu.types.genesis import GenesisDoc as JGenesisDoc
from cometbft_tpu_torch.config import MS, Config
from cometbft_tpu_torch.crypto import keys as t_keys
from cometbft_tpu_torch.e2e import free_port_base
from cometbft_tpu_torch.p2p import NodeKey
from cometbft_tpu_torch.privval import FilePV
from cometbft_tpu_torch.types.genesis import GenesisDoc

from torch_node_fixtures import no_host_verify, run  # noqa: F401

pytestmark = pytest.mark.timeout(150)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU_TIMEOUTS = ["-o", f"consensus.timeout_propose={2000 * MS}",
                "-o", f"consensus.timeout_prevote={1000 * MS}",
                "-o", f"consensus.timeout_precommit={1000 * MS}"]


def _main(cmd, argv, capsys):
    """``cmd.main(argv)`` -> (rc, stdout, stderr)."""
    capsys.readouterr()
    rc = cmd.main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


def _both(argv_of, capsys):
    """The command through each package: ``argv_of(tag)`` builds the
    argv for ``"j"`` and ``"t"``."""
    return [_main(cmd, argv_of(tag), capsys)
            for cmd, tag in ((j_cmd, "j"), (t_cmd, "t"))]


# ------------------------------------------------------------ homes, keys

def test_init_homes_load_across_packages(tmp_path, capsys):
    jh, th = str(tmp_path / "j"), str(tmp_path / "t")
    (jr, jo, _), (tr, to, _) = _both(lambda tag: [
        "--home", jh if tag == "j" else th, "init", "--chain-id", "c1",
        "--moniker", "m1"], capsys)
    assert jr == tr == 0
    assert re.sub(r"in \S+ \(node id \w+\)", "", jo) == \
        re.sub(r"in \S+ \(node id \w+\)", "", to)
    # the same home answers alike in both, where both can read it: the
    # JAX home in both packages
    for verb in ("show-node-id", "show-validator"):
        outs = _both(lambda tag: ["--home", jh, verb], capsys)
        assert outs[0] == outs[1] and outs[0][0] == 0
    # the port's home through the JAX package's loaders
    _, nid, _ = _main(t_cmd, ["--home", th, "show-node-id"], capsys)
    assert JNodeKey.load(os.path.join(th, "config", "node_key.json")).id \
        == nid.strip()
    _, val, _ = _main(t_cmd, ["--home", th, "show-validator"], capsys)
    jpv = JFilePV.load(
        os.path.join(th, "config", "priv_validator_key.json"),
        os.path.join(th, "data", "priv_validator_state.json"))
    assert json.loads(val) == {"type": "ed25519",
                               "value": jpv.get_pub_key().bytes().hex()}
    for home in (jh, th):
        gpath = os.path.join(home, "config", "genesis.json")
        jd, td = JGenesisDoc.load(gpath), GenesisDoc.load(gpath)
        assert (jd.chain_id, jd.genesis_time_ns, jd.initial_height) == \
            (td.chain_id, td.genesis_time_ns, td.initial_height) == \
            (jd.chain_id, jd.genesis_time_ns, 1)
        assert [(v.pub_key.bytes(), v.power, v.name) for v in
                jd.validators] == [(v.pub_key.bytes(), v.power, v.name)
                                   for v in td.validators]
        pv = FilePV.load(
            os.path.join(home, "config", "priv_validator_key.json"),
            os.path.join(home, "data", "priv_validator_state.json"))
        assert pv.get_pub_key().bytes() == td.validators[0].pub_key.bytes()
    assert Config.load(os.path.join(jh, "config", "config.toml")) \
        .base.moniker == "m1"
    # init again keeps the keys
    _main(t_cmd, ["--home", th, "init"], capsys)
    assert _main(t_cmd, ["--home", th, "show-node-id"], capsys)[1] == nid


@pytest.mark.parametrize("key_type", ["ed25519", "secp256k1", "bls12_381"])
def test_gen_validator_alike(key_type, capsys):
    outs = _both(lambda tag: ["gen-validator", "--key-type", key_type],
                 capsys)
    for rc, out, _ in outs:
        assert rc == 0
        d = json.loads(out)
        assert d["type"] == key_type
        for P in (j_keys, t_keys):
            sk = P.priv_key_from_type_bytes(key_type,
                                            bytes.fromhex(d["priv_key"]))
            assert sk.pub_key().bytes().hex() == d["pub_key"]
            assert sk.pub_key().address().hex() == d["address"]
    assert set(json.loads(outs[0][1])) == set(json.loads(outs[1][1]))


def test_gen_node_key_and_version(tmp_path, capsys):
    home = str(tmp_path / "h")
    os.makedirs(os.path.join(home, "config"))
    rc, out, _ = _main(t_cmd, ["--home", home, "gen-node-key"], capsys)
    assert rc == 0 and JNodeKey.load(os.path.join(
        home, "config", "node_key.json")).id == out.strip()
    assert _main(j_cmd, ["--home", home, "gen-node-key"], capsys)[1] == out
    assert _both(lambda tag: ["version"], capsys)[0] == \
        _both(lambda tag: ["version"], capsys)[1]


def test_unsafe_reset_all_alike(tmp_path, capsys):
    homes = {}
    for tag, cmd in (("j", j_cmd), ("t", t_cmd)):
        home = homes[tag] = str(tmp_path / tag)
        _main(cmd, ["--home", home, "init"], capsys)
        state = os.path.join(home, "data", "priv_validator_state.json")
        pv = (JFilePV if tag == "j" else FilePV).load(
            os.path.join(home, "config", "priv_validator_key.json"), state)
        pv.height, pv.round, pv.step = 9, 1, 2
        pv.signature = b"\x01" * 64
        pv._save_state()
        with open(os.path.join(home, "data", "junk.db"), "w") as f:
            f.write("x")
    outs = _both(lambda tag: ["--home", homes[tag], "unsafe-reset-all"],
                 capsys)
    assert outs[0][0] == outs[1][0] == 0
    assert outs[0][1].replace(homes["j"], "H") == \
        outs[1][1].replace(homes["t"], "H")
    for tag, home in homes.items():
        assert os.listdir(os.path.join(home, "data")) == \
            ["priv_validator_state.json"]
        for P in (JFilePV, FilePV):
            pv = P.load(os.path.join(home, "config",
                                     "priv_validator_key.json"),
                        os.path.join(home, "data",
                                     "priv_validator_state.json"))
            assert (pv.height, pv.round, pv.step, pv.signature) == \
                (0, 0, 0, b"")


def test_testnet_alike(tmp_path, capsys):
    dirs = {tag: str(tmp_path / tag) for tag in "jt"}
    outs = _both(lambda tag: ["testnet", "--v", "3", "--output-dir",
                              dirs[tag], "--base-port", "27100",
                              "--chain-id", "tn"], capsys)
    assert outs[0][1].replace(dirs["j"], "D") == \
        outs[1][1].replace(dirs["t"], "D")
    for i in range(3):
        cfgs = [Config.load(os.path.join(dirs[tag], f"node{i}", "config",
                                         "config.toml")) for tag in "jt"]
        assert cfgs[0] == cfgs[1]
        assert cfgs[1].p2p.laddr == f"tcp://127.0.0.1:{27100 + 2 * i}"
        docs = [JGenesisDoc.load(os.path.join(
            dirs[tag], f"node{i}", "config", "genesis.json"))
            for tag in "jt"]
        assert [(v.name, v.power) for v in docs[0].validators] == \
            [(v.name, v.power) for v in docs[1].validators] == \
            [(f"node{k}", 10) for k in range(3)]


# ------------------------------------------------------ offline store tools

CHAIN_TXS = [b"cli%d=v%d" % (i, i) for i in range(4)]
CHAIN_TOP = 6


@pytest.fixture(scope="module")
def chain_home(tmp_path_factory):
    """A home made by the port's ``init`` whose solo validator commits
    ``CHAIN_TOP`` heights in process on the CPU, ``CHAIN_TXS`` among
    them."""
    from cometbft_tpu_torch.abci.kvstore import KVStoreApplication
    from cometbft_tpu_torch.crypto import scheduler as vsched
    from cometbft_tpu_torch.node import Node

    home = str(tmp_path_factory.mktemp("tcli") / "home")
    assert t_cmd.main(["--home", home, "init", "--chain-id", "cli"]) == 0
    cfg = t_cmd._load_home(home)
    t_cmd._apply_overrides(cfg, ["base.device=cpu", "rpc.laddr=",
                                 "p2p.laddr=tcp://127.0.0.1:0"]
                           + CPU_TIMEOUTS[1::2])

    async def go():
        node = await Node.create(
            GenesisDoc.load(os.path.join(home, "config", "genesis.json")),
            KVStoreApplication(device="cpu"),
            priv_validator=FilePV.load(
                os.path.join(home, "config", "priv_validator_key.json"),
                os.path.join(home, "data", "priv_validator_state.json")),
            config=cfg, node_key=NodeKey.load(
                os.path.join(home, "config", "node_key.json")),
            home=home, name="cli")
        try:
            await node.start()
            for tx in CHAIN_TXS:
                await node.mempool.check_tx(tx)
            t0 = time.monotonic()
            while node.height() < CHAIN_TOP:
                assert time.monotonic() - t0 < 90
                await asyncio.sleep(0.05)
        finally:
            await node.stop()

    vsched.set_scheduler(None)
    run(go())
    return home


def _copies(chain_home, tmp_path):
    """Two copies of the chain's home: the JAX package's gets a
    ``config.toml`` of its own (the port's carries ``base.device``)."""
    homes = {}
    for tag in "jt":
        homes[tag] = str(tmp_path / tag)
        shutil.copytree(chain_home, homes[tag])
    jcfg = j_config.Config()
    jcfg.base.moniker = "node"
    jcfg.save(os.path.join(homes["j"], "config", "config.toml"))
    return homes


def _data_bytes(home) -> dict:
    out = {}
    data = os.path.join(home, "data")
    for root, _dirs, files in os.walk(data):
        for fn in files:
            p = os.path.join(root, fn)
            if fn in ("LOCK", "lock") or fn.endswith(".lock"):
                continue
            with open(p, "rb") as f:
                out[os.path.relpath(p, data)] = f.read()
    return out


def _jax_cli(argv):
    """The JAX package's command line in a process of its own: its
    offline tools hold the data dir's lock until their process exits."""
    out = subprocess.run([sys.executable, "-m", "cometbft_tpu", *argv],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120, env=dict(os.environ,
                                               JAX_PLATFORMS="cpu"))
    return out.returncode, out.stdout, out.stderr


def test_store_tools_alike(chain_home, tmp_path, capsys):
    homes = _copies(chain_home, tmp_path)
    assert _data_bytes(homes["j"]) == _data_bytes(homes["t"])

    def same(argv, rc=0):
        outs = [_jax_cli(["--home", homes["j"], *argv]),
                _main(t_cmd, ["--home", homes["t"], *argv], capsys)]
        norm = [(r, o.replace(homes[tag], "H"), e.replace(homes[tag], "H"))
                for (r, o, e), tag in zip(outs, "jt")]
        assert norm[0] == norm[1], argv
        assert rc is None or norm[1][0] == rc, norm[1]
        assert _data_bytes(homes["j"]) == _data_bytes(homes["t"]), argv
        return norm[1]

    _, report, _ = same(["doctor"])
    assert json.loads(report)["ok"] is True
    _, wal, err = same(["debug", "wal"])
    assert int(re.search(r"# (\d+) records", err).group(1)) == \
        len(wal.splitlines()) > CHAIN_TOP
    _, out, _ = same(["reindex-event"])
    assert out.strip() == f"Reindexed {CHAIN_TOP} blocks [1,{CHAIN_TOP}]"
    same(["reindex-event", "--start-height", "2", "--end-height", "99"],
         rc=1)
    _, out, _ = same(["compact-db"])
    assert out.strip().endswith("bytes")
    _, out, _ = same(["rollback"])
    assert out.startswith(f"Rolled back state to height {CHAIN_TOP - 1} ")
    # after the rollback the state is a height behind the stores: the
    # doctor reports alike, whatever it finds
    same(["doctor", "--window", "0"], rc=None)


# ----------------------------------------------------------- processes

def _spawn(argv, log_path):
    """A ``python -m cometbft_tpu_torch`` process; one intra-op thread,
    as this process has, so the plain versions leave the cores to the
    other test workers."""
    with open(log_path, "ab") as log:
        return subprocess.Popen(
            [sys.executable, "-m", "cometbft_tpu_torch", *argv], cwd=ROOT,
            stdout=log, stderr=subprocess.STDOUT,
            env=dict(os.environ, OMP_NUM_THREADS="1"))


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=10) as r:
        return r.read().decode()


def _height(port) -> int:
    try:
        return json.loads(_get(port, "/status"))["result"]["sync_info"][
            "latest_block_height"]
    except (OSError, ValueError, KeyError):
        return -1


def _wait(cond, procs, timeout, what):
    t0 = time.monotonic()
    while not cond():
        for p in procs:
            assert p.poll() is None, f"a node exited with {p.returncode}"
        assert time.monotonic() - t0 < timeout, what
        time.sleep(0.25)


def test_live_testnet_load_and_sigterm(tmp_path, capsys):
    base = free_port_base(4)
    out = str(tmp_path / "net")
    assert t_cmd.main(["testnet", "--v", "2", "--output-dir", out,
                       "--base-port", str(base)]) == 0
    procs = [_spawn(["--home", os.path.join(out, f"node{i}"), "--device",
                     "cpu", "start", *CPU_TIMEOUTS],
                    os.path.join(out, f"node{i}.log")) for i in range(2)]
    rpc = [base + 1, base + 3]
    try:
        _wait(lambda: min(_height(p) for p in rpc) >= 3, procs, 100,
              "height 3")
        # a node process's kernel calls on its /metrics: K5a's tables
        # and K5b's per-lane checks, their plain versions here, no launch
        metrics = _get(rpc[0], "/metrics")
        for kind in ("tables", "gather"):
            assert re.search(r'crypto_kernel_first_dispatch_total\{kind="'
                             + kind + r'"\} [1-9]', metrics), kind
        for k in ("ed25519_tables", "ed25519_verify_gather"):
            assert re.search(r'crypto_kernel_calls_total\{kernel="' + k
                             + r'",route="plain"\} [1-9]', metrics), k
        assert not re.search(r'crypto_kernel_calls_total\{[^}]*route="cuda"'
                             r'\} [1-9]', metrics)
        rc, sent, _ = _main(t_cmd, ["load", "--rpc", f"127.0.0.1:{rpc[0]}",
                                    "--rate", "5", "--duration", "2",
                                    "--size", "64"], capsys)
        sent = json.loads(sent)
        assert rc == 0 and sent["sent"] >= 5 and sent["errors"] == 0
        top = _height(rpc[0])
        _wait(lambda: _height(rpc[0]) >= top + 2, procs, 60, "two heights")
        reps = _both(lambda tag: ["load-report", "--rpc",
                                  f"127.0.0.1:{rpc[0]}", "--run-id",
                                  sent["run_id"]], capsys)
        assert reps[0] == reps[1]
        assert json.loads(reps[1][1])["txs"] == sent["sent"]
    finally:
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        rcs = [p.wait(timeout=60) for p in procs]
    assert rcs == [0, 0]
    for i in range(2):
        with open(os.path.join(out, f"node{i}.log")) as f:
            assert "shutting down..." in f.read()


def test_abci_console_against_a_kvstore_process(tmp_path, capsys):
    port = free_port_base(1)
    proc = _spawn(["--device", "cpu", "abci", "kvstore", "--port",
                   str(port)], str(tmp_path / "app.log"))
    try:
        def up():
            try:
                socket_ = socket.create_connection(
                    ("127.0.0.1", port), timeout=1)
                socket_.close()
                return True
            except OSError:
                return False

        _wait(up, [proc], 60, "kvstore up")
        addr = ["--address", f"127.0.0.1:{port}"]
        outs = [_main(cmd, ["abci", "test", *addr], capsys)
                for cmd in (j_cmd, t_cmd)]
        assert outs[0][0] == outs[1][0] == 0
        assert outs[1][1].count("PASS") == 7 and "FAIL" not in outs[1][1]
        # the second run sees the first's committed height
        assert outs[0][1] == outs[1][1]
        echo = _both(lambda tag: ["abci", "echo", *addr, "hi"], capsys)
        assert echo[0] == echo[1] == (0, "-> data: hi\n", "")
    finally:
        proc.send_signal(signal.SIGINT)
        proc.wait(timeout=30)
    # over gRPC: echo and info through each package's gRPC client (the
    # abci-cli verbs of both packages speak the socket protocol only)
    from cometbft_tpu.abci.grpc import GRPCClient as JClient
    from cometbft_tpu_torch.abci.grpc import GRPCClient as TClient

    port = free_port_base(1)
    proc = _spawn(["--device", "cpu", "abci", "kvstore", "--grpc",
                   "--port", str(port)], str(tmp_path / "grpc.log"))

    async def poke(cls):
        client = await cls.connect(port=port)
        try:
            info = await client.info()
            return await client.echo("hi"), info.data, info.app_version
        finally:
            await client.close()

    def up():
        try:
            asyncio.run(poke(TClient))
            return True
        except Exception:
            return False

    try:
        _wait(up, [proc], 60, "grpc kvstore up")
        got = [asyncio.run(poke(cls)) for cls in (JClient, TClient)]
        assert got[0] == got[1] and got[0][:2] == ("hi", "kvstore")
    finally:
        proc.send_signal(signal.SIGINT)
        proc.wait(timeout=30)


def _series(text: str) -> set:
    """(name, label keys) of every sample of the kernel-dispatch series
    in a Prometheus text."""
    out = set()
    for ln in text.splitlines():
        m = re.match(r"(crypto_kernel_(?:first_)?dispatch_\w+)(\{(.*)\})? ",
                     ln)
        if m:
            keys = tuple(sorted(kv.split("=")[0] for kv in
                                (m.group(3) or "").split(",") if kv))
            out.add((m.group(1), keys))
    return out


def test_dispatch_series_named_as_the_jax_packages():
    """The kernel-dispatch series (``crypto/batch.py:_note_dispatch``):
    the JAX package's metric names, label keys and kinds, a first
    dispatch of a (kind, lanes) in the gauge and counter, later ones in
    the histogram."""
    import cometbft_tpu.crypto.batch as j_batch
    import cometbft_tpu.libs.metrics as j_metrics
    import cometbft_tpu_torch.crypto.batch as t_batch
    import cometbft_tpu_torch.libs.metrics as t_metrics

    for _ in range(2):
        j_batch._note_dispatch("probe", 7, 0.001)
        t_batch._note_dispatch("probe", 7, 0.001)
    jt, tt = j_metrics.DEFAULT.collect(), t_metrics.DEFAULT.collect()
    assert _series(jt) == _series(tt) != set()
    for text in (jt, tt):
        assert 'crypto_kernel_first_dispatch_total{kind="probe"} 1' in text
        assert re.search(r'crypto_kernel_first_dispatch_seconds\{'
                         r'kind="probe",lanes="7"\}', text)
        assert re.search(r'crypto_kernel_dispatch_seconds_count\{'
                         r'kind="probe"\} 1', text)


def test_kernel_calls_served_from_the_launch_counters():
    """``crypto_kernel_calls_total{kernel,route}`` is ``ops/_build.py``'s
    ``LAUNCHES`` (route cuda) and ``PLAIN_CALLS`` (route plain) as they
    stand at the scrape, every kernel listed, zeros included; a table
    build on CPU tensors shows as one plain call and no launch, and no
    allocator gauge shows where CUDA was never initialised."""
    import numpy as np

    import cometbft_tpu_torch.crypto.batch as t_batch
    import cometbft_tpu_torch.libs.metrics as t_metrics
    from cometbft_tpu_torch.ops import _build

    def calls():
        out = {}
        for m in re.finditer(r'crypto_kernel_calls_total\{kernel="(\w+)",'
                             r'route="(\w+)"\} (\d+)',
                             t_metrics.DEFAULT.collect()):
            out[m.group(1), m.group(2)] = int(m.group(3))
        return out

    _build.reset_launches()
    assert calls() == {(k, r): 0 for k in _build.KERNELS
                       for r in ("cuda", "plain")}
    key = t_keys.Ed25519PrivKey.from_secret(b"calls").pub_key().bytes()
    t_batch._tables(torch.from_numpy(np.frombuffer(key, np.uint8)[None]
                                     .copy()))
    got = calls()
    assert got.pop(("ed25519_tables", "plain")) == 1
    assert set(got.values()) == {0}
    _build.LAUNCHES["merkle_level"] += 2        # as the launch site adds
    assert calls()[("merkle_level", "cuda")] == 2
    _build.reset_launches()
    if not torch.cuda.is_initialized():
        assert "torch_cuda_memory_bytes{" not in t_metrics.DEFAULT.collect()
