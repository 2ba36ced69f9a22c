"""The kernel bundle (``cometbft_tpu_torch/crypto/aotbundle.py``), the
warmup (``crypto/batch.py:warmup_device``), the node's warm boot and its
three config keys, on the CPU.

There is no ``nvcc`` and no card here, so the compiler is a stub: a
script standing in for ``nvcc`` that answers ``--version`` with a line
of the test's choosing and builds, for each source, a shared library
(``gcc``) exporting that source's C entries, each returning 0; the
card's capability is a value of the test's choosing.  Everything else is
the module as it runs on the card: the version hash, the manifest, the
file lock, ``ctypes`` binding every kernel's entry, the statuses and the
counters.  The JAX package's bundle holds XLA executables, not these
libraries, so nothing here is held against it; its three config keys
are (``tests/test_torch_config_toml.py`` holds every shared key)."""

import ctypes
import json
import os
import shutil
import stat
import sys
import threading

import numpy as np
import pytest
import torch

from cometbft_tpu_torch import config as t_config
from cometbft_tpu_torch.crypto import aotbundle
from cometbft_tpu_torch.crypto import batch as tbatch
from cometbft_tpu_torch.libs import metrics
from cometbft_tpu_torch.node.node import Node
from cometbft_tpu_torch.ops import _build, blsg1

torch.set_num_threads(1)

pytestmark = pytest.mark.timeout(300)

FAKE_NVCC = r'''#!{python}
import os, re, subprocess, sys
args = sys.argv[1:]
if "--version" in args:
    print("nvcc: NVIDIA (R) Cuda compiler driver (test stub)")
    print(os.environ.get("FAKE_NVCC_VERSION", "Build cuda_stub.1"))
    sys.exit(0)
if os.environ.get("FAKE_NVCC_FAIL"):
    print("error: stub told to fail", file=sys.stderr)
    sys.exit(1)
out, src = args[args.index("-o") + 1], args[-1]
names = re.findall(r'extern "C" int (\w+)\s*\(', open(src).read())
code = "".join("int %s(void) {{ return 0; }}\n" % n for n in names)
subprocess.run(["gcc", "-shared", "-fPIC", "-x", "c", "-", "-o", out],
               input=code.encode(), check=True)
'''


class Env:
    """The stubbed compiler and card, and the bundles' directory."""

    def __init__(self, tmp_path, monkeypatch):
        self.mp = monkeypatch
        nvcc = tmp_path / "bin" / "nvcc"
        nvcc.parent.mkdir()
        nvcc.write_text(FAKE_NVCC.format(python=sys.executable))
        nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
        monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
        monkeypatch.delenv("FAKE_NVCC_VERSION", raising=False)
        monkeypatch.delenv("FAKE_NVCC_FAIL", raising=False)
        self.cap = "9.0"
        monkeypatch.setattr(aotbundle, "_capability",
                            lambda device=None: self.cap)
        aotbundle._compiler.cache_clear()
        self.dir = tmp_path / "bundles"
        aotbundle.configure(str(self.dir))
        aotbundle.reset()

    def compiler(self, line: str) -> None:
        self.mp.setenv("FAKE_NVCC_VERSION", line)
        aotbundle._compiler.cache_clear()

    def manifest(self) -> dict:
        return json.loads((self.path / "manifest.json").read_text())

    def write_manifest(self, doc) -> None:
        (self.path / "manifest.json").write_text(json.dumps(doc))

    @property
    def path(self):
        return self.dir / f"bundle-{aotbundle.bundle_version()}"


@pytest.fixture
def env(tmp_path, monkeypatch):
    e = Env(tmp_path, monkeypatch)
    yield e
    aotbundle.configure(None)
    aotbundle.reset()
    aotbundle._compiler.cache_clear()


def _stale(reason) -> float:
    return aotbundle._metrics()[1].value(reason=reason)


def _no_headers(monkeypatch):
    def refuse():
        raise AssertionError("a header was generated")

    monkeypatch.setattr(_build, "generated_headers", refuse)


def test_round_trip_absent_built_loaded(env, monkeypatch):
    before = {r: _stale(r) for r in ("version", "capability", "corrupt")}
    info = aotbundle.load()
    assert info["status"] == "absent" and info["kernels"] == 0
    assert info["path"] == str(env.path) == aotbundle.default_path()
    info = aotbundle.build()
    assert info["status"] == "built" and info["kernels"] == len(
        _build.KERNELS)
    doc = env.manifest()
    assert doc["version"] == aotbundle.bundle_version()
    assert doc["compiler"] == "Build cuda_stub.1" and doc["capability"] == "9.0"
    assert doc["fingerprint"] == aotbundle.fingerprint(
        doc["version"], "Build cuda_stub.1", "9.0")
    assert set(doc["kernels"]) == set(_build.KERNELS)
    assert doc["kernels"]["merkle_level"] == {
        "library": "libsha256.so", "entry": "merkle_level_launch"}
    assert set(doc["libraries"]) == {f"lib{_build._lib_name(s)}.so"
                                     for s in _build._sources()}
    assert {"ed25519_consts.h", "sha256_consts.h", "blsg1_consts.h",
            "build.log"} <= {f.name for f in env.path.iterdir()}
    assert _build.build_dir() == env.path
    assert "== sha256" in _build.build_log()
    # a warm start: the manifest checked, every entry bound, no header
    aotbundle.reset()
    _no_headers(monkeypatch)
    info = aotbundle.load()
    assert info["status"] == "loaded" and info["kernels"] == len(
        _build.KERNELS)
    assert info["compiler"] == "Build cuda_stub.1"
    assert {r: _stale(r) for r in before} == before
    for k in _build.KERNELS:
        assert aotbundle.lookup(k) is _build.load(k)
        assert aotbundle.lookup(k)(*[0] * len(_build.KERNELS[k][2])) == 0
    gauge = metrics.DEFAULT.collect()
    assert (f'crypto_compile_bundle_info{{status="loaded",version='
            f'"{aotbundle.bundle_version()}"}} {len(_build.KERNELS)}'
            in gauge)


def test_first_use_builds_once_then_loads(env, monkeypatch):
    """``_build.load`` builds a missing bundle at first use; a second
    process's first use (reset here) loads it without a build."""
    assert aotbundle.lookup("merkle_level") is None
    fn = _build.load("merkle_level")
    assert fn is aotbundle.lookup("merkle_level")
    assert aotbundle.info()["status"] == "built"
    aotbundle.reset()
    monkeypatch.setattr(_build, "_build_all",
                        lambda out: pytest.fail("built twice"))
    _no_headers(monkeypatch)
    _build.load("ed25519_tables")
    assert aotbundle.info()["status"] == "loaded"


def _built(env):
    aotbundle.build()
    aotbundle.reset()
    return env.manifest()


def test_stale_by_version_and_fingerprint(env):
    doc = _built(env)
    n = _stale("version")
    env.write_manifest({**doc, "version": "0" * 16})
    assert aotbundle.load()["status"] == "stale"
    assert _stale("version") == n + 1
    env.write_manifest({**doc, "fingerprint": "0" * 16})
    info = aotbundle.load()
    assert (info["status"], info["reason"]) == ("stale", "version")
    assert _stale("version") == n + 2
    assert aotbundle.lookup("merkle_level") is None
    # first use rebuilds in place, without counting it again
    _build.load("merkle_level")
    assert aotbundle.info()["status"] == "built"
    assert _stale("version") == n + 2
    assert env.manifest()["fingerprint"] == doc["fingerprint"]


def test_stale_by_capability_and_compiler(env):
    doc = _built(env)
    n_cap, n_ver = _stale("capability"), _stale("version")
    env.cap = "8.0"
    info = aotbundle.load()
    assert (info["status"], info["reason"]) == ("stale", "capability")
    assert _stale("capability") == n_cap + 1
    env.cap = "9.0"
    env.compiler("Build cuda_stub.2")
    info = aotbundle.load()
    assert (info["status"], info["reason"]) == ("stale", "version")
    assert _stale("version") == n_ver + 1
    assert aotbundle.build()["compiler"] == "Build cuda_stub.2"
    assert env.manifest()["fingerprint"] != doc["fingerprint"]
    aotbundle.reset()
    assert aotbundle.load()["status"] == "loaded"


def test_corrupt_manifest_or_library(env, monkeypatch):
    doc = _built(env)
    n = _stale("corrupt")
    opened = []
    real_cdll = ctypes.CDLL
    monkeypatch.setattr(aotbundle.ctypes, "CDLL",
                        lambda p: opened.append(p) or real_cdll(p))
    (env.path / "manifest.json").write_text("{not json")
    assert aotbundle.load()["status"] == "corrupt"
    env.write_manifest({k: v for k, v in doc.items() if k != "kernels"})
    assert aotbundle.load()["status"] == "corrupt"
    assert opened == []                 # the manifest comes first
    assert _stale("corrupt") == n + 2
    env.write_manifest(doc)
    lib = env.path / "libsha256.so"
    data = lib.read_bytes()

    def replace(raw):           # a new file: the old one may be mapped
        (env.path / "junk").write_bytes(raw)
        os.replace(env.path / "junk", lib)

    replace(data[:len(data) // 2])                      # truncated
    assert aotbundle.load()["status"] == "corrupt"
    assert opened == []
    assert aotbundle.lookup("merkle_level") is None
    _build.load("merkle_level")                         # rebuilt
    assert aotbundle.info()["status"] == "built"
    assert lib.read_bytes() == data
    # a library of the right size that does not load, in a copy of the
    # bundle (a path this process never opened: dlopen would hand back
    # the library it has open under the same name)
    copy = env.dir / "copy"
    shutil.copytree(env.path, copy)
    (copy / "libsha256.so").write_bytes(b"\0" * len(data))
    aotbundle.reset()
    info = aotbundle.load(str(copy))
    assert info["status"] == "corrupt" and _stale("corrupt") == n + 4
    assert str(copy / "libsha256.so") in opened


def test_failed_build_raises_and_nothing_falls_back(env, monkeypatch):
    monkeypatch.setenv("FAKE_NVCC_FAIL", "1")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        _build.load("ed25519_tables")
    assert aotbundle.info()["status"] == "build_failed"
    assert not (env.path / "manifest.json").exists()
    with pytest.raises(RuntimeError, match="nvcc failed"):   # again
        _build.load("ed25519_tables")


def _copy_tree(src, dst, files):
    for rel in files:
        (dst / rel).parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(src / rel, dst / rel)


@pytest.mark.parametrize("what", ["csrc", "generator", "fold_rows", "flags"])
def test_version_moves_with_every_input(tmp_path, monkeypatch, what):
    """One byte of a ``csrc/`` source, of a module the headers are
    generated from, ``FOLD_ROWS`` or ``FLAGS`` gives another version;
    the compiler and the capability another fingerprint."""
    _no_headers(monkeypatch)
    v0 = aotbundle.bundle_version()
    assert aotbundle.bundle_version() == v0
    if what == "csrc":
        csrc = tmp_path / "csrc"
        shutil.copytree(_build.CSRC, csrc)
        monkeypatch.setattr(_build, "CSRC", csrc)
        assert aotbundle.bundle_version() == v0
        f = csrc / "sha256.cu"
        f.write_bytes(f.read_bytes() + b" ")
    elif what == "generator":
        pkg = tmp_path / "pkg"
        _copy_tree(aotbundle._PKG, pkg, aotbundle.GENERATORS)
        monkeypatch.setattr(aotbundle, "_PKG", pkg)
        assert aotbundle.bundle_version() == v0
        f = pkg / "ops" / "fe.py"
        f.write_bytes(f.read_bytes() + b"\n")
    elif what == "fold_rows":
        monkeypatch.setattr(blsg1, "FOLD_ROWS", blsg1.FOLD_ROWS // 2)
    else:
        monkeypatch.setattr(_build, "FLAGS", _build.FLAGS + ["-lineinfo"])
    assert aotbundle.bundle_version() != v0
    fp = aotbundle.fingerprint(v0, "c", "9.0")
    assert len({fp, aotbundle.fingerprint(v0, "d", "9.0"),
                aotbundle.fingerprint(v0, "c", "8.0")}) == 3


def test_load_generates_no_header_and_is_cheap(env, monkeypatch):
    _built(env)
    _no_headers(monkeypatch)
    info = aotbundle.load()
    assert info["status"] == "loaded" and info["load_s"] < 1.0


# ------------------------------------------------------------ warmup


def test_warmup_on_the_device_thread_keeps_the_set_cache(monkeypatch):
    """Each shape launches the table, RLC and per-lane routes once on the
    device-owner thread; a real set's cached table survives, even with
    the cache full."""
    monkeypatch.setattr(tbatch, "RLC_MIN_LANES", 2)
    real = [np.full((3, 32), i, np.uint8) for i in range(
        tbatch.TABLE_CACHE_ENTRIES)]
    sentinel = {torch.device("cpu"): ("tab", "ok")}
    monkeypatch.setattr(tbatch, "_TABLES", {id(r): (r, dict(sentinel))
                                            for r in real})
    before = dict(tbatch._TABLES)
    threads = []
    route = tbatch._lane_route

    def spy(*a):
        threads.append(threading.current_thread().name)
        return route(*a)

    monkeypatch.setattr(tbatch, "_lane_route", spy)
    _build.PLAIN_CALLS.clear()
    n = tbatch.warmup_device(lane_buckets=(1, 2), device="cpu",
                             valset_sizes=(3,))
    assert n == 3
    assert all(t.startswith(tbatch.DEVICE_THREAD_NAME) for t in threads)
    assert len(threads) == 3
    assert tbatch._TABLES == before
    assert _build.PLAIN_CALLS["ed25519_tables"] == 3
    assert _build.PLAIN_CALLS["ed25519_rlc_gather"] == 2   # 2 and 3 lanes
    assert _build.PLAIN_CALLS["ed25519_verify_gather"] == 3


# --------------------------------------------------- the node and config


def test_node_warm_boot(env, monkeypatch, tmp_path):
    """``Node._warm_boot`` as it runs on a card, here on the CPU: the
    bundle built on a cold machine, loaded on a warm one, the warmup at
    one lane, ``RLC_MIN_LANES`` and the set's size; an error recorded,
    and the next device call builds again and raises."""
    from types import SimpleNamespace

    calls = []
    monkeypatch.setattr(tbatch, "warmup_device",
                        lambda **kw: calls.append(kw) or 3)
    vals = SimpleNamespace(validators=[0] * 7)
    cfg = t_config.Config()
    cfg.base.compile_bundle_dir = str(env.dir)
    node = SimpleNamespace(
        config=cfg, device="cpu", name="n0", compile_bundle_info=None,
        state_store=SimpleNamespace(
            load=lambda: SimpleNamespace(validators=vals)))
    Node._warm_boot(node)
    assert node.compile_bundle_info["status"] == "built"
    assert node.compile_bundle_info["warm_shapes"] == 3
    assert calls == [{"lane_buckets": (1, tbatch.RLC_MIN_LANES),
                      "device": torch.device("cpu"), "valset_sizes": (7,)}]
    aotbundle.reset()
    Node._warm_boot(node)
    assert node.compile_bundle_info["status"] == "loaded"
    assert aotbundle.info() is node.compile_bundle_info
    cfg.base.compile_bundle_enable = False
    Node._warm_boot(node)
    assert node.compile_bundle_info["status"] == "disabled"
    cfg.base.compile_bundle_enable = True
    cfg.base.compile_bundle_dir = str(tmp_path / "elsewhere")
    aotbundle.reset()
    monkeypatch.setenv("FAKE_NVCC_FAIL", "1")
    Node._warm_boot(node)
    assert node.compile_bundle_info["status"] == "error"
    assert "nvcc failed" in node.compile_bundle_info["error"]
    with pytest.raises(RuntimeError, match="nvcc failed"):
        _build.load("merkle_level")


def test_cpu_node_records_skipped_no_device(monkeypatch):
    from torch_node_fixtures import config, genesis, run

    monkeypatch.setattr(aotbundle, "load",
                        lambda **kw: pytest.fail("a bundle was loaded"))
    doc, pvs = genesis(1, chain_id="warm-net", tag=b"warm")

    async def main():
        from cometbft_tpu_torch.abci.kvstore import KVStoreApplication

        node = await Node.create(doc, KVStoreApplication(),
                                 priv_validator=pvs[0], config=config())
        try:
            await node.start(consensus=False)
            assert node.warm_boot is None
            assert node.compile_bundle_info == {"status":
                                                "skipped_no_device"}
        finally:
            await node.stop()

    _build.LAUNCHES.clear()
    run(main())
    assert sum(_build.LAUNCHES.values()) == 0
    assert 'crypto_compile_bundle_info{status="skipped_no_device"' in \
        metrics.DEFAULT.collect()
    cfg = config()
    cfg.base.device_warmup = False

    async def off():
        from cometbft_tpu_torch.abci.kvstore import KVStoreApplication

        node = await Node.create(doc, KVStoreApplication(),
                                 priv_validator=pvs[0], config=cfg)
        try:
            await node.start(consensus=False)
            assert node.compile_bundle_info is None
        finally:
            await node.stop()

    run(off())


def test_warm_boot_keys_round_trip_through_toml(tmp_path):
    base = t_config.BaseConfig()
    assert (base.device_warmup, base.compile_bundle_enable,
            base.compile_bundle_dir) == (True, True, "")
    for key in ("device_warmup", "compile_bundle_enable",
                "compile_bundle_dir"):
        assert ("base", key) not in t_config.IGNORED_KEYS
    cfg = t_config.Config()
    cfg.base.device_warmup = False
    cfg.base.compile_bundle_enable = False
    cfg.base.compile_bundle_dir = str(tmp_path / "b")
    path = str(tmp_path / "config.toml")
    cfg.save(path)
    text = open(path).read()
    assert "device_warmup = false" in text
    assert f'compile_bundle_dir = "{tmp_path / "b"}"' in text
    back = t_config.Config.load(path)
    assert back == cfg and back.base.compile_bundle_dir == str(tmp_path / "b")
    os.remove(path)
