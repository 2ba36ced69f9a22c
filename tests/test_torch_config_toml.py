"""The port's ``config.toml`` (``cometbft_tpu_torch/config.py``) against
the JAX package's (``cometbft_tpu/config.py:422-470``): a save/load
round trip, a file the JAX package wrote loading in the port with every
shared field equal, the named set of JAX-only keys the port drops, and
unknown keys, bad values and ``-o`` overrides (``cmd._apply_overrides``)
raising with the JAX package's messages and coercing to the same
values."""

import dataclasses

import pytest

import cometbft_tpu.cmd as j_cmd
import cometbft_tpu.config as j_config
import cometbft_tpu_torch.cmd as t_cmd
import cometbft_tpu_torch.config as t_config


def _fields(cfg) -> dict:
    return {(s.name, f.name): getattr(getattr(cfg, s.name), f.name)
            for s in dataclasses.fields(cfg)
            for f in dataclasses.fields(getattr(cfg, s.name))}


SHARED = sorted(set(_fields(t_config.Config())) & set(_fields(
    j_config.Config())))


def _perturbed(value):
    """A value of the field's type, other than its default, inside the
    bounds ``validate`` holds (None: keep the default)."""
    if isinstance(value, bool):
        return not value
    if isinstance(value, int):
        return value + 3
    if isinstance(value, float):
        return value + 1.5
    if isinstance(value, list):
        return value + ["x\"y"]
    return None


KEEP = {("base", "abci"), ("base", "proxy_app"), ("storage", "db_backend"),
        ("tx_index", "indexer"), ("p2p", "fuzz_mode"),
        ("mempool", "gossip_mode"), ("chaos", "enable"),
        ("chaos", "faults"), ("base", "root_dir")}


def _set_shared(cfg):
    """Every shared field set to a value other than its default."""
    for section, key in SHARED:
        if (section, key) in KEEP:
            continue
        old = getattr(getattr(cfg, section), key)
        new = _perturbed(old)
        if new is None:
            new = f"{section}-{key}-\\\"q"
        setattr(getattr(cfg, section), key, new)
    return cfg


def test_save_load_round_trip(tmp_path):
    cfg = _set_shared(t_config.Config())
    cfg.base.device = "cpu"
    cfg.validate()
    path = tmp_path / "config" / "config.toml"
    cfg.save(str(path))
    back = t_config.Config.load(str(path))
    assert back == cfg
    text = path.read_text()
    assert 'device = "cpu"' in text
    for (section, key) in t_config.IGNORED_KEYS:
        assert f"\n{key} = " not in text
    assert "batch_size" not in text


def test_jax_written_file_loads_with_equal_shared_fields(tmp_path):
    jcfg = _set_shared(j_config.Config())
    jcfg.base.signature_backend = "cpu"
    jcfg.base.min_device_lanes = 7
    jcfg.base.compile_bundle_dir = "/elsewhere"
    jcfg.mempool.broadcast = False
    jcfg.validate()
    path = str(tmp_path / "config.toml")
    jcfg.save(path)
    tcfg = t_config.Config.load(path)
    jf, tf = _fields(jcfg), _fields(tcfg)
    assert {k: tf[k] for k in SHARED} == {k: jf[k] for k in SHARED}
    assert tcfg.base.device == "cuda"        # the card unless told
    # the JAX loader reads its own file back alike
    assert _fields(j_config.Config.load(path)) == jf


def test_ignored_keys_are_the_jax_only_keys():
    jax_only = set(_fields(j_config.Config())) - set(_fields(
        t_config.Config()))
    assert set(t_config.IGNORED_KEYS) | {("blocksync", "batch_size")} == \
        jax_only
    assert all(isinstance(r, str) and r for r in
               t_config.IGNORED_KEYS.values())
    # the port's own keys the JAX loader refuses
    assert set(_fields(t_config.Config())) - set(_fields(
        j_config.Config())) == {("base", "device"), ("p2p", "pong_timeout")}


def test_port_written_file_refused_by_jax_loader(tmp_path):
    path = str(tmp_path / "config.toml")
    t_config.Config().save(path)
    with pytest.raises(j_config.ConfigError,
                       match="unknown config key base.device"):
        j_config.Config.load(path)


def test_deprecated_batch_size_loads_in_both(tmp_path):
    path = tmp_path / "config.toml"
    path.write_text("[blocksync]\nbatch_size = 128\nverify_window = 8\n")
    assert t_config.Config.load(str(path)).blocksync.verify_window == 8
    assert j_config.Config.load(str(path)).blocksync.verify_window == 8


@pytest.mark.parametrize("text", [
    "[bogus]\nx = 1\n",
    "[base]\nbogus = 1\n",
    "[p2p]\nladdr = \"tcp://127.0.0.1:1\"\nnot_a_key = true\n",
    "[mempool]\nsize = 0\n",
    "[consensus]\ntimeout_commit = -1\n",
    "[storage]\ndb_backend = \"rocks\"\n",
    "[blocksync]\nverify_window = 1\n",
    "[rpc]\nmax_concurrent_requests = 0\n",
    "[p2p]\nquality_ban_score = 1.0\n",
    "[lightserve]\nmax_batch = 0\n",
    "[instrumentation]\ntracing_ring_size = 8\n",
    "[base]\nabci = \"http\"\n",
    "[tx_index]\nindexer = \"psql\"\n",
    "[tx_index]\nindexer = \"sql\"\n",
])
def test_bad_files_raise_the_jax_messages(tmp_path, text):
    path = str(tmp_path / "config.toml")
    with open(path, "w") as f:
        f.write(text)
    errs = []
    for C in (j_config, t_config):
        with pytest.raises(C.ConfigError) as e:
            C.Config.load(path)
        errs.append(str(e.value))
    assert errs[0] == errs[1]


def test_port_refuses_what_it_does_not_serve(tmp_path):
    """The gRPC app and the SQL sink: both loaders accept the keys, and
    read the same values."""
    for text, key in (("[base]\nabci = \"grpc\"\nproxy_app = "
                       "\"tcp://127.0.0.1:26658\"\n", ("base", "abci")),
                      ("[tx_index]\nindexer = \"psql\"\npsql_conn = "
                       "\"postgres://x/y\"\n", ("tx_index", "indexer"))):
        path = str(tmp_path / "config.toml")
        with open(path, "w") as f:
            f.write(text)
        jf = _fields(j_config.Config.load(path))
        tf = _fields(t_config.Config.load(path))
        assert {k: tf[k] for k in SHARED} == {k: jf[k] for k in SHARED}
        assert tf[key] in ("grpc", "psql")


OVERRIDES = [
    ["consensus.timeout_commit=500000000"],
    ["rpc.laddr=tcp://0.0.0.0:26657", "p2p.pex=false"],
    ["p2p.pex=1", "p2p.seed_mode=true", "mempool.coalesce_ms=2"],
    ["rpc.cors_allowed_origins=a.example, *.b.example ,",
     "statesync.rpc_servers=h1:1,h2:2"],
    ["blocksync.verify_window=64", "blocksync.enable=false",
     "base.moniker=val 1"],
    ["instrumentation.watchdog_stall_threshold_s=0",
     "storage.doctor_deep_scan_window=0"],
    ["p2p.fuzz_prob_drop_rw=0.25", "chaos.seed=42"],
]


@pytest.mark.parametrize("options", OVERRIDES)
def test_overrides_coerce_alike(options):
    jcfg, tcfg = j_config.Config(), t_config.Config()
    j_cmd._apply_overrides(jcfg, options)
    t_cmd._apply_overrides(tcfg, options)
    jf, tf = _fields(jcfg), _fields(tcfg)
    assert {k: tf[k] for k in SHARED} == {k: jf[k] for k in SHARED}
    assert {k: tf[k] for k in SHARED} != {
        k: v for k, v in _fields(t_config.Config()).items() if k in SHARED}


BAD_OVERRIDES = [
    ["nonsense"], ["base.bogus=1"], ["bogus.key=1"], ["consensus=3"],
    ["consensus.timeout_commit=abc"], ["p2p.pex=maybe"],
    ["mempool.size=0"], ["mempool.coalesce_ms=fast"],
    ["blocksync.verify_window=9999"], ["storage.db_backend=rocks"],
    ["p2p.fuzz_mode=sometimes"], [".x=1"],
]


@pytest.mark.parametrize("options", BAD_OVERRIDES)
def test_bad_overrides_raise_the_jax_messages(options):
    errs = []
    for C, cmd in ((j_config, j_cmd), (t_config, t_cmd)):
        with pytest.raises(C.ConfigError) as e:
            cmd._apply_overrides(C.Config(), options)
        errs.append(str(e.value))
    assert errs[0] == errs[1]


def test_pong_timeout_key():
    """The port's pong deadline: 45 s by default, read from the file and
    from ``-o``, held positive."""
    cfg = t_config.Config()
    assert cfg.p2p.pong_timeout == 45.0
    t_cmd._apply_overrides(cfg, ["p2p.pong_timeout=7"])
    assert cfg.p2p.pong_timeout == 7.0
    cfg.p2p.pong_timeout = 0
    with pytest.raises(t_config.ConfigError, match="p2p.pong_timeout"):
        cfg.validate()


def test_device_override_and_refused_device_free_keys():
    cfg = t_config.Config()
    t_cmd._apply_overrides(cfg, ["base.device=cpu"])
    assert cfg.base.device == "cpu"
    with pytest.raises(t_config.ConfigError,
                       match="unknown config key 'base.signature_backend'"):
        t_cmd._apply_overrides(t_config.Config(),
                               ["base.signature_backend=cpu"])


def test_node_switch_takes_the_pong_timeout():
    """A node's MConnections wait ``p2p.pong_timeout`` for a pong: 7 s
    where the file says 7, upstream's 45 s by default."""
    import asyncio

    import torch_node_fixtures as tnf

    async def main():
        doc, pvs = tnf.genesis(1, chain_id="pong-net", tag=b"pong")
        out = []
        for timeout in (7, None):
            cfg = tnf.config(db_backend="memdb")
            if timeout is not None:
                t_cmd._apply_overrides(cfg, [f"p2p.pong_timeout={timeout}"])
            node = await tnf.make_node(doc, pvs[0], 0, config_=cfg)
            out.append(node.switch.pong_timeout)
            await node.stop()
        return out

    assert asyncio.run(main()) == [7.0, 45.0]
