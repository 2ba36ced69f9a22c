"""Command-line interface (counterpart of ``cometbft_tpu/cmd/__init__.py``;
reference: ``cmd/cometbft/main.go:16-46`` and ``cmd/cometbft/commands/``):
init, start, testnet, key tooling, reset and rollback, the offline store
tools, the load generator, the signer, inspect and light daemons, and the
e2e runner, with argparse in place of cobra.

Run as ``python -m cometbft_tpu_torch <command>``.  Every command that
checks signatures runs on the card unless told otherwise: ``start`` on
``base.device`` (``"cuda"`` by default), ``light`` and ``e2e``'s nodes on
the card.  The top-level ``--device`` (``--device cpu`` runs the
kernels' plain versions, as the tests do) overrides it for the command;
``start`` also takes ``-o base.device=cpu``.  A node that cannot reach
its device raises at ``Node.create`` and the process exits non-zero.
``abci kvstore --grpc`` serves the kvstore over the port's own gRPC.
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import json
import os
import shutil
import signal
import sys

VERSION = "0.2.0"        # framework version (version/version.go analogue)


# ------------------------------------------------------------ home layout

def _cfg_path(home: str) -> str:
    return os.path.join(home, "config", "config.toml")


def _load_home(home: str):
    from ..config import Config

    cfg = Config.load(_cfg_path(home))
    cfg.base.root_dir = home
    return cfg


def _apply_overrides(cfg, options: list[str]) -> None:
    """--option section.key=value config overrides (the reference binds a
    cobra flag per config field; one generic repeatable flag covers the
    same surface).  Values coerce to the field's current type; raises
    ConfigError on unknown keys or bad values."""
    import dataclasses

    from ..config import ConfigError

    sections = {f.name for f in dataclasses.fields(cfg)}
    for opt in options:
        path, sep, raw = opt.partition("=")
        section_name, dot, key = path.strip().partition(".")
        if not sep or not dot or not key:
            raise ConfigError(f"bad --option {opt!r}: expected "
                              f"section.key=value")
        if section_name not in sections:
            raise ConfigError(f"unknown config key {path!r}")
        section = getattr(cfg, section_name)
        field_types = {f.name: f.type for f in dataclasses.fields(section)}
        if key not in field_types:
            raise ConfigError(f"unknown config key {path!r}")
        # coerce by the declared field type, not the runtime value (a
        # hand-edited TOML int in a float field must not flip the rule)
        ftype = str(field_types[key])
        try:
            if ftype == "bool":
                if raw.lower() not in ("true", "false", "1", "0"):
                    raise ValueError("expected true|false")
                value = raw.lower() in ("true", "1")
            elif ftype == "int":
                value = int(raw)
            elif ftype == "float":
                value = float(raw)
            elif ftype.startswith("list"):
                value = [s.strip() for s in raw.split(",") if s.strip()]
            else:
                value = raw
        except ValueError as e:
            raise ConfigError(f"bad value for {path!r}: {e}") from e
        setattr(section, key, value)
    if options:
        cfg.validate()


def _join(home: str, rel: str) -> str:
    return rel if os.path.isabs(rel) else os.path.join(home, rel)


# ---------------------------------------------------------------- commands

def cmd_init(args) -> int:
    """commands/init.go InitFilesCmd: config + genesis + keys."""
    from ..config import Config
    from ..p2p import NodeKey
    from ..privval import FilePV
    from ..types.genesis import GenesisDoc, GenesisValidator

    home = args.home
    os.makedirs(os.path.join(home, "config"), exist_ok=True)
    os.makedirs(os.path.join(home, "data"), exist_ok=True)

    cfg = Config()
    cfg.base.moniker = args.moniker
    if not os.path.exists(_cfg_path(home)):
        cfg.save(_cfg_path(home))

    nk = NodeKey.load_or_gen(_join(home, cfg.base.node_key_file))
    pv = FilePV.load_or_generate(
        _join(home, cfg.base.priv_validator_key_file),
        _join(home, cfg.base.priv_validator_state_file),
        key_type=getattr(args, "key_type", "ed25519"))

    gen_path = _join(home, cfg.base.genesis_file)
    if not os.path.exists(gen_path):
        import time

        doc = GenesisDoc(
            chain_id=args.chain_id or f"test-chain-{nk.id[:6]}",
            genesis_time_ns=time.time_ns(),
            validators=[GenesisValidator(pv.get_pub_key(), 10,
                                         cfg.base.moniker, pop=pv.pop())])
        doc.save(gen_path)
    print(f"Initialized node in {home} (node id {nk.id})")
    return 0


def cmd_start(args) -> int:
    """commands/run_node.go: assemble and run the node."""
    return asyncio.run(_start_async(args))


async def _start_async(args) -> int:
    from ..abci.kvstore import KVStoreApplication
    from ..node import Node
    from ..p2p import NodeKey
    from ..privval import FilePV
    from ..types.genesis import GenesisDoc

    from ..config import ConfigError

    home = args.home
    cfg = _load_home(home)
    if args.device is not None:
        cfg.base.device = args.device
    try:
        _apply_overrides(cfg, getattr(args, "option", []))
    except ConfigError as e:
        print(f"{e}", file=sys.stderr)
        return 1
    doc = GenesisDoc.load(_join(home, cfg.base.genesis_file))
    nk = NodeKey.load_or_gen(_join(home, cfg.base.node_key_file))
    signer_listener = None
    if cfg.base.priv_validator_laddr:
        # node listens; the remote signer process dials in
        # (privval/signer_listener_endpoint.go)
        from ..privval.signer import SignerListener

        lhost, _, lport = (cfg.base.priv_validator_laddr
                           .removeprefix("tcp://").rpartition(":"))
        if not lport.isdigit():
            print(f"bad priv_validator_laddr "
                  f"{cfg.base.priv_validator_laddr!r}: expected host:port",
                  file=sys.stderr)
            return 1
        from ..privval.signer import RemoteSignerError

        signer_listener = SignerListener(
            timeout_s=cfg.base.priv_validator_timeout_s)
        await signer_listener.listen(lhost or "127.0.0.1", int(lport))
        print(f"Waiting for remote signer on "
              f"{cfg.base.priv_validator_laddr} ...")
        try:
            await signer_listener.wait_for_signer(timeout=120.0)
        except RemoteSignerError as e:
            print(str(e), file=sys.stderr)
            return 1
        # the listener itself is the PrivValidator: it re-accepts the
        # signer's redial if the connection drops
        pv = signer_listener
    else:
        pv = FilePV.load_or_generate(
            _join(home, cfg.base.priv_validator_key_file),
            _join(home, cfg.base.priv_validator_state_file))

    app = None
    if cfg.base.abci == "builtin":
        if cfg.base.proxy_app not in ("kvstore", ""):
            print(f"unknown builtin app {cfg.base.proxy_app!r}",
                  file=sys.stderr)
            return 1
        app = KVStoreApplication(device=cfg.base.device)

    state_sync_provider = None
    if cfg.statesync.enable:
        # config-driven snapshot bootstrap (statesync.rpc_servers +
        # trust anchor -> light-client-verified state provider;
        # node/setup.go's stateProvider wiring)
        from ..light import Client, TrustOptions
        from ..light.rpc_provider import RPCProvider
        from ..statesync import StateProvider

        servers = [s.strip() for s in cfg.statesync.rpc_servers
                   if s.strip()]
        if (not servers or cfg.statesync.trust_height <= 0
                or not cfg.statesync.trust_hash):
            print("statesync.enable requires rpc_servers, trust_height "
                  "> 0, and trust_hash", file=sys.stderr)
            return 1
        try:
            trust_hash = bytes.fromhex(cfg.statesync.trust_hash)
        except ValueError:
            print(f"bad statesync.trust_hash "
                  f"{cfg.statesync.trust_hash!r}: expected hex",
                  file=sys.stderr)
            return 1

        providers = []
        for i, srv in enumerate(servers):
            try:
                h, pt, tls, _verify = _parse_rpc_addr(srv)
            except ValueError as e:
                print(f"statesync.rpc_servers: {e}", file=sys.stderr)
                raise SystemExit(1) from e
            providers.append(RPCProvider(h, pt, f"ss{i}", tls=tls))
        light = Client(
            doc.chain_id,
            TrustOptions(cfg.statesync.trust_period,
                         cfg.statesync.trust_height,
                         trust_hash),
            providers[0], witnesses=providers[1:],
            device=cfg.base.device)
        state_sync_provider = StateProvider(light, doc)

    node = await Node.create(doc, app, priv_validator=pv, config=cfg,
                             node_key=nk, home=home,
                             fast_sync=cfg.blocksync.enable,
                             state_sync_provider=state_sync_provider,
                             name=cfg.base.moniker)
    await node.start()
    print(f"Node {nk.id} started: p2p {node.listen_addr}, "
          f"rpc {node.rpc_addr}", flush=True)

    dial_tasks = [asyncio.create_task(dial_until_up(node, a.strip(), True))
                  for a in cfg.p2p.persistent_peers.split(",") if a.strip()]
    dial_tasks += [asyncio.create_task(dial_until_up(node, a.strip(), False))
                   for a in cfg.p2p.seeds.split(",") if a.strip()]

    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, stop.set)

    # goroutine-dump analogue (cmd/cometbft/commands/debug captures
    # goroutine stacks): SIGUSR1 -> native thread stacks, SIGUSR2 ->
    # asyncio task summaries, both to stderr without stopping the node
    import faulthandler

    faulthandler.register(signal.SIGUSR1, all_threads=True)

    def _dump_tasks() -> None:
        tasks = asyncio.all_tasks(loop)
        print(f"=== {len(tasks)} asyncio tasks ===", file=sys.stderr)
        for t in sorted(tasks, key=lambda t: t.get_name()):
            frames = t.get_stack()
            where = ""
            if frames:
                f = frames[-1]
                where = f" at {f.f_code.co_filename}:{f.f_lineno} " \
                        f"({f.f_code.co_name})"
            print(f"--- {t.get_name()}{where}", file=sys.stderr)
        sys.stderr.flush()

    loop.add_signal_handler(signal.SIGUSR2, _dump_tasks)
    await stop.wait()
    print("shutting down...", flush=True)
    for t in dial_tasks:
        t.cancel()
    await node.stop()
    if signer_listener is not None:
        await signer_listener.close()
    return 0


async def dial_until_up(node, addr: str, persistent: bool) -> None:
    """Dial ``addr`` until it answers: peers boot in any order
    (switch.go's persistent-peer reconnect, for the first dial).  A
    persistent peer stays redialled by the switch; a seed is dialled
    once, to fill the address book, after which pex goes on.  A peer
    that dialled first ("duplicate peer") counts as reached."""
    delay = 0.5
    for _ in range(30):
        try:
            await node.dial_peer(addr, persistent=persistent)
            return
        except Exception as e:
            if "duplicate peer" in str(e):
                return
            await asyncio.sleep(delay)
            delay = min(delay * 1.5, 5.0)
    if persistent:
        print(f"giving up dialing {addr}", file=sys.stderr)


def cmd_testnet(args) -> int:
    """commands/testnet.go: N wired node homes under one directory."""
    from ..e2e.gen import HomeSpec, generate_homes

    n = args.v
    specs = [HomeSpec(name=f"node{i}",
                      p2p_port=args.base_port + 2 * i,
                      rpc_port=args.base_port + 2 * i + 1,
                      power=10)
             for i in range(n)]
    generate_homes(args.output_dir, specs,
                   args.chain_id or "testnet")
    print(f"Generated {n}-node testnet in {args.output_dir} "
          f"(ports {args.base_port}..{args.base_port + 2 * n - 1})")
    return 0


def cmd_gen_validator(args) -> int:
    from ..crypto.keys import gen_priv_key

    sk = gen_priv_key(getattr(args, "key_type", "ed25519"))
    print(json.dumps({
        "address": sk.pub_key().address().hex(),
        "type": sk.pub_key().type(),
        "pub_key": sk.pub_key().bytes().hex(),
        "priv_key": sk.bytes().hex()}, indent=2))
    return 0


def cmd_gen_node_key(args) -> int:
    from ..p2p import NodeKey

    path = os.path.join(args.home, "config", "node_key.json")
    nk = NodeKey.load_or_gen(path)
    print(nk.id)
    return 0


def cmd_show_node_id(args) -> int:
    cfg = _load_home(args.home)
    from ..p2p import NodeKey

    nk = NodeKey.load(_join(args.home, cfg.base.node_key_file))
    print(nk.id)
    return 0


def cmd_show_validator(args) -> int:
    cfg = _load_home(args.home)
    from ..privval import FilePV

    pv = FilePV.load(_join(args.home, cfg.base.priv_validator_key_file),
                     _join(args.home, cfg.base.priv_validator_state_file))
    pub = pv.get_pub_key()
    print(json.dumps({"type": pub.type(), "value": pub.bytes().hex()}))
    return 0


def cmd_unsafe_reset_all(args) -> int:
    """commands/reset.go: wipe data, keep keys; reset signer state."""
    home = args.home
    data = os.path.join(home, "data")
    if os.path.isdir(data):
        with _data_dir_locked(home):  # refuse to rmtree under a node
            shutil.rmtree(data)
    os.makedirs(data, exist_ok=True)
    cfg = _load_home(home)
    state_file = _join(home, cfg.base.priv_validator_state_file)
    key_file = _join(home, cfg.base.priv_validator_key_file)
    if os.path.exists(key_file):
        from ..privval import FilePV, SignStateError

        try:
            pv = FilePV.load(key_file, state_file)
        except SignStateError:
            # the operator EXPLICITLY asked for the reset: a corrupt
            # state file must not block the one command whose job is
            # resetting it (elsewhere that error is a hard refusal)
            print(f"WARNING: discarding corrupt sign state {state_file}",
                  file=sys.stderr)
            os.unlink(state_file)
            pv = FilePV.load(key_file, state_file)
        pv.height = pv.round = pv.step = 0
        pv.signature = pv.sign_bytes = pv.ext_signature = b""
        pv._save_state()
    print(f"Reset {data} (node + validator keys kept)")
    return 0


def cmd_rollback(args) -> int:
    """commands/rollback.go: undo the latest state transition."""
    from ..storage import BlockStore, StateStore
    from ..storage.statestore import rollback_state

    home = args.home
    cfg = _load_home(home)
    with _data_dir_locked(home, cfg.storage.db_backend) as data_db:
        try:
            new_state = rollback_state(
                StateStore(data_db("state.db")),
                BlockStore(data_db("blockstore.db")),
                remove_block=args.hard)
        except Exception as e:
            print(f"rollback failed: {e}", file=sys.stderr)
            return 1
    print(f"Rolled back state to height {new_state.last_block_height} "
          f"app_hash {new_state.app_hash.hex()}")
    return 0


def _parse_rpc_addr(addr: str) -> tuple[str, int, bool, bool]:
    """[scheme://]host:port -> (host, port, tls, tls_verify).  Schemes:
    http / tcp / bare (plaintext), https (TLS, verified — the reference
    client's default), https+insecure (TLS, accept self-signed).  Raises
    ValueError naming the ORIGINAL string on a missing port."""
    orig = addr
    tls = verify = False
    if addr.startswith("https+insecure://"):
        tls, verify = True, False
        addr = addr.removeprefix("https+insecure://")
    elif addr.startswith("https://"):
        tls = verify = True
        addr = addr.removeprefix("https://")
    else:
        addr = addr.removeprefix("http://").removeprefix("tcp://")
    host, _, port = addr.rpartition(":")
    if not port.isdigit():
        raise ValueError(f"bad address {orig!r}: expected "
                         "[scheme://]host:port")
    return host or "127.0.0.1", int(port), tls, verify


def _rpc_client(addr: str):
    """addr per _parse_rpc_addr; https verifies certificates, the
    https+insecure scheme accepts a node's self-signed cert."""
    from ..rpc.client import HTTPClient

    host, port, tls, verify = _parse_rpc_addr(addr)
    return HTTPClient(host, port, tls=tls, tls_verify=verify)


@contextlib.contextmanager
def _data_dir_locked(home: str, backend: str = "logdb"):
    """Exclusive lock for offline tooling, held while the block runs:
    refuses while a node runs on this home (a live LogDB must never be
    reopened or compacted under it).  Yields a function that opens a
    ``backend`` store of the home's data dir by file name, each closed
    before the lock is released."""
    from ..storage import open_db
    from ..storage.db import DataDirLock

    try:
        lock = DataDirLock(os.path.join(home, "data"))
    except RuntimeError as e:
        print(e, file=sys.stderr)
        raise SystemExit(1) from None
    opened = []

    def data_db(name: str):
        db = open_db(backend, os.path.join(home, "data", name))
        opened.append(db)
        return db

    try:
        yield data_db
    finally:
        for db in opened:
            db.close()
        lock.release()


def cmd_load(args) -> int:
    """test/loadtime generator: timestamped txs at a fixed rate."""
    from .. import loadtime

    async def go():
        client = _rpc_client(args.rpc)
        out = await loadtime.generate(client, args.rate, args.duration,
                                      tx_size=args.size,
                                      connections=args.connections)
        print(json.dumps(out))

    asyncio.run(go())
    return 0


def cmd_load_report(args) -> int:
    """test/loadtime/report: per-tx latency from committed chain data."""
    from .. import loadtime

    async def go():
        client = _rpc_client(args.rpc)
        out = await loadtime.report(client, run_id=args.run_id)
        print(json.dumps(out))

    asyncio.run(go())
    return 0


def cmd_reindex_event(args) -> int:
    """commands/reindex_event.go: rebuild the tx + block indexes offline
    from the block store and the saved FinalizeBlock responses."""
    from ..indexer.block import BlockIndexer
    from ..indexer.tx import TxIndexer
    from ..mempool.mempool import TxKey
    from ..sm.execution import unpack_finalize_response
    from ..storage import BlockStore, StateStore
    from ..types import events as ev

    home = args.home
    cfg = _load_home(home)
    with _data_dir_locked(home, cfg.storage.db_backend) as data_db:
        bs = BlockStore(data_db("blockstore.db"))
        ss = StateStore(data_db("state.db"))
        tx_ix = TxIndexer(data_db("tx_index.db"))
        blk_ix = BlockIndexer(data_db("block_index.db"))
        start = args.start_height or bs.base()
        end = args.end_height or bs.height()
        if start < bs.base() or end > bs.height() or start > end:
            print(f"height range [{start},{end}] outside stored "
                  f"[{bs.base()},{bs.height()}]", file=sys.stderr)
            return 1
        done = 0
        for h in range(start, end + 1):
            block = bs.load_block(h)
            raw = ss.load_finalize_block_response(h)
            if block is None or raw is None:
                print(f"skipping height {h}: "
                      f"{'no block' if block is None else 'no ABCI response'}",
                      file=sys.stderr)
                continue
            resp = unpack_finalize_response(raw)
            blk_ix.index(h, resp.events)
            for i, tx in enumerate(block.data.txs):
                tx = bytes(tx)
                res = resp.tx_results[i] if i < len(resp.tx_results) \
                    else None
                if res is None:
                    continue
                tx_ix.index(h, i, tx, res,
                            {ev.TX_HASH_KEY: TxKey(tx).hex(),
                             ev.TX_HEIGHT_KEY: str(h)})
            done += 1
    print(f"Reindexed {done} blocks [{start},{end}]")
    return 0


def cmd_compact_db(args) -> int:
    """commands/compact.go analogue: force-compact the data-dir stores
    (LogDB rewrites live records; other backends no-op)."""
    cfg = _load_home(args.home)
    total = 0
    with _data_dir_locked(args.home, cfg.storage.db_backend) as data_db:
        for name in ("blockstore.db", "state.db", "evidence.db",
                     "tx_index.db", "block_index.db"):
            path = os.path.join(args.home, "data", name)
            if not os.path.exists(path):
                continue
            before = os.path.getsize(path) if os.path.isfile(path) else 0
            db = data_db(name)
            compact = getattr(db, "_compact", None) or getattr(
                db, "compact", None)
            if compact is not None:
                compact()
            db.close()
            after = os.path.getsize(path) if os.path.isfile(path) else 0
            total += max(0, before - after)
            print(f"{name}: {before} -> {after} bytes")
    print(f"Reclaimed {total} bytes")
    return 0


def cmd_doctor(args) -> int:
    """Offline storage integrity doctor (node/doctor.py): the boot
    cross-store consistency check plus an unconditional deep hash-chain
    scan over the data dir, report-only by default, repairing with
    ``--repair``.  Exit 0 when healthy (or fully repaired), 1 when
    problems remain."""
    from ..node.doctor import StorageDoctor
    from ..storage import BlockStore, StateStore

    home = args.home
    cfg = _load_home(home)
    with _data_dir_locked(home, cfg.storage.db_backend) as data_db:
        bs = BlockStore(data_db("blockstore.db"))
        ss = StateStore(data_db("state.db"))
        doctor = StorageDoctor(
            bs, ss,
            wal_path=_join(home, cfg.consensus.wal_path),
            privval_state_path=_join(home,
                                     cfg.base.priv_validator_state_file),
            deep_scan_window=cfg.storage.doctor_deep_scan_window)
        # the offline tool always walks the chain (force_deep):
        # boot_check sequences it before the WAL-lineage check so a
        # truncating repair is immediately followed by the matching WAL
        # quarantine
        report = doctor.boot_check(repair=args.repair,
                                   raise_on_refusal=False,
                                   force_deep=True,
                                   deep_window=args.window)
        if args.repair and report.refused is None and \
                report.deep_scan is not None and report.deep_scan.get("ok"):
            bs.clear_dirty()
            fn = getattr(ss.db, "clear_dirty", None)
            if fn is not None:
                fn()
        if report.refused is None and report.deep_scan is not None and \
                not report.deep_scan.get("ok"):
            report.ok = False
    print(json.dumps(report.to_dict(), indent=2))
    return 0 if report.ok else 1


def cmd_e2e_gen(args) -> int:
    """test/e2e/generator analogue: emit deterministic random manifests;
    each failure reproduces from its seed alone."""
    from ..e2e.generator import generate_manifest
    from ..e2e.manifest import manifest_to_toml

    os.makedirs(args.output_dir, exist_ok=True)
    for seed in range(args.seed, args.seed + args.runs):
        m = generate_manifest(seed, compact=args.compact)
        path = _join(args.output_dir, f"gen-{seed:05d}.toml")
        with open(path, "w") as f:
            f.write(manifest_to_toml(m))
        print(f"{path}: {len(m.nodes)} nodes, final_height "
              f"{m.final_height}")
    return 0


def cmd_e2e(args) -> int:
    """test/e2e/runner analogue: run a manifest-described testnet of OS
    processes, apply its perturbation schedule, check invariants."""
    from ..e2e import Runner, RunnerError, load_manifest

    if not args.manifest:
        print("--manifest is required (generate one with e2e-gen)",
              file=sys.stderr)
        return 1
    try:
        manifest = load_manifest(args.manifest)
    except Exception as e:
        print(f"bad manifest: {e}", file=sys.stderr)
        return 1
    try:
        runner = Runner(manifest, args.dir, base_port=args.base_port,
                        device=args.device)
    except RunnerError as e:
        print(f"e2e FAILED: {e}", file=sys.stderr)
        return 1
    runner.setup()
    try:
        report = asyncio.run(runner.run(deadline_s=args.deadline))
        print(json.dumps(report, indent=2))
        return 0
    except RunnerError as e:
        print(f"e2e FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        runner.stop()


def cmd_debug_wal(args) -> int:
    """scripts/wal2json analogue: dump consensus WAL records as JSON
    lines.  Strictly read-only — safe on a crashed node's torn WAL (the
    node's own open would truncate the torn tail; this never writes)."""
    import json as _json

    cfg = _load_home(args.home)
    from ..consensus.wal import WALError, iter_wal_records_readonly
    from ..rpc.json import _hexify

    n = 0
    try:
        for rec in iter_wal_records_readonly(
                _join(args.home, cfg.consensus.wal_path)):
            print(_json.dumps(_hexify(rec)))
            n += 1
    except WALError as e:
        print(f"# {n} records", file=sys.stderr)
        print(f"error: {e}", file=sys.stderr)
        return 1
    print(f"# {n} records", file=sys.stderr)
    return 0


def _debug_collect(rpc: str, home: str, out_dir: str) -> None:
    """Shared capture core for ``debug dump``/``debug kill``: node
    introspection over RPC when the node is up, plus config and WAL/data
    listings from the home directory."""
    os.makedirs(out_dir, exist_ok=True)

    async def fetch_rpc():
        client = _rpc_client(rpc)
        for route in ("status", "net_info", "consensus_state",
                      "dump_consensus_state", "num_unconfirmed_txs",
                      "dump_incidents"):
            try:
                out = await asyncio.wait_for(client.call(route), 5)
                with open(os.path.join(out_dir, f"{route}.json"), "w") as f:
                    json.dump(out, f, indent=2, default=str)
            except Exception as e:
                with open(os.path.join(out_dir, f"{route}.err"), "w") as f:
                    f.write(repr(e))

    asyncio.run(fetch_rpc())

    if os.path.isdir(home):
        cfgp = _cfg_path(home)
        if os.path.exists(cfgp):
            shutil.copy(cfgp, os.path.join(out_dir, "config.toml"))
        listing = []
        for root, _dirs, files in os.walk(os.path.join(home, "data")):
            for fn in files:
                p = os.path.join(root, fn)
                listing.append(f"{os.path.getsize(p):>12} {p}")
        with open(os.path.join(out_dir, "data_listing.txt"), "w") as f:
            f.write("\n".join(listing))
        wal_dir = os.path.join(home, "data", "cs.wal")
        wal_file = wal_dir if os.path.isfile(wal_dir) else None
        if os.path.isdir(wal_dir):
            segs = sorted(os.listdir(wal_dir))
            if segs:
                wal_file = os.path.join(wal_dir, segs[-1])
        if wal_file and os.path.isfile(wal_file):
            shutil.copy(wal_file, os.path.join(out_dir, "wal_tail.bin"))


def _debug_tar(out_dir: str, tar_path: str | None = None) -> str:
    import tarfile

    tar_path = tar_path or out_dir.rstrip("/") + ".tar.gz"
    with tarfile.open(tar_path, "w:gz") as tar:
        tar.add(out_dir, arcname=os.path.basename(
            out_dir.rstrip("/")) or "debug")
    return tar_path


def cmd_debug_dump(args) -> int:
    """commands/debug: capture a post-mortem bundle — node introspection
    over RPC when the node is up, plus config and WAL/data listings."""
    import time as _time

    out_dir = args.output_dir or f"debug-dump-{int(_time.time())}"
    _debug_collect(args.rpc, args.home, out_dir)
    print(f"Debug bundle written to {_debug_tar(out_dir)}")
    return 0


def cmd_debug_kill(args) -> int:
    """commands/debug/kill.go: aggregate a RUNNING node's state — RPC
    dumps, config, WAL tail, /proc process state — trigger its in-process
    stack dumps (SIGUSR1 thread stacks + SIGUSR2 asyncio tasks, the
    goroutine-dump analogue, written to the node's stderr), terminate it,
    and package everything into one archive."""
    import signal as _signal
    import tempfile
    import time as _time

    pid = args.pid
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        print(f"no such process: {pid}", file=sys.stderr)
        return 1
    except PermissionError:
        print(f"not permitted to signal pid {pid}", file=sys.stderr)
        return 1

    out_dir = tempfile.mkdtemp(prefix="cometbft-debug-kill-")
    # 1. live node state over RPC + home files (while it still answers)
    _debug_collect(args.rpc, args.home, out_dir)

    # 2. kernel-side process state — capturable from OUTSIDE the process
    proc_info = []
    for name in ("cmdline", "status", "wchan", "io", "limits"):
        try:
            with open(f"/proc/{pid}/{name}", "rb") as f:
                data = f.read().replace(b"\x00", b" ")
            proc_info.append(f"--- /proc/{pid}/{name}\n"
                             + data.decode(errors="replace"))
        except OSError as e:
            proc_info.append(f"--- /proc/{pid}/{name}: {e!r}")
    try:
        tids = os.listdir(f"/proc/{pid}/task")
        proc_info.append(f"--- threads: {len(tids)}")
        fds = os.listdir(f"/proc/{pid}/fd")
        proc_info.append(f"--- open fds: {len(fds)}")
    except OSError:
        pass
    with open(os.path.join(out_dir, "proc_state.txt"), "w") as f:
        f.write("\n".join(proc_info))

    # 3. ask the node to dump its own stacks to ITS stderr/log, then
    #    stop it (SIGTERM is the graceful path; SIGKILL after a grace
    #    period so a wedged node still dies, like kill.go's guarantee)
    for sig in (_signal.SIGUSR1, _signal.SIGUSR2):
        try:
            os.kill(pid, sig)
        except OSError:
            pass
    _time.sleep(1.0)         # give the handlers a beat to write
    try:
        os.kill(pid, _signal.SIGTERM)
    except OSError:
        pass
    def _gone() -> bool:
        # os.kill(pid, 0) stays happy on a ZOMBIE (exited but unreaped
        # under a supervisor), which would burn the whole grace period
        # and misreport SIGKILL — read the state from /proc instead
        try:
            with open(f"/proc/{pid}/stat") as f:
                return f.read().rsplit(")", 1)[1].split()[0] == "Z"
        except OSError:
            return True

    deadline = _time.monotonic() + 10.0
    killed = False
    while _time.monotonic() < deadline:
        if _gone():
            killed = True
            break
        _time.sleep(0.2)
    if not killed:
        try:
            os.kill(pid, _signal.SIGKILL)
        except OSError:
            pass
    with open(os.path.join(out_dir, "kill.txt"), "w") as f:
        f.write(f"pid {pid} terminated "
                f"({'SIGTERM' if killed else 'SIGKILL after timeout'}); "
                "stack dumps (SIGUSR1/2) went to the node's own stderr "
                "log\n")

    tar_path = _debug_tar(out_dir, args.output_file)
    # the staging dir duplicates config/WAL/state uncompressed in /tmp:
    # never leave it behind (debug dump's out_dir is user-chosen and
    # visible; this one is not)
    shutil.rmtree(out_dir, ignore_errors=True)
    print(f"Debug bundle written to {tar_path}")
    return 0


def cmd_signer(args) -> int:
    """Remote signer daemon: load this home's FilePV and dial the node's
    priv_validator_laddr, serving sign requests over the connection
    (privval/signer_dialer_endpoint.go + signer_server.go)."""
    from ..privval import FilePV
    from ..privval.signer import serve_dialer

    cfg = _load_home(args.home)
    pv = FilePV.load_or_generate(
        _join(args.home, cfg.base.priv_validator_key_file),
        _join(args.home, cfg.base.priv_validator_state_file))
    host, _, port = args.address.removeprefix("tcp://").rpartition(":")
    if not port.isdigit():
        print(f"bad --address {args.address!r}: expected host:port",
              file=sys.stderr)
        return 1
    print(f"Serving validator {pv.get_pub_key().address().hex()} to "
          f"{args.address}", flush=True)

    async def main():
        await serve_dialer(pv, host or "127.0.0.1", int(port),
                           max_retries=args.max_retries)

    try:
        asyncio.run(main())
    except KeyboardInterrupt:
        pass
    return 0


def cmd_inspect(args) -> int:
    """commands/inspect.go: read-only RPC over a crashed node's data dir."""
    return asyncio.run(_inspect_async(args))


async def _inspect_async(args) -> int:
    from ..rpc.inspect import run_inspect
    from ..types.genesis import GenesisDoc

    home = args.home
    cfg = _load_home(home)
    if args.device is not None:
        cfg.base.device = args.device
    with _data_dir_locked(home):
        doc = GenesisDoc.load(_join(home, cfg.base.genesis_file))
        host, port = "127.0.0.1", args.port
        server, addr = await run_inspect(home, cfg, doc, host, port)
        print(f"Inspect server on {addr[0]}:{addr[1]} (read-only; ctrl-c "
              "to stop)", flush=True)
        stop = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            loop.add_signal_handler(sig, stop.set)
        await stop.wait()
        await server.close()
    return 0


def cmd_light(args) -> int:
    """commands/light.go: light-client proxy daemon."""
    return asyncio.run(_light_async(args))


async def _light_async(args) -> int:
    from ..light import Client, TrustOptions
    from ..light.proxy import run_light_proxy
    from ..light.rpc_provider import RPCProvider
    from ..rpc.client import HTTPClient

    def parse_hp(s: str) -> tuple[str, int, bool]:
        try:
            host, port, tls, _verify = _parse_rpc_addr(s)
        except ValueError as e:
            print(str(e), file=sys.stderr)
            raise SystemExit(2) from e
        return host, port, tls

    phost, pport, ptls = parse_hp(args.primary)
    primary = RPCProvider(phost, pport, "primary", tls=ptls)
    witnesses = []
    for i, w in enumerate(args.witness or []):
        wh, wp, wtls = parse_hp(w)
        witnesses.append(RPCProvider(wh, wp, f"witness{i}", tls=wtls))
    from fractions import Fraction

    from ..light.client import SEQUENTIAL, SKIPPING

    try:
        num, _, den = args.trust_level.partition("/")
        trust_level = Fraction(int(num), int(den or 1))
        if not Fraction(1, 3) <= trust_level <= 1:
            raise ValueError("must be within [1/3, 1]")
    except (ValueError, ZeroDivisionError) as e:
        print(f"bad --trust-level {args.trust_level!r}: {e}",
              file=sys.stderr)
        return 1

    client = Client(
        args.chain_id,
        TrustOptions(args.trust_period * 1_000_000_000,
                     args.trust_height, bytes.fromhex(args.trust_hash)),
        primary, witnesses=witnesses,
        mode=SEQUENTIAL if args.sequential else SKIPPING,
        trust_level=trust_level, device=args.device)
    server, addr = await run_light_proxy(
        client, HTTPClient(phost, pport, tls=ptls, tls_verify=False),
        "127.0.0.1", args.port)
    print(f"Light proxy on {addr[0]}:{addr[1]} "
          f"(primary {args.primary}, {len(witnesses)} witnesses)",
          flush=True)
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, stop.set)
    await stop.wait()
    await server.close()
    return 0


def cmd_version(args) -> int:
    print(VERSION)
    return 0


# ------------------------------------------------------------------- main

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="cometbft_tpu_torch",
        description="BFT state-machine replication with its "
                    "signature-verification hot path on a CUDA card")
    p.add_argument("--home", default=os.environ.get(
        "CMTHOME", os.path.expanduser("~/.cometbft_tpu_torch")),
        help="node home directory")
    p.add_argument("--device", default=None,
                   help="where signatures are checked: a CUDA device "
                        "(the card by default; for start, base.device) or "
                        "cpu for the kernels' plain versions")
    sub = p.add_subparsers(dest="command", required=True)

    sp = sub.add_parser("init", help="initialize config/genesis/keys")
    sp.add_argument("--chain-id", default="")
    sp.add_argument("--moniker", default="node")
    sp.add_argument("--key-type", default="ed25519",
                    choices=["ed25519", "secp256k1", "bls12_381"])
    sp.set_defaults(fn=cmd_init)

    sp = sub.add_parser("start", help="run the node")
    sp.add_argument("--option", "-o", action="append", default=[],
                    metavar="SECTION.KEY=VALUE",
                    help="override a config.toml entry for this run "
                         "(repeatable), e.g. -o rpc.laddr=tcp://0.0.0.0:26657"
                         " -o consensus.timeout_commit=500000000")
    sp.set_defaults(fn=cmd_start)

    sp = sub.add_parser("testnet", help="generate wired node homes")
    sp.add_argument("--v", type=int, default=4, help="validator count")
    sp.add_argument("--output-dir", default="./mytestnet")
    sp.add_argument("--base-port", type=int, default=26656)
    sp.add_argument("--chain-id", default="")
    sp.set_defaults(fn=cmd_testnet)

    for name, fn in (("gen-validator", cmd_gen_validator),
                     ("gen-node-key", cmd_gen_node_key),
                     ("show-node-id", cmd_show_node_id),
                     ("show-validator", cmd_show_validator),
                     ("unsafe-reset-all", cmd_unsafe_reset_all),
                     ("version", cmd_version)):
        sp = sub.add_parser(name)
        if name == "gen-validator":
            sp.add_argument("--key-type", default="ed25519",
                            choices=["ed25519", "secp256k1", "bls12_381"])
        sp.set_defaults(fn=fn)

    sp = sub.add_parser("light", help="light-client RPC proxy daemon")
    sp.add_argument("--primary", required=True,
                    help="full node RPC addr host:port")
    sp.add_argument("--witness", action="append", default=[],
                    help="witness RPC addr (repeatable)")
    sp.add_argument("--chain-id", required=True)
    sp.add_argument("--trust-height", type=int, required=True)
    sp.add_argument("--trust-hash", required=True,
                    help="hex header hash at the trust height")
    sp.add_argument("--trust-period", type=int, default=168 * 3600,
                    help="trusting period in seconds")
    sp.add_argument("--trust-level", default="1/3",
                    help="trust level for skipping verification, "
                         "e.g. 1/3 (commands/light.go:94)")
    sp.add_argument("--sequential", action="store_true",
                    help="verify every header instead of skipping")
    sp.add_argument("--port", type=int, default=0)
    sp.set_defaults(fn=cmd_light)

    sp = sub.add_parser("signer", help="remote signer daemon: serve this "
                        "home's validator key to a node's "
                        "priv_validator_laddr")
    sp.add_argument("--address", required=True,
                    help="node's priv_validator_laddr (tcp://host:port)")
    sp.add_argument("--max-retries", type=int, default=0,
                    help="dial attempts before giving up (0 = forever)")
    sp.set_defaults(fn=cmd_signer)

    sp = sub.add_parser("inspect",
                        help="read-only RPC over the data directory")
    sp.add_argument("--port", type=int, default=26657)
    sp.set_defaults(fn=cmd_inspect)

    sp = sub.add_parser("rollback", help="undo the latest block state")
    sp.add_argument("--hard", action="store_true",
                    help="also remove the block itself")
    sp.set_defaults(fn=cmd_rollback)

    sp = sub.add_parser("load", help="drive timestamped load at a node "
                                     "(test/loadtime generator)")
    sp.add_argument("--rpc", default="127.0.0.1:26657")
    sp.add_argument("--rate", type=float, default=100.0, help="tx/s")
    sp.add_argument("--duration", type=float, default=10.0, help="seconds")
    sp.add_argument("--size", type=int, default=256, help="tx bytes")
    sp.add_argument("--connections", type=int, default=1,
                    help="concurrent sender loops splitting the rate "
                         "(loadtime's -c; one serial loop caps ~600 tx/s)")
    sp.set_defaults(fn=cmd_load)

    sp = sub.add_parser("load-report",
                        help="latency distribution of committed load txs")
    sp.add_argument("--rpc", default="127.0.0.1:26657")
    sp.add_argument("--run-id", default=None)
    sp.set_defaults(fn=cmd_load_report)

    sp = sub.add_parser("reindex-event",
                        help="rebuild tx/block indexes from stored blocks")
    sp.add_argument("--start-height", type=int, default=0)
    sp.add_argument("--end-height", type=int, default=0)
    sp.set_defaults(fn=cmd_reindex_event)

    sp = sub.add_parser("compact-db",
                        help="force-compact the data-dir stores")
    sp.set_defaults(fn=cmd_compact_db)

    sp = sub.add_parser("doctor", help="offline storage integrity check: "
                        "cross-store consistency + deep hash-chain scan "
                        "(report-only unless --repair)")
    sp.add_argument("--repair", action="store_true",
                    help="apply repairs: truncate to the last verified "
                         "height, rebuild state, quarantine a WAL that "
                         "ran ahead")
    sp.add_argument("--window", type=int, default=None,
                    help="deep-scan window in heights (default: config "
                         "storage.doctor_deep_scan_window; 0 = whole "
                         "store)")
    sp.set_defaults(fn=cmd_doctor)

    from .abci import register as register_abci

    register_abci(sub)

    sp = sub.add_parser("e2e", help="manifest-driven multi-process "
                        "testnet runner (test/e2e)")
    sp.add_argument("--manifest", help="TOML manifest path")
    sp.add_argument("--dir", default="./e2e-net")
    sp.add_argument("--base-port", type=int, default=26656)
    sp.add_argument("--deadline", type=float, default=240.0)
    sp.set_defaults(fn=cmd_e2e)

    sp = sub.add_parser("e2e-gen", help="deterministic random manifest "
                        "generator (test/e2e/generator): seed -> TOML "
                        "manifests sweeping db/abci/key/sync/perturb axes")
    sp.add_argument("--seed", type=int, default=1)
    sp.add_argument("--runs", type=int, default=1,
                    help="manifests to emit (seeds seed..seed+runs-1)")
    sp.add_argument("--output-dir", default="./e2e-gen")
    sp.add_argument("--compact", action="store_true",
                    help="CI-sized topologies (<= 4 backing nodes)")
    sp.set_defaults(fn=cmd_e2e_gen)

    sp = sub.add_parser("debug", help="post-mortem capture")
    dsub = sp.add_subparsers(dest="debug_command", required=True)
    dp = dsub.add_parser("dump", help="capture an introspection bundle")
    dp.add_argument("--rpc", default="127.0.0.1:26657")
    dp.add_argument("--output-dir", default="")
    dp.set_defaults(fn=cmd_debug_dump)
    dp = dsub.add_parser("wal", help="dump consensus WAL records as "
                         "JSON lines (scripts/wal2json)")
    dp.set_defaults(fn=cmd_debug_wal)
    dp = dsub.add_parser("kill", help="capture a RUNNING node's state "
                         "by pid, terminate it, tarball everything "
                         "(commands/debug/kill.go)")
    dp.add_argument("pid", type=int)
    dp.add_argument("output_file", nargs="?", default=None,
                    help="archive path (default <tmp>.tar.gz)")
    dp.add_argument("--rpc", default="127.0.0.1:26657")
    dp.set_defaults(fn=cmd_debug_kill)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)
