"""Configuration tree (counterpart of ``cometbft_tpu/config.py``;
reference: ``config/config.go:78-93``): one :class:`Config` of the
sections the port's node reads, each field with the JAX package's
default, persisted as ``config.toml`` (``config/toml.go``):
:meth:`Config.save` writes every field, :meth:`Config.load` reads a file
with the standard library's ``tomllib``.

- Consensus timeouts are in nanoseconds; :func:`test_consensus_config`
  shrinks them to tens of milliseconds for in-process networks.
- ``BaseConfig.device`` takes the place of ``signature_backend``: where
  every signature of the node is checked (``"cuda"`` by default, raising
  without a card; ``"cpu"`` for the kernels' plain versions, as the tests
  run them).  A file the port writes carries ``base.device``, which the
  JAX package's loader refuses.
- The JAX package's keys that the port has no use for are
  :data:`IGNORED_KEYS`, each with its reason: :meth:`Config.load`
  accepts and drops them, so a home the JAX package wrote loads here.
  Any other unknown section or key raises :class:`ConfigError`.
- :meth:`Config.validate` holds every field to the JAX package's bounds
  (``config.go`` ValidateBasic), raising :class:`ConfigError` with its
  messages.
- ``P2PConfig.pong_timeout`` is the port's second key: the seconds an
  MConnection waits for a pong (upstream MConnection's 45 s).  The JAX
  package has no key for it and holds 5 s; its loader refuses the key,
  as it refuses ``base.device``.
- ``RPCConfig.laddr`` is ``tcp://127.0.0.1:26657`` as in the JAX
  package: a node started with it listens there; in-process networks
  give each node ``tcp://127.0.0.1:0`` (a free port) or ``""`` (no RPC
  server).
"""

from __future__ import annotations

from dataclasses import dataclass, field

__all__ = ["NS", "MS", "ConsensusConfig", "test_consensus_config",
           "BaseConfig", "MempoolConfig", "P2PConfig", "RPCConfig",
           "BlockSyncConfig", "StateSyncConfig", "LightServeConfig",
           "StorageConfig", "TxIndexConfig", "InstrumentationConfig",
           "ChaosConfig", "Config", "ConfigError", "IGNORED_KEYS"]

NS = 1_000_000_000
MS = 1_000_000


@dataclass
class ConsensusConfig:
    """Timeouts in ns (defaults: config/config.go:1189-1207)."""

    timeout_propose: int = 3 * NS
    timeout_propose_delta: int = 500 * MS
    timeout_prevote: int = 1 * NS
    timeout_prevote_delta: int = 500 * MS
    timeout_precommit: int = 1 * NS
    timeout_precommit_delta: int = 500 * MS
    timeout_commit: int = 1 * NS
    skip_timeout_commit: bool = False
    create_empty_blocks: bool = True
    create_empty_blocks_interval: int = 0
    peer_gossip_sleep_duration: int = 100 * MS
    peer_query_maj23_sleep_duration: int = 2 * NS
    wal_path: str = "data/cs.wal"

    def propose_timeout(self, round_: int) -> int:
        return self.timeout_propose + self.timeout_propose_delta * round_

    def prevote_timeout(self, round_: int) -> int:
        return self.timeout_prevote + self.timeout_prevote_delta * round_

    def precommit_timeout(self, round_: int) -> int:
        return self.timeout_precommit + self.timeout_precommit_delta * round_

    def commit_timeout(self) -> int:
        return self.timeout_commit


def test_consensus_config() -> ConsensusConfig:
    """Shrunk timeouts for in-proc multi-validator tests
    (config/config.go:1210 TestConsensusConfig pattern)."""
    return ConsensusConfig(
        timeout_propose=80 * MS, timeout_propose_delta=20 * MS,
        timeout_prevote=40 * MS, timeout_prevote_delta=10 * MS,
        timeout_precommit=40 * MS, timeout_precommit_delta=10 * MS,
        timeout_commit=20 * MS, peer_gossip_sleep_duration=5 * MS)


@dataclass
class MempoolConfig:
    size: int = 5000
    max_tx_bytes: int = 1024 * 1024
    # byte-capacity bound across the whole pool
    max_txs_bytes: int = 1 << 30
    cache_size: int = 10000
    keep_invalid_txs_in_cache: bool = False
    recheck: bool = True
    # admission shards (by tx-hash prefix)
    shards: int = 4
    # CheckTx coalescer: the first queued admission's wait (0 disables)
    # and the size-flush cap
    coalesce_ms: float = 1.0
    coalesce_max: int = 64
    # tx gossip dialect: "announce" (hashes, bodies fetched on a miss)
    # or "full" (bodies)
    gossip_mode: str = "announce"
    # how long one body fetch may be outstanding before it is
    # re-requested from another announcer
    fetch_timeout_s: float = 2.0
    # byte budget of one full-body or fetch-response gossip frame
    gossip_batch_bytes: int = 64 * 1024


@dataclass
class P2PConfig:
    laddr: str = "tcp://0.0.0.0:26656"
    external_address: str = ""
    # comma-separated dial addresses; the node's starter dials them
    # (seeds once, persistent peers with redial), as the JAX package's
    # cmd does
    seeds: str = ""
    persistent_peers: str = ""
    max_num_inbound_peers: int = 40
    max_num_outbound_peers: int = 10
    # peer exchange (p2p/pex.py) and its address book; in seed mode the
    # node crawls the book and hangs up after harvesting
    pex: bool = True
    pex_interval_seconds: float = 30.0     # ensurePeersPeriod
    seed_mode: bool = False
    addr_book_path: str = "config/addrbook.json"
    # one-way delay injected at the MConnection receive side, emulating
    # geo-distribution on one machine (the reference's e2e runner,
    # test/e2e/runner/latency_emulation.go)
    emulated_latency_ms: float = 0.0
    # cadence of the switch's per-peer flush into the peer-labelled
    # Prometheus series; 0 disables it
    telemetry_flush_interval_s: float = 2.0
    # connection fuzzing on every peer stream (p2p/fuzz.py; reference
    # p2p/fuzz.go and config.FuzzConnConfig), from fuzz_start_after_s
    # after the connection opens, decisions from random.Random(fuzz_seed)
    test_fuzz: bool = False
    fuzz_mode: str = "drop"           # drop | delay
    fuzz_max_delay_s: float = 3.0
    fuzz_prob_drop_rw: float = 0.01
    fuzz_prob_drop_conn: float = 0.0
    fuzz_prob_sleep: float = 0.0
    fuzz_start_after_s: float = 10.0
    fuzz_seed: int = 0
    # peer quality (p2p/quality.py): decaying per-peer misbehavior
    # scores; crossing the disconnect score drops the peer, crossing the
    # ban score issues a timed ban (TTL doubling per repeat offense)
    quality_enable: bool = True
    quality_disconnect_score: float = 5.0
    quality_ban_score: float = 10.0
    quality_half_life_s: float = 120.0
    quality_ban_ttl_s: float = 60.0
    quality_ban_ttl_max_s: float = 3600.0
    # seconds a ping waits for its pong before the link is dropped
    # (upstream config.P2PConfig.PongTimeout)
    pong_timeout: float = 45.0


@dataclass
class RPCConfig:
    laddr: str = "tcp://127.0.0.1:26657"
    grpc_laddr: str = ""              # block/version/pruning gRPC services
    max_open_connections: int = 900
    max_subscription_clients: int = 100
    unsafe: bool = False              # dial_seeds/dial_peers/flush_mempool
    # CORS (config/config.go:353-364): origins may carry one wildcard
    # each; '*' alone allows every origin
    cors_allowed_origins: list[str] = field(default_factory=list)
    cors_allowed_methods: list[str] = field(
        default_factory=lambda: ["HEAD", "GET", "POST"])
    cors_allowed_headers: list[str] = field(
        default_factory=lambda: ["Origin", "Accept", "Content-Type",
                                 "X-Requested-With", "X-Server-Time"])
    # HTTPS (config/config.go:428-442): both files set -> TLS, else plain
    # HTTP; relative paths resolve against the home's config directory
    tls_cert_file: str = ""
    tls_key_file: str = ""
    # shed broadcast_tx_* with a retryable error while the event loop's
    # scheduling lag (libs/loopwatch) exceeds this many seconds; 0
    # disables
    overload_shed_lag_s: float = 2.0
    # admission gate (rpc/server.py): handlers running at once, and
    # requests waiting beyond them; past both, HTTP 503 + Retry-After
    max_concurrent_requests: int = 64
    max_queued_requests: int = 256
    shed_retry_after_s: float = 1.0


@dataclass
class BlockSyncConfig:
    # catch up by blocksync before consensus (the starter's fast_sync)
    enable: bool = True
    # blocks whose commits fill one device batch during catch-up
    verify_window: int = 32


@dataclass
class StateSyncConfig:
    enable: bool = False
    trust_height: int = 0
    trust_hash: str = ""
    trust_period: int = 168 * 3600 * NS
    rpc_servers: list[str] = field(default_factory=list)
    # fetch discipline (statesync/syncer.py): a chunk request with no
    # progress for this long fails the restore attempt (re-issued to
    # another peer after half of it); outstanding requests per serving
    # peer; one discovery broadcast's offer window and the
    # discover-pick-restore rounds; a chunk's refetch budget; the byte
    # budget of retained spool blobs (what a retried restore resumes
    # from)
    chunk_timeout_s: float = 10.0
    max_inflight_per_peer: int = 4
    discovery_time_s: float = 0.5
    discovery_rounds: int = 5
    chunk_retries: int = 3
    spool_retain_bytes: int = 64 * 1024 * 1024
    # serving side (statesync/reactor.py): the served-chunk LRU's byte
    # budget, and the admission gate's concurrent loads and queue
    chunk_cache_bytes: int = 64 * 1024 * 1024
    serve_concurrency: int = 8
    serve_queue: int = 64


@dataclass
class LightServeConfig:
    """Light-client serving tier (light/serve.py): bounds of its caches
    and of one request's work."""

    enable: bool = True
    # signed header + commit + validator set LRU entries, and their
    # approximate byte budget (0: bounded by count only)
    header_cache_size: int = 4096
    header_cache_bytes: int = 256 * 1024 * 1024
    # per-block proof trees kept ((height, kind) entries)
    proof_cache_blocks: int = 64
    # whole-commit verdict memo of client anchors (positive verdicts)
    verify_cache_size: int = 4096
    # trusting period that keys the header LRU's window
    trust_period_ns: int = 168 * 3600 * NS
    # heights per light_blocks / anchors per light_verify, and proofs
    # per light_proofs
    max_batch: int = 128
    max_proofs: int = 4096


@dataclass
class StorageConfig:
    db_backend: str = "logdb"         # logdb | native | memdb
    # the storage doctor (node/doctor.py): the boot-time cross-store
    # check with repair, and the heights its deep hash-chain scan walks
    # back from the tip (0: the whole store)
    doctor_enable: bool = True
    doctor_deep_scan_window: int = 128


@dataclass
class TxIndexConfig:
    indexer: str = "kv"               # kv | psql | null
    # DSN for indexer="psql" (state/indexer/sink/psql); the port imports
    # no psycopg2, so a DSN alone raises the sink's PsqlSinkError
    psql_conn: str = ""


@dataclass
class InstrumentationConfig:
    # a Prometheus text listener of its own besides the RPC's /metrics
    prometheus: bool = False
    prometheus_listen_addr: str = ":26660"
    # event-loop stall watchdog (libs/loopwatch), whose lag the RPC's
    # overload shedding reads; 0 disables
    loop_stall_threshold_s: float = 1.0
    # flight-recorder tracing (libs/tracing): off by default
    tracing: bool = False
    tracing_ring_size: int = 8192
    # the liveness watchdog (node/watchdog.py): a step, commit or peer
    # silence longer than the threshold writes an incident bundle (0
    # disables); how often it looks, the least time between two bundles,
    # the bundles kept, their directory (relative to the home) and the
    # WAL records each carries
    watchdog_stall_threshold_s: float = 60.0
    watchdog_check_interval_s: float = 5.0
    watchdog_min_interval_s: float = 300.0
    watchdog_max_bundles: int = 16
    watchdog_incident_dir: str = "data/incidents"
    watchdog_wal_tail: int = 200


@dataclass
class BaseConfig:
    # where the node checks signatures: "cuda" (or a CUDA device),
    # "cpu" for the kernels' plain versions
    device: str = "cuda"
    moniker: str = "node"
    # the home (the command line sets it to --home); the paths below
    # are relative to it
    root_dir: str = "."
    genesis_file: str = "config/genesis.json"
    priv_validator_key_file: str = "config/priv_validator_key.json"
    node_key_file: str = "config/node_key.json"
    # with a tcp://host:port here, the node's starter listens and the
    # remote signer dials in (privval/signer.py SignerListener) instead
    # of the file signer
    priv_validator_laddr: str = ""
    # deadline of one remote-signer round trip in seconds (0: none)
    priv_validator_timeout_s: float = 5.0
    # the application: "builtin" (in process), "socket" (an ABCI socket
    # server at proxy_app, abci/server.py) or "grpc" (an ABCI gRPC server
    # there, abci/grpc.py)
    abci: str = "builtin"
    proxy_app: str = "kvstore"
    # the file signer's last-sign state under the home (read by the
    # storage doctor in inspect mode)
    priv_validator_state_file: str = "data/priv_validator_state.json"
    # the coalescing vote-verification scheduler (crypto/scheduler.py),
    # which the port's node always runs: it holds the node's device
    vote_sched_max_wait_ms: float = 2.0
    vote_sched_max_lanes: int = 256
    vote_sched_cache_size: int = 65536
    vote_sched_verify_timeout_s: float = 0.0
    # warm boot at node start on a card (node/node.py): load the kernel
    # bundle (crypto/aotbundle.py; built where absent or stale), then
    # launch the commit path's kernels once at the hot shapes and the
    # validator set's size, off the event loop
    device_warmup: bool = True
    compile_bundle_enable: bool = True
    # the bundles' directory; empty = <checkout>/build/cometbft_tpu_torch
    compile_bundle_dir: str = ""


@dataclass
class ChaosConfig:
    """Deterministic fault injection (``libs/failures.py``), off by
    default; the ``CMT_CHAOS`` environment variable overrides it."""

    enable: bool = False
    # master seed; per-site generators derive from "{seed}:{site}"
    seed: int = 0
    # fault specs, "site:key=value:...", e.g. "wal.fsync.eio:at=40"
    faults: list[str] = field(default_factory=list)
    log_size: int = 8192


@dataclass
class Config:
    base: BaseConfig = field(default_factory=BaseConfig)
    consensus: ConsensusConfig = field(default_factory=ConsensusConfig)
    mempool: MempoolConfig = field(default_factory=MempoolConfig)
    p2p: P2PConfig = field(default_factory=P2PConfig)
    rpc: RPCConfig = field(default_factory=RPCConfig)
    blocksync: BlockSyncConfig = field(default_factory=BlockSyncConfig)
    statesync: StateSyncConfig = field(default_factory=StateSyncConfig)
    lightserve: LightServeConfig = field(default_factory=LightServeConfig)
    storage: StorageConfig = field(default_factory=StorageConfig)
    tx_index: TxIndexConfig = field(default_factory=TxIndexConfig)
    instrumentation: InstrumentationConfig = field(
        default_factory=InstrumentationConfig)
    chaos: ChaosConfig = field(default_factory=ChaosConfig)

    # ------------------------------------------------------ persistence

    def to_toml(self) -> str:
        """The file :meth:`save` writes: every section and field in
        declaration order, flat ``[section] key = value`` forms."""
        import dataclasses

        lines = ["# cometbft_tpu_torch node configuration", ""]
        for sf in dataclasses.fields(self):
            section = getattr(self, sf.name)
            lines.append(f"[{sf.name}]")
            for f_ in dataclasses.fields(section):
                lines.append(
                    f"{f_.name} = {_toml_value(getattr(section, f_.name))}")
            lines.append("")
        return "\n".join(lines)

    def save(self, path: str) -> None:
        import os

        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            f.write(self.to_toml())

    @classmethod
    def load(cls, path: str) -> "Config":
        """Read ``path`` over the defaults: keys of :data:`IGNORED_KEYS`
        are dropped, the deprecated ``blocksync.batch_size`` is dropped
        with a warning, and any other unknown section or key raises
        :class:`ConfigError`; the result is validated."""
        import tomllib

        with open(path, "rb") as f:
            doc = tomllib.load(f)
        cfg = cls()
        for section_name, values in doc.items():
            section = getattr(cfg, section_name, None)
            if section is None:
                raise ConfigError(f"unknown config section {section_name!r}")
            for k, v in values.items():
                if (section_name, k) in IGNORED_KEYS or \
                        (section_name, k) in _DEPRECATED_KEYS:
                    continue
                if not hasattr(section, k):
                    raise ConfigError(
                        f"unknown config key {section_name}.{k}")
                setattr(section, k, v)
        if "batch_size" in doc.get("blocksync", {}):
            from .libs import log as _tmlog

            _tmlog.logger("config").warn(
                "blocksync.batch_size is deprecated and has no effect; "
                "use blocksync.verify_window to size the cross-block "
                "verification window", path=path)
        cfg.validate()
        return cfg

    def validate(self) -> None:
        """Per-section bounds, in the JAX package's order and with its
        messages (``config/config.go`` ValidateBasic)."""
        if self.base.abci not in ("builtin", "socket", "grpc"):
            raise ConfigError(f"base.abci must be builtin|socket|grpc, "
                              f"got {self.base.abci!r}")
        for name in ("timeout_propose", "timeout_prevote",
                     "timeout_precommit", "timeout_commit"):
            if getattr(self.consensus, name) <= 0:
                raise ConfigError(f"consensus.{name} must be positive")
        if self.mempool.size <= 0:
            raise ConfigError("mempool.size must be positive")
        if self.mempool.max_txs_bytes <= 0:
            raise ConfigError("mempool.max_txs_bytes must be positive")
        if not 1 <= self.mempool.shards <= 256:
            raise ConfigError("mempool.shards must be in [1, 256]")
        if self.mempool.coalesce_ms < 0:
            raise ConfigError("mempool.coalesce_ms must be >= 0")
        if self.mempool.coalesce_max < 1:
            raise ConfigError("mempool.coalesce_max must be >= 1")
        if self.mempool.gossip_mode not in ("announce", "full"):
            raise ConfigError(
                f"bad mempool.gossip_mode {self.mempool.gossip_mode!r} "
                "(expected 'announce' or 'full')")
        if self.mempool.fetch_timeout_s <= 0:
            raise ConfigError("mempool.fetch_timeout_s must be positive")
        if self.mempool.gossip_batch_bytes < 1024:
            raise ConfigError(
                "mempool.gossip_batch_bytes must be >= 1024")
        if self.base.vote_sched_max_wait_ms < 0:
            raise ConfigError("base.vote_sched_max_wait_ms must be >= 0")
        if self.base.vote_sched_max_lanes < 1:
            raise ConfigError("base.vote_sched_max_lanes must be >= 1")
        if self.base.vote_sched_cache_size < 0:
            raise ConfigError("base.vote_sched_cache_size must be >= 0")
        if self.instrumentation.tracing_ring_size < 16:
            raise ConfigError(
                "instrumentation.tracing_ring_size must be >= 16")
        inst = self.instrumentation
        if inst.watchdog_stall_threshold_s < 0:
            raise ConfigError(
                "instrumentation.watchdog_stall_threshold_s must be >= 0")
        if inst.watchdog_stall_threshold_s > 0:
            if inst.watchdog_check_interval_s <= 0:
                raise ConfigError(
                    "instrumentation.watchdog_check_interval_s must be "
                    "positive when the watchdog is enabled")
            if inst.watchdog_min_interval_s < 0:
                raise ConfigError(
                    "instrumentation.watchdog_min_interval_s must be >= 0")
            if inst.watchdog_max_bundles < 1:
                raise ConfigError(
                    "instrumentation.watchdog_max_bundles must be >= 1")
            if inst.watchdog_wal_tail < 0:
                raise ConfigError(
                    "instrumentation.watchdog_wal_tail must be >= 0")
        p2p = self.p2p
        if p2p.telemetry_flush_interval_s < 0:
            raise ConfigError(
                "p2p.telemetry_flush_interval_s must be >= 0")
        if p2p.quality_disconnect_score <= 0 or p2p.quality_ban_score <= 0:
            raise ConfigError(
                "p2p.quality_{disconnect,ban}_score must be positive")
        if p2p.quality_ban_score < p2p.quality_disconnect_score:
            raise ConfigError(
                "p2p.quality_ban_score must be >= quality_disconnect_score")
        if p2p.quality_half_life_s <= 0:
            raise ConfigError("p2p.quality_half_life_s must be positive")
        if p2p.quality_ban_ttl_s <= 0 or \
                p2p.quality_ban_ttl_max_s < p2p.quality_ban_ttl_s:
            raise ConfigError(
                "p2p.quality_ban_ttl_s must be positive and <= "
                "quality_ban_ttl_max_s")
        if p2p.pong_timeout <= 0:
            raise ConfigError("p2p.pong_timeout must be positive")
        if self.rpc.max_concurrent_requests < 1:
            raise ConfigError("rpc.max_concurrent_requests must be >= 1")
        if self.rpc.max_queued_requests < 0:
            raise ConfigError("rpc.max_queued_requests must be >= 0")
        if self.rpc.shed_retry_after_s < 0:
            raise ConfigError("rpc.shed_retry_after_s must be >= 0")
        if self.storage.db_backend not in ("logdb", "native", "memdb"):
            raise ConfigError(
                f"storage.db_backend must be logdb|native|memdb, "
                f"got {self.storage.db_backend!r}")
        if self.tx_index.indexer not in ("kv", "psql", "null"):
            raise ConfigError(
                f"tx_index.indexer must be kv|psql|null, "
                f"got {self.tx_index.indexer!r}")
        if self.tx_index.indexer == "psql" and not self.tx_index.psql_conn:
            raise ConfigError(
                "tx_index.indexer='psql' requires tx_index.psql_conn")
        if p2p.fuzz_mode not in ("drop", "delay"):
            raise ConfigError(f"p2p.fuzz_mode must be drop|delay, "
                              f"got {p2p.fuzz_mode!r}")
        if self.base.vote_sched_verify_timeout_s < 0:
            raise ConfigError(
                "base.vote_sched_verify_timeout_s must be >= 0")
        if self.base.priv_validator_timeout_s < 0:
            raise ConfigError(
                "base.priv_validator_timeout_s must be >= 0")
        if self.storage.doctor_deep_scan_window < 0:
            raise ConfigError(
                "storage.doctor_deep_scan_window must be >= 0")
        ls = self.lightserve
        if ls.header_cache_size < 0 or ls.proof_cache_blocks < 0 or \
                ls.verify_cache_size < 0 or ls.header_cache_bytes < 0:
            raise ConfigError(
                "lightserve cache sizes must be >= 0")
        if ls.trust_period_ns <= 0:
            raise ConfigError("lightserve.trust_period_ns must be positive")
        if ls.max_batch < 1:
            raise ConfigError("lightserve.max_batch must be >= 1")
        if ls.max_proofs < 1:
            raise ConfigError("lightserve.max_proofs must be >= 1")
        ss = self.statesync
        if ss.chunk_timeout_s <= 0:
            raise ConfigError("statesync.chunk_timeout_s must be positive")
        if not 1 <= ss.max_inflight_per_peer <= 64:
            raise ConfigError(
                "statesync.max_inflight_per_peer must be in [1, 64]")
        if ss.discovery_time_s <= 0:
            raise ConfigError(
                "statesync.discovery_time_s must be positive")
        if not 1 <= ss.discovery_rounds <= 100:
            raise ConfigError(
                "statesync.discovery_rounds must be in [1, 100]")
        if not 0 <= ss.chunk_retries <= 100:
            raise ConfigError(
                "statesync.chunk_retries must be in [0, 100]")
        if ss.spool_retain_bytes < 0 or ss.chunk_cache_bytes < 0:
            raise ConfigError(
                "statesync byte budgets must be >= 0")
        if ss.serve_concurrency < 1:
            raise ConfigError(
                "statesync.serve_concurrency must be >= 1")
        if ss.serve_queue < 0:
            raise ConfigError("statesync.serve_queue must be >= 0")
        if not 2 <= self.blocksync.verify_window <= 4096:
            # floor 2: the accumulator needs a vouching tail block
            raise ConfigError(
                "blocksync.verify_window must be in [2, 4096]")
        if self.chaos.log_size < 16:
            raise ConfigError("chaos.log_size must be >= 16")
        if self.chaos.enable:
            from .libs.failures import FaultSpecError, parse_fault_spec

            for spec in self.chaos.faults:
                try:
                    parse_fault_spec(spec)
                except FaultSpecError as e:
                    raise ConfigError(f"bad chaos.faults entry: {e}") \
                        from None


class ConfigError(Exception):
    pass


# The JAX package's keys with no use in the port, and why: load drops
# them, save never writes them.
IGNORED_KEYS = {
    ("base", "signature_backend"): "base.device takes its place",
    ("base", "min_device_lanes"): "steers the TPU host fallback, which "
                                  "the port does not have",
    ("base", "device_wait_s"): "bounds the wait before the TPU host "
                               "fallback, which the port does not have",
    ("base", "vote_sched_enable"): "the port's node always runs the "
                                   "verification scheduler: it holds "
                                   "the node's device",
    ("base", "merkle_kernel_min_leaves"): "the tree route's threshold is "
                                          "merkle.MERKLE_KERNEL_MIN_LEAVES, "
                                          "to be settled on the card",
    ("mempool", "broadcast"): "read by nothing in the JAX package",
    ("p2p", "handshake_timeout"): "read by nothing in the JAX package",
    ("p2p", "dial_timeout"): "read by nothing in the JAX package",
    ("p2p", "send_rate"): "read by nothing in the JAX package",
    ("p2p", "recv_rate"): "read by nothing in the JAX package",
    ("storage", "discard_abci_responses"): "read by nothing in the JAX "
                                          "package",
}

# a dead key that files written by older nodes carry: load drops it with
# a warning, save never writes it
_DEPRECATED_KEYS = {("blocksync", "batch_size")}


def _toml_value(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (int, float)):
        return str(v)
    if isinstance(v, str):
        return '"' + v.replace("\\", "\\\\").replace('"', '\\"') + '"'
    if isinstance(v, list):
        return "[" + ", ".join(_toml_value(x) for x in v) + "]"
    raise ConfigError(f"cannot emit TOML for {type(v).__name__}")
