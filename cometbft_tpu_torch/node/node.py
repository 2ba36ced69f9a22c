"""Node assembly (counterpart of ``cometbft_tpu/node/node.py``; reference:
``node/node.go:275,303-576`` NewNode and OnStart): stores, state and
genesis, the ABCI connections and the app handshake, mempool, evidence,
consensus with its WAL, the reactors, and the transport and switch.

Two phases, as in the reference: :meth:`Node.create` builds everything,
:meth:`Node.start` starts the services in dependency order.  Every
signature the node checks is checked on ``config.base.device``: the
handshake's challenge on the transport, votes, proposals and evidence
through the process-wide verification scheduler (``crypto/
scheduler.py``), which :meth:`start` acquires and :meth:`stop` releases
(in-process nodes share one, reference-counted), and commits through
the block executor and blocksync.  ``device`` is ``"cuda"`` by default
and raises without a card; ``"cpu"`` runs the kernels' plain versions.

With ``rpc.laddr`` set (``tcp://127.0.0.1:0`` for a free port, ``""``
for none) :meth:`start` serves the JSON-RPC, URI and WebSocket server
(``rpc/server.py``) on it; the kv tx and block indexers
(``tx_index.indexer = "kv"``) follow the event bus; the light-serving
tier (``lightserve.enable``) answers the ``light_*`` routes on the
node's device; the loop watchdog (``instrumentation.
loop_stall_threshold_s``) gives the RPC's overload shedding its lag; and
``instrumentation.prometheus`` adds a metrics listener of its own.

Every node serves snapshots (``statesync/reactor.py``, channels 0x60
and 0x61, as the JAX node advertises them); a node created with
``state_sync_provider`` (a ``statesync.StateProvider`` over a light
client) and an empty block store skips the app handshake, restores a
snapshot from its peers (``statesync/syncer.py``), bootstraps its
stores at the snapshot height and hands off to blocksync
(:meth:`_run_statesync`).  With ``storage.doctor_enable`` the storage
doctor (``node/doctor.py``) checks the stores at :meth:`create`, before
the WAL opens, and ``/status`` serves its report; with
``instrumentation.watchdog_stall_threshold_s`` and a home, the liveness
watchdog (``node/watchdog.py``) writes incident bundles that
``/dump_incidents`` lists.

Discovery and faults, as the JAX node wires them: the fault plane from
``config.chaos`` (or ``CMT_CHAOS``) at :meth:`create`, before the
stores open; with ``p2p.test_fuzz`` every peer stream through the
connection fuzzer (``p2p/fuzz.py``); with ``p2p.pex`` an address book
(``p2p/addrbook.py``, a JSON file under the home) that the peer scorer
records its timed bans in, and the pex reactor (``p2p/pex.py``; in
``p2p.seed_mode`` it crawls and hangs up); every MConnection scoped by
the node's name for ``node=<name>`` fault rules, and its pong deadline
``p2p.pong_timeout``.  ``app=None`` with ``base.abci = "socket"``
connects to an ABCI socket server at ``base.proxy_app``, with
``base.abci = "grpc"`` to an ABCI gRPC server there (``abci/grpc.py``,
over the port's own HTTP/2); an app that does not answer raises
(nothing falls back to a local app).  The remote signer is a
``priv_validator`` like any other (``privval/signer.SignerListener``).  Seeds and persistent peers are
dialled by the node's starter (``cmd.dial_until_up``), as the JAX
package's ``cmd`` does.

Warm boot (``base.device_warmup``, as the JAX node's start,
``cometbft_tpu/node/node.py:552-628``): on a card, once its RPC server
listens, :meth:`start` loads the commit path's host libraries and
the kernel bundle (``crypto/aotbundle.py``, with
``base.compile_bundle_enable``, from ``base.compile_bundle_dir``),
builds it where it is absent or stale (the JAX node builds after its
warmup; the port's kernels cannot launch before they are built), then
launches the commit path's kernels once at the hot shapes and at the
validator set's size (``crypto/batch.py:warmup_device``, on the
device-owner thread), all off the event loop, and records
``compile_bundle_info`` (``/status``'s ``compile_bundle``; the gauge
``crypto_compile_bundle_info``).  A node on the CPU records
``{"status": "skipped_no_device"}`` and launches nothing; an error is
recorded as ``{"status": "error"}``, and the next device call builds
again and raises.

With ``rpc.grpc_laddr`` set, :meth:`start` serves the node's gRPC
services (``rpc/grpc.py``: version, blocks, block results, the pruning
service, the latest-height stream) there and :meth:`stop` stops them;
``tx_index.indexer = "psql"`` pumps the event bus into the SQL event
sink (``indexer/psql.py``), which needs a DB-API connection: the port
imports no ``psycopg2``, so a DSN alone raises its ``PsqlSinkError``
at :meth:`create`, as the JAX package does without ``psycopg2``.
"""

from __future__ import annotations

import asyncio
import os
import time

from .. import native as _native
from ..abci.application import Application
from ..blocksync.reactor import BlocksyncReactor
from ..config import Config, test_consensus_config
from ..consensus.reactor import ConsensusReactor
from ..consensus.replay import Handshaker
from ..consensus.state import ConsensusState
from ..consensus.wal import WAL
from ..crypto import aotbundle as _aotbundle
from ..crypto import batch as _batch
from ..crypto import plan as _plan
from ..crypto import scheduler as _vsched
from ..evidence import EvidencePool, EvidenceReactor
from ..indexer import BlockIndexer, IndexerService, TxIndexer
from ..indexer.psql import PsqlEventSink
from ..libs import failures as _failures
from ..libs import log as tmlog
from ..libs import metrics as _metrics
from ..libs import tracing
from ..libs.loopwatch import LoopWatchdog
from ..libs.pubsub import EventBus
from ..light.serve import LightServeTier
from ..mempool.clist_mempool import CListMempool
from ..mempool.reactor import MempoolReactor
from ..p2p import (AddrBook, NodeInfo, NodeKey, PeerScorer, PexReactor,
                   Switch, Transport)
from ..p2p.fuzz import FuzzConnConfig
from ..proxy.multi_app_conn import (AppConns, grpc_client_creator,
                                    local_client_creator,
                                    socket_client_creator)
from ..rpc import RPCServer
from ..rpc.grpc import GRPCServer
from ..sm.execution import BlockExecutor
from ..sm.pruner import Pruner
from ..statesync import StatesyncReactor, Syncer
from ..storage import BlockStore, MemDB, State, StateStore, open_db
from ..storage.db import DataDirLock
from ..types.genesis import GenesisDoc
from ..types.priv_validator import PrivValidator
from .doctor import StorageDoctor
from .watchdog import LivenessWatchdog, resolve_incident_dir

__all__ = ["Node", "warm_boot"]


def _parse_laddr(laddr: str) -> tuple[str, int]:
    addr = laddr.removeprefix("tcp://")
    host, _, port = addr.rpartition(":")
    return host or "127.0.0.1", int(port)


async def _serve_prometheus(laddr: str):
    """The Prometheus exposition listener of its own (reference:
    ``node/node.go``'s server on ``instrumentation.prometheus``); the RPC
    server also serves ``GET /metrics``."""
    host, port = _parse_laddr(laddr)

    async def handle(reader, writer):
        try:
            # bounded reads: a silent client must not pin the handler
            await asyncio.wait_for(reader.readline(), 10)   # request line
            while (await asyncio.wait_for(reader.readline(), 10)).strip():
                pass                                        # headers
            body = _metrics.DEFAULT.collect().encode()
            writer.write(b"HTTP/1.1 200 OK\r\nContent-Type: text/plain; "
                         b"version=0.0.4\r\nContent-Length: "
                         + str(len(body)).encode() + b"\r\n\r\n" + body)
            await writer.drain()
        except (ConnectionError, asyncio.IncompleteReadError,
                asyncio.TimeoutError):
            pass
        finally:
            writer.close()

    return await asyncio.start_server(handle, host, port)


def warm_boot(base, device, n_vals: int = 0, name: str = "node") -> dict:
    """The warm boot of a node on ``device`` (module docstring), under
    ``base`` (``config.BaseConfig``): the host libraries of the commit
    path loaded (``native.py``), the kernel bundle loaded, or built
    where it is absent or stale, then ``crypto/batch.py:warmup_device``
    at one lane, ``RLC_MIN_LANES`` lanes and ``n_vals`` (the validator
    set's size).  Returns the bundle's info with ``warm_shapes`` and
    ``warm_s``, or ``{"status": "error", ...}``, and records it
    (``crypto/aotbundle.py:set_info``)."""
    t0 = time.perf_counter()
    try:
        # the commit path's host libraries too, as the JAX node's start
        # warms its native verifiers: the sign-bytes encoder and the
        # secp256k1 verifier (built with g++ where absent)
        for lib in ("vote_sign_bytes", "secp256k1"):
            _native.load(lib)
        if base.compile_bundle_enable:
            _aotbundle.configure(base.compile_bundle_dir or None)
            info = _aotbundle.load(device=device)
            if info["status"] != "loaded":
                info = _aotbundle.build(device=device)
        else:
            info = {"status": "disabled"}
        shapes = _batch.warmup_device(
            lane_buckets=(1, _batch.RLC_MIN_LANES), device=device,
            valset_sizes=(n_vals,) if n_vals else ())
        info = {**info, "warm_shapes": shapes,
                "warm_s": time.perf_counter() - t0}
    except Exception as e:
        tmlog.logger("node", node=name).error("warm boot failed",
                                              err=repr(e))
        info = {"status": "error", "error": repr(e)}
    return _aotbundle.set_info(info)


class Node:
    def __init__(self):
        # populated by create()
        self.config: Config | None = None
        self.genesis: GenesisDoc | None = None
        self.device = None
        self.block_store: BlockStore | None = None
        self.state_store: StateStore | None = None
        self.app_conns: AppConns | None = None
        self.event_bus: EventBus | None = None
        self.mempool: CListMempool | None = None
        self.block_exec: BlockExecutor | None = None
        self.consensus: ConsensusState | None = None
        self.consensus_reactor: ConsensusReactor | None = None
        self.mempool_reactor: MempoolReactor | None = None
        self.blocksync_reactor: BlocksyncReactor | None = None
        self.evidence_pool: EvidencePool | None = None
        self.evidence_reactor: EvidenceReactor | None = None
        self.pruner: Pruner | None = None
        self.tx_indexer: TxIndexer | None = None
        self.block_indexer: BlockIndexer | None = None
        self.indexer_service: IndexerService | None = None
        self.light_serve: LightServeTier | None = None
        self.rpc_server: RPCServer | None = None
        self.rpc_addr: tuple[str, int] | None = None
        self.grpc_server: GRPCServer | None = None
        self.prometheus_server = None
        self.loop_watchdog: LoopWatchdog | None = None
        self.liveness_watchdog: LivenessWatchdog | None = None
        self.statesync_reactor: StatesyncReactor | None = None
        self.addr_book: AddrBook | None = None
        self.pex_reactor: PexReactor | None = None
        self.syncer: Syncer | None = None
        self.statesync_done: asyncio.Task | None = None
        self.statesync_error: BaseException | None = None
        self.doctor_report = None
        self.compile_bundle_info = None        # set by the warm boot
        self.warm_boot: asyncio.Future | None = None
        self.fast_sync = False
        self.node_key: NodeKey | None = None
        self.transport: Transport | None = None
        self.switch: Switch | None = None
        self.listen_addr: str | None = None
        self.home: str | None = None
        self.name = "node"
        self.wal: WAL | None = None
        self._dbs: list = []
        self._data_lock: DataDirLock | None = None
        self._holds_scheduler = False
        self._started = False
        self._closed = False

    # ------------------------------------------------------------- create

    @classmethod
    async def create(cls, genesis_doc: GenesisDoc, app: Application,
                     priv_validator: PrivValidator | None = None,
                     config: Config | None = None,
                     node_key: NodeKey | None = None,
                     home: str | None = None,
                     fast_sync: bool = False,
                     state_sync_provider=None,
                     name: str = "node") -> "Node":
        """Build a node of ``app`` (in process; ``None`` with
        ``base.abci = "socket"`` or ``"grpc"`` for the app at
        ``base.proxy_app``) on ``config.base.device`` (raising without a
        card unless it is ``"cpu"``).  With ``home``
        the stores are ``config.storage.db_backend`` files and the WAL a
        file under ``home/data``, whose lock the node holds until
        :meth:`stop`; without, everything is in memory.  The storage
        doctor's refusal (``doctor.DoctorError``) raises here."""
        cfg = config or Config(consensus=test_consensus_config())
        if app is None and cfg.base.abci not in ("socket", "grpc"):
            raise ValueError("no application: pass app or configure "
                             "base.abci='socket'|'grpc' with "
                             "base.proxy_app addr")
        self = cls()
        self.name = name
        self.home = home
        self.fast_sync = fast_sync or state_sync_provider is not None
        self.config = cfg
        self.genesis = genesis_doc
        self.device = cfg.base.device
        _plan.resolve_devices(self.device)       # raises without a card
        try:
            await self._build(genesis_doc, app, priv_validator, node_key,
                              state_sync_provider)
        except BaseException:
            await self._close_resources()
            raise
        return self

    async def _build(self, genesis_doc, app, priv_validator, node_key,
                     state_sync_provider) -> None:
        cfg, home, name, device = self.config, self.home, self.name, \
            self.device
        # the fault plane before the stores open: sites that fire at
        # open time must see it (process-wide and sticky)
        _failures.configure_from_config(cfg.chaos)

        def make_db(filename: str):
            db = MemDB() if home is None else open_db(
                cfg.storage.db_backend, os.path.join(home, "data", filename))
            self._dbs.append(db)
            return db

        wal_path = None
        if home is not None:
            # refuse to double-open a home
            self._data_lock = DataDirLock(os.path.join(home, "data"))
            wal_path = os.path.join(home, "data", "cs.wal")
        self.block_store = BlockStore(make_db("blockstore.db"))
        self.state_store = StateStore(make_db("state.db"))
        if cfg.storage.doctor_enable:
            # before the WAL opens: a repair may quarantine its segments
            self.doctor_report = StorageDoctor(
                self.block_store, self.state_store, wal_path=wal_path,
                priv_validator=priv_validator,
                deep_scan_window=cfg.storage.doctor_deep_scan_window,
                name=name).boot_check(repair=True)
        if wal_path is not None:
            self.wal = WAL(wal_path)
        state = self.state_store.load() or State.from_genesis(genesis_doc)

        if app is not None:
            creator = local_client_creator(app)
        elif cfg.base.abci == "socket":
            # out-of-process app over the ABCI socket (proxy/client.go's
            # remote creator)
            creator = socket_client_creator(*_parse_laddr(
                cfg.base.proxy_app))
        else:
            creator = grpc_client_creator(*_parse_laddr(cfg.base.proxy_app))
        self.app_conns = AppConns(creator, node=name)
        await self.app_conns.start()
        self.event_bus = EventBus()
        mp = cfg.mempool
        self.mempool = CListMempool(
            self.app_conns.mempool, max_txs=mp.size,
            max_tx_bytes=mp.max_tx_bytes, max_txs_bytes=mp.max_txs_bytes,
            cache_size=mp.cache_size,
            keep_invalid_txs_in_cache=mp.keep_invalid_txs_in_cache,
            shards=mp.shards, coalesce_ms=mp.coalesce_ms,
            coalesce_max=mp.coalesce_max, recheck=mp.recheck,
            metrics_node=name)
        self.evidence_pool = EvidencePool(
            make_db("evidence.db"), state_store=self.state_store,
            block_store=self.block_store, device=device)
        self.evidence_pool.state = state
        self.pruner = Pruner(self.state_store, self.block_store, name=name)
        self.block_exec = BlockExecutor(
            self.state_store, self.block_store, self.app_conns.consensus,
            self.mempool, evidence_pool=self.evidence_pool,
            event_bus=self.event_bus, device=device, pruner=self.pruner)
        state_syncing = (state_sync_provider is not None
                         and self.block_store.height() == 0)
        if not state_syncing:
            # a state-syncing app gets its state from the snapshot, not
            # InitChain or replay
            state = await Handshaker(
                self.state_store, self.block_store, genesis_doc).handshake(
                state, self.app_conns, self.block_exec)

        self.consensus = ConsensusState(
            cfg.consensus, state, self.block_exec, self.block_store,
            wal=self.wal, priv_validator=priv_validator,
            event_bus=self.event_bus, name=name)
        self.consensus.on_conflicting_vote = \
            self.evidence_pool.report_conflicting_votes

        gossip_sleep = cfg.consensus.peer_gossip_sleep_duration / 1e9
        self.consensus_reactor = ConsensusReactor(
            self.consensus, gossip_sleep=gossip_sleep)
        self.mempool_reactor = MempoolReactor(
            self.mempool, gossip_sleep=gossip_sleep,
            gossip_mode=mp.gossip_mode, fetch_timeout_s=mp.fetch_timeout_s,
            batch_bytes=mp.gossip_batch_bytes)
        self.blocksync_reactor = BlocksyncReactor(
            self.block_exec, self.block_store, state,
            fast_sync=self.fast_sync,
            switch_to_consensus=self._switch_to_consensus, device=device,
            verify_window=cfg.blocksync.verify_window, name=f"{name}.bs")
        if self.fast_sync:
            self.consensus_reactor.wait_sync = True
        self.evidence_reactor = EvidenceReactor(self.evidence_pool)
        ss = cfg.statesync
        self.statesync_reactor = StatesyncReactor(
            self.app_conns, name=f"{name}.ss",
            chunk_cache_bytes=ss.chunk_cache_bytes,
            serve_concurrency=ss.serve_concurrency,
            serve_queue=ss.serve_queue)
        if state_syncing:
            self.syncer = Syncer(
                self.app_conns, state_sync_provider,
                reactor=self.statesync_reactor, name=name,
                chunk_timeout=ss.chunk_timeout_s,
                max_inflight_per_peer=ss.max_inflight_per_peer,
                discovery_time=ss.discovery_time_s,
                discovery_rounds=ss.discovery_rounds,
                chunk_retries=ss.chunk_retries,
                spool_retain_bytes=ss.spool_retain_bytes)
            self.statesync_reactor.syncer = self.syncer
            self.blocksync_reactor.hold = True

        self.node_key = node_key or NodeKey.generate()
        p2p = cfg.p2p
        fuzz_cfg = None
        if p2p.test_fuzz:
            fuzz_cfg = FuzzConnConfig(
                mode=p2p.fuzz_mode, max_delay_s=p2p.fuzz_max_delay_s,
                prob_drop_rw=p2p.fuzz_prob_drop_rw,
                prob_drop_conn=p2p.fuzz_prob_drop_conn,
                prob_sleep=p2p.fuzz_prob_sleep,
                start_after_s=p2p.fuzz_start_after_s, seed=p2p.fuzz_seed)
        self.transport = Transport(self.node_key, self._node_info,
                                   device=device, fuzz_config=fuzz_cfg)
        # the book before the switch: the scorer records its timed bans
        # there (without pex it keeps them in memory)
        if p2p.pex:
            book_path = None
            if home is not None:
                book_path = os.path.join(home, p2p.addr_book_path)
            self.addr_book = AddrBook(book_path)
        scorer = PeerScorer(
            self.addr_book, enabled=p2p.quality_enable,
            disconnect_score=p2p.quality_disconnect_score,
            ban_score=p2p.quality_ban_score,
            half_life_s=p2p.quality_half_life_s,
            ban_ttl_s=p2p.quality_ban_ttl_s,
            ban_ttl_max_s=p2p.quality_ban_ttl_max_s)
        self.switch = Switch(
            self.transport, emulated_latency=p2p.emulated_latency_ms / 1e3,
            scorer=scorer, name=name,
            telemetry_interval=p2p.telemetry_flush_interval_s,
            pong_timeout=p2p.pong_timeout)
        self.switch.add_reactor("consensus", self.consensus_reactor)
        self.switch.add_reactor("mempool", self.mempool_reactor)
        self.switch.add_reactor("blocksync", self.blocksync_reactor)
        self.switch.add_reactor("evidence", self.evidence_reactor)
        self.switch.add_reactor("statesync", self.statesync_reactor)
        if p2p.pex:
            self.pex_reactor = PexReactor(
                self.addr_book, self.node_key.id,
                max_outbound=p2p.max_num_outbound_peers,
                request_interval=p2p.pex_interval_seconds,
                seed_mode=p2p.seed_mode)
            self.switch.add_reactor("pex", self.pex_reactor)

        if cfg.tx_index.indexer == "kv":
            self.tx_indexer = TxIndexer(make_db("tx_index.db"))
            self.block_indexer = BlockIndexer(make_db("block_index.db"))
            self.indexer_service = IndexerService(
                self.event_bus, self.tx_indexer, self.block_indexer,
                name=f"{name}.idx")
        elif cfg.tx_index.indexer == "psql":
            # external SQL sink (state/indexer/sink/psql): the same pump,
            # rows instead of kv postings; write-only from the node
            sink = PsqlEventSink(dsn=cfg.tx_index.psql_conn,
                                 chain_id=genesis_doc.chain_id)
            self.tx_indexer = sink
            self.block_indexer = sink.block_indexer()
            self.indexer_service = IndexerService(
                self.event_bus, sink, self.block_indexer,
                name=f"{name}.idx")
        elif cfg.tx_index.indexer not in ("", "null"):
            raise ValueError(f"tx_index.indexer {cfg.tx_index.indexer!r}: "
                             "the node indexes with kv, psql or null")
        if cfg.lightserve.enable:
            # passive: read by the light_* routes in worker threads
            ls = cfg.lightserve
            self.light_serve = LightServeTier(
                self.block_store, self.state_store, genesis_doc.chain_id,
                device=device, header_cache_size=ls.header_cache_size,
                header_cache_bytes=ls.header_cache_bytes,
                proof_cache_blocks=ls.proof_cache_blocks,
                verify_cache_size=ls.verify_cache_size,
                trust_period_ns=ls.trust_period_ns,
                max_batch=ls.max_batch, max_proofs=ls.max_proofs,
                name=name)

    async def _run_statesync(self) -> None:
        """node.go OnStart startStateSync: snapshot restore, stores
        bootstrapped at its height, then blocksync.  A failed restore
        falls back to the app handshake from genesis and blocksync, as
        the JAX node does; that fallback is the reference's semantics,
        not a device fallback."""
        lg = tmlog.logger("statesync", node=self.name)
        try:
            state, commit = await self.syncer.sync()
            self.state_store.bootstrap(state)
            self.block_store.bootstrap_statesync(state.last_block_height,
                                                 commit)
            self.evidence_pool.state = state
            self.blocksync_reactor.state = state
        except asyncio.CancelledError:
            raise
        except Exception as e:
            # InitChain was skipped for the snapshot: run the handshake
            # now.  If the app already restored part of a snapshot the
            # handshake itself fails, loudly.
            lg.error("statesync failed; falling back to blocksync",
                     err=repr(e))
            try:
                state = await Handshaker(
                    self.state_store, self.block_store,
                    self.genesis).handshake(
                    State.from_genesis(self.genesis), self.app_conns,
                    self.block_exec)
                self.blocksync_reactor.state = state
            except Exception as e2:
                self.statesync_error = e2
                lg.error("statesync fallback failed; node needs "
                         "unsafe-reset-all", err=repr(e2))
                return
        self.blocksync_reactor.hold = False
        await self.blocksync_reactor.start_sync()

    async def _switch_to_consensus(self, state) -> None:
        """Blocksync caught up: adopt the synced state and start consensus
        (reference consensus Reactor.SwitchToConsensus)."""
        self.consensus._update_to_state(state)
        await self.consensus.start()
        self.consensus_reactor.switch_to_consensus()

    def _node_info(self) -> NodeInfo:
        return NodeInfo(
            node_id=self.node_key.id,
            listen_addr=self.listen_addr or "",
            network=self.genesis.chain_id,
            channels=self.switch.channel_ids if self.switch else b"",
            moniker=self.name)

    # ---------------------------------------------------------- lifecycle

    async def start(self, consensus: bool = True) -> None:
        """node.go:579 OnStart: the verification scheduler on the node's
        device, then listen, the reactors, the pruner and consensus
        (deferred to the blocksync handoff under ``fast_sync``).  With
        ``consensus=False`` the state machine waits for
        :meth:`start_consensus`: in-process nodes share one event loop,
        and a running node's synchronous checks would hold it while its
        peers' handshakes wait, so a harness meshes the nodes first."""
        inst = self.config.instrumentation
        if inst.tracing:
            # process-wide, never flipped off at stop (in-process nodes
            # share the flight recorder)
            tracing.configure(enabled=True,
                              ring_size=inst.tracing_ring_size)
        base = self.config.base
        # before the listener: a peer's first vote needs the scheduler
        await _vsched.acquire_scheduler(
            device=self.device, max_wait_ms=base.vote_sched_max_wait_ms,
            max_lanes=base.vote_sched_max_lanes,
            cache_size=base.vote_sched_cache_size,
            verify_timeout_s=base.vote_sched_verify_timeout_s)
        self._holds_scheduler = True
        self._started = True
        try:
            host, port = _parse_laddr(self.config.p2p.laddr)
            self.listen_addr = await self.transport.listen(host, port)
            await self.switch.start()
            if self.indexer_service is not None:
                await self.indexer_service.start()
            await self.pruner.start()
            await self._start_serving()
            # after the RPC server: its start-up does not wait on the
            # card's; before consensus, whose first checks queue on the
            # device-owner thread behind (or before) the warm launches
            if base.device_warmup:
                if _plan.resolve_devices(self.device)[0].type == "cuda":
                    self.warm_boot = asyncio.get_running_loop(
                    ).run_in_executor(None, self._warm_boot)
                else:
                    self.compile_bundle_info = _aotbundle.set_info(
                        {"status": "skipped_no_device"})
            if self.syncer is not None:
                self.statesync_done = asyncio.create_task(
                    self._run_statesync())
            if consensus:
                await self.start_consensus()
            await self._start_watchdog()
        except BaseException:
            await self.stop()
            raise

    def _warm_boot(self) -> None:
        """:func:`warm_boot` on an executor thread, for the validator set
        of the stored state; records ``compile_bundle_info``."""
        st = self.state_store.load()
        n_vals = len(st.validators.validators) if st is not None else 0
        self.compile_bundle_info = warm_boot(
            self.config.base, _plan.resolve_devices(self.device)[0], n_vals,
            name=self.name)

    async def _start_serving(self) -> None:
        """The RPC server, the gRPC services, the Prometheus listener and
        the loop watchdog, as configured."""
        cfg = self.config
        if cfg.rpc.laddr:
            self.rpc_server = RPCServer(self)
            self.rpc_addr = await self.rpc_server.listen(
                *_parse_laddr(cfg.rpc.laddr))
        if cfg.rpc.grpc_laddr:
            self.grpc_server = GRPCServer(
                self, *_parse_laddr(cfg.rpc.grpc_laddr))
            await self.grpc_server.start()
        inst = cfg.instrumentation
        if inst.prometheus:
            self.prometheus_server = await _serve_prometheus(
                inst.prometheus_listen_addr)
        if inst.loop_stall_threshold_s > 0:
            self.loop_watchdog = LoopWatchdog(
                asyncio.get_running_loop(),
                stall_threshold_s=inst.loop_stall_threshold_s,
                name=self.name)
            self.loop_watchdog.start()
        elif cfg.rpc.laddr and cfg.rpc.overload_shed_lag_s > 0:
            tmlog.logger("node", node=self.name).warn(
                "rpc.overload_shed_lag_s is set but the loop watchdog is "
                "off (instrumentation.loop_stall_threshold_s = 0): "
                "overload shedding is inactive")

    async def _start_watchdog(self) -> None:
        inst = self.config.instrumentation
        incident_dir = self.incident_dir()
        if inst.watchdog_stall_threshold_s > 0 and incident_dir is not None:
            self.liveness_watchdog = LivenessWatchdog(
                self, incident_dir,
                stall_threshold_s=inst.watchdog_stall_threshold_s,
                check_interval_s=inst.watchdog_check_interval_s,
                min_interval_s=inst.watchdog_min_interval_s,
                max_bundles=inst.watchdog_max_bundles,
                wal_tail_records=inst.watchdog_wal_tail)
            await self.liveness_watchdog.start()

    def incident_dir(self) -> str | None:
        """Where the watchdog's incident bundles live
        (``watchdog.resolve_incident_dir``)."""
        return resolve_incident_dir(self.config, self.home)

    async def start_consensus(self) -> None:
        """Start the consensus state machine of a node started with
        ``consensus=False`` (under ``fast_sync``, the blocksync handoff
        starts it instead)."""
        if not self.fast_sync and self.consensus._task is None:
            await self.consensus.start()

    async def stop(self) -> None:
        """Wait for the warm boot; stop statesync, the liveness watchdog,
        the RPC server, the gRPC services, the Prometheus listener, the loop watchdog, consensus, the switch
        (peers, reactors, listener), the indexer service, the pruner and
        the app connections; release the scheduler; close the WAL, every
        store and the data-directory lock.  Idempotent, and safe on a
        node whose :meth:`start` failed."""
        if self._started:
            self._started = False
            if self.warm_boot is not None:
                # its device calls must not outlive the node
                fut, self.warm_boot = self.warm_boot, None
                await fut
            if self.statesync_done is not None:
                task, self.statesync_done = self.statesync_done, None
                task.cancel()
                try:
                    await task
                except (asyncio.CancelledError, Exception):
                    pass
            if self.liveness_watchdog is not None:
                wd, self.liveness_watchdog = self.liveness_watchdog, None
                await wd.stop()
            if self.rpc_server is not None:
                server, self.rpc_server = self.rpc_server, None
                await server.close()
            if self.grpc_server is not None:
                gserver, self.grpc_server = self.grpc_server, None
                await gserver.stop()
            if self.prometheus_server is not None:
                prom, self.prometheus_server = self.prometheus_server, None
                prom.close()
                await prom.wait_closed()
            if self.loop_watchdog is not None:
                wd, self.loop_watchdog = self.loop_watchdog, None
                wd.stop()
            await self.consensus.stop()
            await self.switch.stop()
            if self.indexer_service is not None:
                await self.indexer_service.stop()
            await self.pruner.stop()
        if self._holds_scheduler:
            self._holds_scheduler = False
            await _vsched.release_scheduler()
        await self._close_resources()

    async def _close_resources(self) -> None:
        if self._closed:
            return
        self._closed = True
        if self.app_conns is not None:
            await self.app_conns.stop()
        if self.wal is not None:
            wal, self.wal = self.wal, None
            wal.close()
        dbs, self._dbs = self._dbs, []
        for db in dbs:
            db.close()
        if self._data_lock is not None:
            lock, self._data_lock = self._data_lock, None
            lock.release()

    async def dial_peer(self, addr: str, persistent: bool = True):
        return await self.switch.dial_peer(addr, persistent=persistent)

    # ------------------------------------------------------------- status

    def height(self) -> int:
        return self.block_store.height()
