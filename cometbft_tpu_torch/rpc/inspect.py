"""Inspect mode: a read-only RPC server over a (possibly crashed) node's
data directory — no consensus, no p2p (counterpart of
``cometbft_tpu/rpc/inspect.py``; reference:
``internal/inspect/inspect.go``).

Reuses the normal RPC server + routes against a shim exposing only the
stores; routes that need live subsystems (consensus introspection,
mempool, tx broadcast) answer with a clear error instead of hanging."""

from __future__ import annotations

from ..indexer import BlockIndexer, TxIndexer
from ..storage import BlockStore, StateStore, open_db


class _NoLiveSubsystem:
    def __getattr__(self, name):
        raise RuntimeError("not available in inspect mode (node offline)")

    def __bool__(self):
        # falsy so routes with their own `if node.consensus` guards
        # (status) degrade gracefully; everything else gets the loud error
        return False


class InspectNode:
    """The Environment-facing surface of a data directory."""

    def __init__(self, home: str, config, genesis_doc, name: str = "inspect"):
        import os

        self.config = config
        self.genesis = genesis_doc
        self.name = name
        self.home = home
        self.liveness_watchdog = None     # offline: list bundles only
        backend = config.storage.db_backend
        self.block_store = BlockStore(open_db(
            backend, os.path.join(home, "data", "blockstore.db")))
        self.state_store = StateStore(open_db(
            backend, os.path.join(home, "data", "state.db")))
        self.tx_indexer = None
        self.block_indexer = None
        if config.tx_index.indexer == "kv":
            self.tx_indexer = TxIndexer(open_db(
                backend, os.path.join(home, "data", "tx_index.db")))
            self.block_indexer = BlockIndexer(open_db(
                backend, os.path.join(home, "data", "block_index.db")))
        # report-only storage-doctor pass: a crashed node's store
        # inconsistency is exactly what inspect mode is for — never
        # repairs, never refuses (the report carries the refusal text)
        self.doctor_report = None
        try:
            from ..node.doctor import StorageDoctor

            self.doctor_report = StorageDoctor(
                self.block_store, self.state_store,
                wal_path=os.path.join(home, config.consensus.wal_path)
                if not os.path.isabs(config.consensus.wal_path)
                else config.consensus.wal_path,
                privval_state_path=os.path.join(
                    home, config.base.priv_validator_state_file)
                if not os.path.isabs(config.base.priv_validator_state_file)
                else config.base.priv_validator_state_file,
                deep_scan_window=config.storage.doctor_deep_scan_window,
                name=name).boot_check(repair=False,
                                      raise_on_refusal=False)
        except Exception:
            pass             # inspect must come up on ANY data dir
        # live-only surfaces: a falsy shim — `if node.consensus` guards
        # degrade gracefully, direct attribute access errors loudly
        self.consensus = _NoLiveSubsystem()
        self.mempool = _NoLiveSubsystem()
        self.app_conns = _NoLiveSubsystem()
        self.evidence_pool = _NoLiveSubsystem()
        self.switch = None
        self.node_key = None
        self.listen_addr = None
        self.blocksync_reactor = None
        self.pruner = None
        self.light_serve = None
        self.event_bus = _NoLiveSubsystem()

    def close(self) -> None:
        """Close the store handles (the port's stores hold their files
        open)."""
        for store in (self.block_store, self.state_store, self.tx_indexer,
                      self.block_indexer):
            db = getattr(store, "db", None)
            if db is not None:
                db.close()

    def incident_dir(self) -> str | None:
        """Same resolution as Node.incident_dir: a crashed validator's
        black-box bundles are exactly what inspect mode is for."""
        from ..node.watchdog import resolve_incident_dir

        return resolve_incident_dir(self.config, self.home)


async def run_inspect(home: str, config, genesis_doc,
                      host: str = "127.0.0.1", port: int = 0):
    """Start the read-only RPC server; returns (server, (host, port))."""
    from .server import RPCServer

    node = InspectNode(home, config, genesis_doc)
    server = RPCServer(node)
    addr = await server.listen(host, port)
    return server, addr
