"""In-process consensus networks (counterpart of
``cometbft_tpu/testing.py:149-339``; the reference's ``common_test.go``
ensemble without networking).

:func:`make_inproc_network` builds N validators in one event loop, each
with its own kvstore app, stores, CList mempool, evidence pool, block
executor and consensus state, wired by direct queue calls.  ``device``
is where every signature and large hash of the network is verified
(None: CUDA, raising without a card; ``"cpu"``: the kernels' plain
versions, as the tests run them).  The network acquires the process-wide
verification scheduler (``crypto/scheduler.py``) on that device when it
is made and releases it in :meth:`InProcNetwork.stop`: the scheduler is
shared by every node, so a vote verified once is a cache hit for the
others.  All N validators share one interpreter here, where a real
network runs one process per machine.
"""

from __future__ import annotations

import asyncio
import collections
from dataclasses import dataclass

from .abci import types as abci_t
from .abci.client import LocalClient
from .abci.kvstore import KVStoreApplication
from .config import test_consensus_config
from .consensus.reactor import votes_from_commit
from .consensus.state import ConsensusState
from .consensus.wal import WAL
from .crypto import scheduler as _vsched
from .evidence import EvidencePool
from .libs.pubsub import EventBus
from .mempool.clist_mempool import CListMempool
from .sm.execution import BlockExecutor
from .storage.blockstore import BlockStore
from .storage.db import MemDB
from .storage.statestore import State, StateStore
from .types.genesis import GenesisDoc, GenesisValidator
from .types.priv_validator import MockPV

__all__ = ["InProcNode", "InProcNetwork", "make_inproc_network"]


@dataclass
class InProcNode:
    name: str
    pv: object
    app: object
    state: object
    consensus: object
    block_store: object
    state_store: object
    mempool: object
    event_bus: object
    wal_path: str | None = None
    evidence_pool: object = None


class InProcNetwork:
    """N validators in one event loop with direct queue wiring.  Holds
    one reference to the process-wide verification scheduler from
    :func:`make_inproc_network` until :meth:`stop`.  ``delivered``
    counts the messages handed to nodes, by kind (``vote``,
    ``proposal``, ``part``, and ``catchup_vote``/``catchup_part`` from
    the catch-up routine)."""

    def __init__(self, nodes: list[InProcNode], device=None):
        self.nodes = nodes
        self.device = device
        self.isolated: set[str] = set()      # names cut off from gossip
        self.delivered: collections.Counter = collections.Counter()
        self._catchup_task = None
        self._holds_scheduler = False
        for node in nodes:
            self._wire(node)

    def _wire(self, node: InProcNode):
        cs = node.consensus

        def broadcast(fn_name, kind, *args, _from=node.name):
            if _from in self.isolated:
                return
            for other in self.nodes:
                if other.name == _from or other.name in self.isolated:
                    continue
                self.delivered[kind] += 1
                getattr(other.consensus, fn_name)(*args, _from)

        cs.broadcast_proposal = lambda p, _f=node.name: broadcast(
            "feed_proposal", "proposal", p, _from=_f)
        cs.broadcast_block_part = lambda h, r, part, _f=node.name: broadcast(
            "feed_block_part", "part", h, r, part, _from=_f)
        cs.broadcast_vote = lambda v, _f=node.name: broadcast(
            "feed_vote", "vote", v, _from=_f)

    def isolate(self, name: str):
        self.isolated.add(name)

    def heal(self, name: str):
        self.isolated.discard(name)

    async def start(self):
        for n in self.nodes:
            await n.consensus.start()
        self._catchup_task = asyncio.create_task(self._catchup_routine())

    async def stop(self):
        if self._catchup_task is not None:
            self._catchup_task.cancel()
            try:
                await self._catchup_task
            except asyncio.CancelledError:
                pass
            self._catchup_task = None
        for n in self.nodes:
            await n.consensus.stop()
        if self._holds_scheduler:
            self._holds_scheduler = False
            await _vsched.release_scheduler()

    async def _catchup_routine(self):
        """Feed lagging nodes the stored commit votes and block parts of
        their current height: the in-process stand-in for the consensus
        reactor's catch-up gossip (reactor.go:590,646)."""
        while True:
            await asyncio.sleep(0.05)
            for lag in self.nodes:
                cs = lag.consensus
                if lag.name in self.isolated or cs._task is None or \
                        cs._task.done():
                    continue
                h = cs.rs.height
                for src in self.nodes:
                    if src is lag or src.name in self.isolated or \
                            src.block_store.height() < h:
                        continue
                    commit = src.block_store.load_block_commit(h)
                    if commit is None:
                        seen = src.block_store.load_seen_commit()
                        if seen is not None and seen.height == h:
                            commit = seen
                    if commit is None:
                        continue
                    votes = votes_from_commit(commit)
                    self.delivered["catchup_vote"] += len(votes)
                    for v in votes:
                        cs.feed_vote(v, f"catchup:{src.name}")
                    parts = src.block_store.load_block_parts(
                        h, device=self.device)
                    if parts is not None:
                        self.delivered["catchup_part"] += parts.total
                        for i in range(parts.total):
                            cs.feed_block_part(h, commit.round,
                                               parts.get_part(i),
                                               f"catchup:{src.name}")
                    break

    async def wait_for_height(self, height: int, timeout: float = 30.0,
                              nodes=None):
        targets = nodes or self.nodes

        async def all_reached():
            while True:
                if all(t.block_store.height() >= height for t in targets):
                    return
                await asyncio.sleep(0.01)

        await asyncio.wait_for(all_reached(), timeout)


async def make_inproc_network(n_validators: int = 4, *, chain_id="test-net",
                              app_factory=None, config=None,
                              vote_extensions_height: int = 0,
                              pbts_height: int = 0,
                              wal_dir: str | None = None,
                              device=None,
                              power=None,
                              pv_factory=None) -> InProcNetwork:
    """N validators of ``power[i]`` (10 each by default) on ``device``,
    keys ``MockPV.from_secret(b"inproc%d" % i)`` unless ``pv_factory``
    makes them; a WAL per node under ``wal_dir`` when given.  Acquires
    the verification scheduler on ``device`` (raising without a card when
    ``device`` is None)."""
    app_factory = app_factory or (lambda: KVStoreApplication(device=device))
    cfg = config or test_consensus_config()
    pv_factory = pv_factory or \
        (lambda i: MockPV.from_secret(b"inproc%d" % i))
    pvs = [pv_factory(i) for i in range(n_validators)]
    doc = GenesisDoc(chain_id=chain_id,
                     validators=[GenesisValidator(
                         pv.get_pub_key(),
                         (power[i] if power else 10),
                         pop=getattr(pv, "pop", lambda: b"")())
                         for i, pv in enumerate(pvs)])
    doc.consensus_params.feature.vote_extensions_enable_height = \
        vote_extensions_height
    doc.consensus_params.feature.pbts_enable_height = pbts_height

    await _vsched.acquire_scheduler(device=device)
    try:
        nodes = []
        for i, pv in enumerate(pvs):
            app = app_factory()
            client = LocalClient(app)
            bus = EventBus()
            bstore = BlockStore(MemDB())
            sstore = StateStore(MemDB())
            mp = CListMempool(LocalClient(app))
            state = State.from_genesis(doc)
            evpool = EvidencePool(state_store=sstore, block_store=bstore,
                                  device=device)
            evpool.state = state
            execu = BlockExecutor(sstore, bstore, client, mp,
                                  evidence_pool=evpool, event_bus=bus,
                                  device=device)
            await client.init_chain(abci_t.InitChainRequest(
                chain_id=chain_id, initial_height=1, time_ns=0,
                validators=[abci_t.ValidatorUpdate(
                    v.pub_key.type(), v.pub_key.bytes(), v.power, pop=v.pop)
                    for v in doc.validators],
                app_state_bytes=doc.app_state))
            wal_path = f"{wal_dir}/wal{i}.log" if wal_dir else None
            wal = WAL(wal_path) if wal_path else None
            cs = ConsensusState(cfg, state, execu, bstore, wal=wal,
                                priv_validator=pv, event_bus=bus,
                                name=f"node{i}")
            cs.on_conflicting_vote = evpool.report_conflicting_votes
            nodes.append(InProcNode(
                name=f"node{i}", pv=pv, app=app, state=state, consensus=cs,
                block_store=bstore, state_store=sstore, mempool=mp,
                event_bus=bus, wal_path=wal_path, evidence_pool=evpool))
    except BaseException:
        await _vsched.release_scheduler()
        raise
    net = InProcNetwork(nodes, device=device)
    net._holds_scheduler = True
    return net
