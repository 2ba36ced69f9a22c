"""Sim node assembly (counterpart of ``cometbft_tpu/sim/node.py``): the
node's stack (ConsensusState; the consensus, mempool and evidence
reactors; Switch; PeerScorer) wired over
:class:`~cometbft_tpu_torch.sim.transport.MemTransport` instead of TCP,
with every store in memory and every clock read on the seam.

Deliberately not ``node.Node``: a node's assembly starts the verification
scheduler's micro-batches and other work whose completion order is
real-time nondeterminism the scenario lab must exclude.  A SimNode is the
subset that exercises the adversarial surfaces (consensus, gossip, peer
scoring, evidence) with no sockets.  Its checks are one-lane device calls
(``crypto/batch.py:device_call``) that block the loop's thread, so no
virtual time passes during one.

``device`` is the card every device call of the node uses (evidence,
commits, the app's trees); ``None`` means the card, and raises where
there is none.
"""

from __future__ import annotations

from dataclasses import asdict as dc_asdict
from dataclasses import dataclass, field
from dataclasses import fields as dc_fields

from ..abci import types as abci_t
from ..abci.client import LocalClient
from ..abci.kvstore import KVStoreApplication
from ..config import ConsensusConfig
from ..consensus.reactor import ConsensusReactor
from ..consensus.state import ConsensusState
from ..crypto import plan as _plan
from ..evidence import EvidencePool, EvidenceReactor
from ..libs import clock
from ..libs.pubsub import EventBus
from ..mempool.clist_mempool import CListMempool
from ..mempool.reactor import MempoolReactor
from ..p2p import NodeInfo, NodeKey, Switch
from ..p2p.quality import PeerScorer
from ..proxy.multi_app_conn import TracedAppConn
from ..sm.execution import BlockExecutor
from ..storage import BlockStore, MemDB, State, StateStore
from ..types.genesis import GenesisDoc, GenesisValidator
from ..types.priv_validator import MockPV
from .transport import MemNetwork, MemTransport

__all__ = ["SimTuning", "SimNode", "make_genesis", "make_sim_node"]


@dataclass
class SimTuning:
    """The knobs a scenario may turn, with sim-friendly defaults.  All
    durations are VIRTUAL seconds — generous values cost no real time,
    they only add timer events."""

    ping_interval: float = 2.0
    pong_timeout: float = 1.0
    gossip_sleep: float = 0.05       # consensus reactor idle poll
    mempool_gossip_sleep: float = 0.5
    mempool_size: int = 5000         # small values force full-pool shed
    mempool_mode: str = "announce"   # tx gossip dialect ("full" = old)
    mempool_fetch_timeout_s: float = 1.0
    ban_ttl_s: float = 10.0          # short: ban cycles fit in one run
    ban_score: float = 10.0
    disconnect_score: float = 5.0
    handshake_timeout: float = 4.0
    reconnect_base_delay: float = 0.25
    reconnect_max_delay: float = 2.0
    # statesync fabric (virtual seconds): tight timeouts keep byzantine-
    # seed detours cheap, and the re-request machinery is what's under test
    statesync_chunk_timeout: float = 3.0
    statesync_inflight: int = 4
    statesync_discovery: float = 0.5
    statesync_rounds: int = 5
    consensus: ConsensusConfig | None = None

    def to_dict(self) -> dict:
        """JSON-able form (Scenario.to_dict embeds it — a tuned scenario
        must survive the file round-trip, or its replay diverges)."""
        d = {f.name: getattr(self, f.name) for f in dc_fields(self)
             if f.name != "consensus"}
        if self.consensus is not None:
            d["consensus"] = dc_asdict(self.consensus)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "SimTuning":
        d = dict(d)
        cons = d.pop("consensus", None)
        tuning = cls(**d)
        if cons is not None:
            tuning.consensus = ConsensusConfig(**cons)
        return tuning

    def consensus_config(self) -> ConsensusConfig:
        if self.consensus is not None:
            return self.consensus
        # NOT test_consensus_config(): those timeouts assume direct
        # in-proc wiring.  Over a multi-hop gossip mesh a vote flood
        # takes tens of virtual ms, and an 80 ms propose timeout makes
        # rounds fail constantly — which costs real CPU (every failed
        # round is re-gossip + re-verification).  Virtual seconds are
        # free; failed rounds are not.
        ms = 1_000_000
        return ConsensusConfig(
            timeout_propose=1000 * ms, timeout_propose_delta=500 * ms,
            timeout_prevote=500 * ms, timeout_prevote_delta=250 * ms,
            timeout_precommit=500 * ms, timeout_precommit_delta=250 * ms,
            timeout_commit=100 * ms, peer_gossip_sleep_duration=50 * ms)


@dataclass
class SimNode:
    name: str
    pv: MockPV
    node_key: NodeKey
    app: KVStoreApplication
    consensus: ConsensusState
    consensus_reactor: ConsensusReactor
    switch: Switch
    transport: MemTransport
    block_store: BlockStore
    state_store: StateStore
    mempool: CListMempool
    evidence_pool: EvidencePool
    event_bus: EventBus
    mempool_reactor: MempoolReactor | None = None
    byzantine: str = ""              # adversary kind, "" = honest
    _adv_tasks: list = field(default_factory=list)

    @property
    def listen_addr(self) -> str:
        return f"mem://{self.name}"

    def height(self) -> int:
        return self.block_store.height()

    async def start(self) -> None:
        await self.transport.listen()
        await self.switch.start()
        await self.consensus.start()

    async def stop(self) -> None:
        for t in self._adv_tasks:
            t.cancel()
        self._adv_tasks.clear()
        try:
            await self.consensus.stop()
        except Exception:
            pass
        await self.switch.stop()

    async def dial(self, other: "SimNode", persistent: bool = True):
        return await self.switch.dial_peer(other.listen_addr,
                                           persistent=persistent)


def make_genesis(n_validators: int, chain_id: str = "sim-net",
                 secret_prefix: bytes = b"sim-val-",
                 key_types=None) -> tuple[GenesisDoc, list[MockPV]]:
    """Deterministic genesis + signers.  ``key_types`` mixes key
    algorithms: a string applies to every validator, a sequence sets
    validator i's type (shorter sequences pad with ed25519) — BLS
    validators' precommits then fold into the commit's aggregate lane
    block exactly as on a production mixed-key net."""
    if key_types is None:
        key_types = ()
    elif isinstance(key_types, str):
        key_types = (key_types,) * n_validators
    pvs = [MockPV.from_secret(
               secret_prefix + b"%d" % i,
               key_type=(key_types[i] if i < len(key_types) else "ed25519"))
           for i in range(n_validators)]
    doc = GenesisDoc(chain_id=chain_id,
                     validators=[GenesisValidator(pv.get_pub_key(), 10,
                                                  pop=pv.pop())
                                 for pv in pvs])
    return doc, pvs


async def make_sim_node(index: int, doc: GenesisDoc, pv: MockPV,
                        network: MemNetwork,
                        tuning: SimTuning | None = None,
                        name: str | None = None, device=None) -> SimNode:
    _plan.resolve_devices(device)          # raises without a card
    tuning = tuning or SimTuning()
    name = name or f"sim{index:03d}"
    node_key = NodeKey.from_secret(b"sim-key-%d" % index)
    app = KVStoreApplication(device=device)
    # the consensus connection rides the tracing shim so lab runs get
    # per-node ``abci`` spans (the timeline's ``app`` bucket); the
    # mempool connection stays bare: a CheckTx storm would flood the
    # shared ring
    client = TracedAppConn(LocalClient(app), "consensus", node=name)
    bus = EventBus()
    bstore = BlockStore(MemDB())
    sstore = StateStore(MemDB())
    mp = CListMempool(LocalClient(app), max_txs=tuning.mempool_size,
                      metrics_node=name)
    state = State.from_genesis(doc)
    evpool = EvidencePool(state_store=sstore, block_store=bstore,
                          device=device)
    evpool.state = state
    execu = BlockExecutor(sstore, bstore, client, mp,
                          evidence_pool=evpool, event_bus=bus,
                          device=device)
    await client.init_chain(abci_t.InitChainRequest(
        chain_id=doc.chain_id, initial_height=1, time_ns=0,
        validators=[abci_t.ValidatorUpdate(
            v.pub_key.type(), v.pub_key.bytes(), v.power, pop=v.pop)
            for v in doc.validators],
        app_state_bytes=doc.app_state))

    cs = ConsensusState(tuning.consensus_config(), state, execu, bstore,
                        priv_validator=pv, event_bus=bus,
                        now_ns=clock.walltime_ns, name=name)
    cs.on_conflicting_vote = evpool.report_conflicting_votes

    node_box: list[SimNode] = []

    def node_info() -> NodeInfo:
        sw = node_box[0].switch if node_box else None
        return NodeInfo(node_id=node_key.id,
                        listen_addr=f"mem://{name}",
                        network=doc.chain_id,
                        channels=sw.channel_ids if sw else b"",
                        moniker=name)

    transport = MemTransport(node_key, node_info, network, name,
                             handshake_timeout=tuning.handshake_timeout)
    scorer = PeerScorer(ban_ttl_s=tuning.ban_ttl_s,
                        ban_score=tuning.ban_score,
                        disconnect_score=tuning.disconnect_score)
    switch = Switch(transport,
                    ping_interval=tuning.ping_interval,
                    pong_timeout=tuning.pong_timeout,
                    telemetry_interval=0,
                    scorer=scorer, name=name,
                    reconnect_base_delay=tuning.reconnect_base_delay,
                    reconnect_max_delay=tuning.reconnect_max_delay)
    cons_reactor = ConsensusReactor(cs, gossip_sleep=tuning.gossip_sleep)
    switch.add_reactor("consensus", cons_reactor)
    mp_reactor = MempoolReactor(
        mp, gossip_sleep=tuning.mempool_gossip_sleep,
        gossip_mode=tuning.mempool_mode,
        fetch_timeout_s=tuning.mempool_fetch_timeout_s)
    switch.add_reactor("mempool", mp_reactor)
    switch.add_reactor("evidence", EvidenceReactor(evpool))

    node = SimNode(name=name, pv=pv, node_key=node_key, app=app,
                   consensus=cs, consensus_reactor=cons_reactor,
                   switch=switch, transport=transport,
                   block_store=bstore, state_store=sstore, mempool=mp,
                   evidence_pool=evpool, event_bus=bus,
                   mempool_reactor=mp_reactor)
    node_box.append(node)
    return node
