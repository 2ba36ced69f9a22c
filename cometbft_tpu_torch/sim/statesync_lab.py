"""Statesync scenario lab (counterpart of
``cometbft_tpu/sim/statesync_lab.py``): fleet-scale snapshot bootstrap
under seeded gray failures, on the virtual clock, with a replay-identical
verdict.

N validators make a chain with real app state, a handful of them act as
statesync seeds, and a fleet of fresh bootstrappers (statesync-only
assemblies: switch, statesync reactor, syncer and a light-client state
provider, no consensus) sync concurrently from those seeds while the
fault plane serves drop and delay gray failures and one byzantine seed
serves corrupt chunks.  Manifest verification must catch the corrupt
chunks (sender scored and banned, the chunk re-requested from an honest
seed, no restore reset), and every bootstrapper must reach the serving
height.

The verdict is a pure function of (scenario, seed): the
time-to-serving-height distribution, restore heights, summed syncer
tallies, who banned the byzantine seed, and the fault plane's signature.
The validators' checks, the bootstrappers' light clients and the apps'
trees run on ``device`` (``None``: the card, raising where there is
none).
"""

from __future__ import annotations

import asyncio
from dataclasses import dataclass, field
from types import SimpleNamespace

from ..crypto import plan as _plan
from ..libs import clock, failures
from ..libs import log as tmlog

from ..abci.client import LocalClient
from ..abci.kvstore import KVStoreApplication
from ..light import Client, LocalNodeProvider, TrustOptions
from ..p2p import NodeInfo, NodeKey, Switch
from ..p2p.quality import PeerScorer
from ..statesync import StateProvider, StatesyncReactor, Syncer
from . import vtime
from .node import SimNode, SimTuning, make_genesis, make_sim_node
from .transport import MemNetwork, MemTransport

__all__ = ["StatesyncScenario", "run_statesync_scenario",
           "curated_statesync_scenario", "TRUST_PERIOD_NS"]

TRUST_PERIOD_NS = 3600 * 1_000_000_000


@dataclass
class StatesyncScenario:
    """Pure data describing one lab run (JSON-able like Scenario)."""

    name: str
    seed: int = 0
    n_validators: int = 10
    n_seeds: int = 4                 # validators serving statesync
    n_bootstrappers: int = 40
    # chain must carry at least this many committed heights before the
    # fleet starts (kvstore snapshots every height)
    snapshot_wait_height: int = 8
    trust_height: int = 2
    # app-state ballast: n_txs values of tx_value_bytes each, committed
    # before the fleet starts, so snapshots span MORE 64 KiB chunks than
    # there are seeds — every seed (the byzantine one included) lands in
    # the round-robin rotation of every bootstrapper
    n_txs: int = 40
    tx_value_bytes: int = 8192
    byzantine_seeds: list[int] = field(default_factory=list)
    faults: list[str] = field(default_factory=list)      # chaos, t=0
    link_specs: list[str] = field(default_factory=list)  # transport, t=0
    max_virtual_s: float = 600.0
    tuning: SimTuning = field(default_factory=SimTuning)

    def to_dict(self) -> dict:
        return {"name": self.name, "seed": self.seed,
                "n_validators": self.n_validators,
                "n_seeds": self.n_seeds,
                "n_bootstrappers": self.n_bootstrappers,
                "snapshot_wait_height": self.snapshot_wait_height,
                "trust_height": self.trust_height,
                "n_txs": self.n_txs,
                "tx_value_bytes": self.tx_value_bytes,
                "byzantine_seeds": list(self.byzantine_seeds),
                "faults": list(self.faults),
                "link_specs": list(self.link_specs),
                "max_virtual_s": self.max_virtual_s,
                "tuning": self.tuning.to_dict()}

    @classmethod
    def from_dict(cls, d: dict) -> "StatesyncScenario":
        d = dict(d)
        tuning = SimTuning.from_dict(d.pop("tuning")) \
            if "tuning" in d else SimTuning()
        return cls(tuning=tuning, **d)


@dataclass
class _Bootstrapper:
    """A statesync-only node assembly: enough machinery to fetch and
    restore a snapshot, nothing else (no consensus, no mempool)."""

    name: str
    node_key: NodeKey
    app: KVStoreApplication
    switch: Switch
    reactor: StatesyncReactor
    syncer: Syncer
    sync_s: float | None = None      # virtual time-to-serving-height
    restored_height: int | None = None
    error: str = ""

    async def stop(self) -> None:
        try:
            await self.switch.stop()
        except Exception:
            pass


class _LabRun:
    def __init__(self, scn: StatesyncScenario, device=None):
        self.scn = scn
        self.device = device
        self.log = tmlog.logger("sim.sslab", node=scn.name)
        self.network = MemNetwork()
        self.validators: list[SimNode] = []
        self.boots: list[_Bootstrapper] = []

    async def build(self) -> None:
        scn = self.scn
        failures.reset()
        failures.configure(enabled=True, seed=scn.seed,
                           faults=list(scn.faults))
        from ..crypto import scheduler as _vsched

        self._prev_sched = _vsched.get_scheduler()
        self._sched_installed = True
        _vsched.set_scheduler(_vsched.VerificationScheduler(
            device=self.device, cache_size=262144))
        for spec in scn.link_specs:
            self.network.apply_spec(spec)
        doc, pvs = make_genesis(scn.n_validators,
                                chain_id=f"sslab-{scn.name}")
        self._doc = doc
        for i, pv in enumerate(pvs):
            node = await make_sim_node(i, doc, pv, self.network,
                                       tuning=scn.tuning,
                                       device=self.device)
            # every validator serves statesync (it costs one reactor);
            # the fleet only DIALS the first n_seeds of them
            reactor = StatesyncReactor(
                SimpleNamespace(snapshot=LocalClient(node.app)),
                name=f"{node.name}.ss")
            node.switch.add_reactor("statesync", reactor)
            self.validators.append(node)

    def _restore_scheduler(self) -> None:
        if getattr(self, "_sched_installed", False):
            from ..crypto import scheduler as _vsched

            self._sched_installed = False
            _vsched.set_scheduler(self._prev_sched)

    async def _start_chain(self) -> None:
        scn = self.scn
        for node in self.validators:
            await node.start()
        n = len(self.validators)
        k = 3
        edges = sorted({tuple(sorted((i, (i + d) % n)))
                        for i in range(n)
                        for d in range(1, min(k, n - 1) + 1)})

        async def _dial(i: int, j: int) -> None:
            try:
                await self.validators[i].dial(self.validators[j],
                                              persistent=True)
            except Exception:
                pass    # racing duplicate: persistent-reconnect heals

        await asyncio.gather(*[_dial(i, j) for i, j in edges])
        # app-state ballast so snapshots span multiple chunks
        for t in range(scn.n_txs):
            val = b"v%03d" % t + b"x" * scn.tx_value_bytes
            await self.validators[t % n].mempool.check_tx(
                b"labk%03d=" % t + val)
        deadline = clock.monotonic() + scn.max_virtual_s / 2
        while min(v.height() for v in self.validators) < \
                scn.snapshot_wait_height:
            if clock.monotonic() > deadline:
                raise RuntimeError("chain never reached snapshot height")
            await clock.sleep(0.1)

    def _make_bootstrapper(self, i: int, trust_hash: bytes
                           ) -> _Bootstrapper:
        scn = self.scn
        name = f"boot{i:03d}"
        node_key = NodeKey.from_secret(b"sim-boot-%d" % i)
        app = KVStoreApplication(device=self.device)
        client = LocalClient(app)
        app_conns = SimpleNamespace(snapshot=client, query=client)
        # light client reads an HONEST seed's stores (out-of-band trust
        # anchor, like production operators pinning an RPC + hash)
        honest = [v for k, v in enumerate(self.validators[:scn.n_seeds])
                  if k not in scn.byzantine_seeds]
        src = honest[i % len(honest)]
        light = Client(
            self._doc.chain_id,
            TrustOptions(TRUST_PERIOD_NS, scn.trust_height, trust_hash),
            LocalNodeProvider(src.block_store, src.state_store),
            device=self.device, now_ns=clock.walltime_ns)
        provider = StateProvider(light, self._doc)

        box: list[_Bootstrapper] = []

        def node_info() -> NodeInfo:
            sw = box[0].switch if box else None
            return NodeInfo(node_id=node_key.id,
                            listen_addr=f"mem://{name}",
                            network=self._doc.chain_id,
                            channels=sw.channel_ids if sw else b"",
                            moniker=name)

        transport = MemTransport(node_key, node_info, self.network, name,
                                 handshake_timeout=scn.tuning
                                 .handshake_timeout)
        switch = Switch(transport,
                        ping_interval=scn.tuning.ping_interval,
                        pong_timeout=scn.tuning.pong_timeout,
                        telemetry_interval=0,
                        scorer=PeerScorer(
                            ban_ttl_s=scn.tuning.ban_ttl_s,
                            ban_score=scn.tuning.ban_score,
                            disconnect_score=scn.tuning
                            .disconnect_score),
                        name=name)
        reactor = StatesyncReactor(app_conns, name=f"{name}.ss")
        syncer = Syncer(
            app_conns, provider, reactor=reactor, name=name,
            chunk_timeout=scn.tuning.statesync_chunk_timeout,
            max_inflight_per_peer=scn.tuning.statesync_inflight,
            discovery_time=scn.tuning.statesync_discovery,
            discovery_rounds=scn.tuning.statesync_rounds,
            in_memory_spool=True)   # determinism: no threads, no disk
        reactor.syncer = syncer
        switch.add_reactor("statesync", reactor)
        boot = _Bootstrapper(name=name, node_key=node_key, app=app,
                             switch=switch, reactor=reactor,
                             syncer=syncer)
        box.append(boot)
        return boot

    async def _run_fleet(self) -> None:
        scn = self.scn
        trust_hash = self.validators[0].block_store.load_block(
            scn.trust_height).hash()
        self.boots = [self._make_bootstrapper(i, trust_hash)
                      for i in range(scn.n_bootstrappers)]
        seeds = self.validators[:scn.n_seeds]

        async def _bootstrap(boot: _Bootstrapper) -> None:
            await boot.switch.start()
            for seed in seeds:
                try:
                    await boot.switch.dial_peer(seed.listen_addr,
                                                persistent=True)
                except Exception:
                    pass
            t0 = clock.monotonic()
            try:
                state, _commit = await asyncio.wait_for(
                    boot.syncer.sync(), scn.max_virtual_s)
                boot.sync_s = round(clock.monotonic() - t0, 3)
                boot.restored_height = state.last_block_height
            except Exception as e:
                boot.error = f"{type(e).__name__}: {e}"

        await asyncio.gather(*[_bootstrap(b) for b in self.boots])

    async def run(self) -> dict:
        t_start = clock.monotonic()
        await self._start_chain()
        await self._run_fleet()
        return self._verdict(t_start)

    async def stop(self) -> None:
        for boot in self.boots:
            await boot.stop()
        for node in self.validators:
            try:
                await node.stop()
            except Exception:
                pass
        self._restore_scheduler()

    def _verdict(self, t_start: float) -> dict:
        scn = self.scn
        byz_ids = {self.validators[k].node_key.id
                   for k in scn.byzantine_seeds}
        done = [b for b in self.boots if b.sync_s is not None]
        dts = sorted(b.sync_s for b in done)

        def pct(p: float) -> float | None:
            if not dts:
                return None
            return dts[min(len(dts) - 1, int(p * (len(dts) - 1)))]

        tallies: dict[str, int] = {}
        for b in self.boots:
            for k, v in b.syncer.tallies.items():
                tallies[k] = tallies.get(k, 0) + v
        banned_byz_by = sorted(
            b.name for b in self.boots
            if byz_ids & b.syncer._banned)
        # fork-free check: every restored app must report the same hash
        # as the validators' chain at its restored height (the manifest
        # path must never let divergent state through)
        restored_heights = sorted({b.restored_height for b in done})
        restore_ok = True
        witness = self.validators[0]
        for h in restored_heights:
            blk = witness.block_store.load_block(h + 1)
            want = blk.header.app_hash if blk is not None else None
            for b in done:
                if b.restored_height == h and want is not None and \
                        b.app.app_hash != want:
                    restore_ok = False
        return {
            "scenario": scn.name,
            "seed": scn.seed,
            "n_validators": scn.n_validators,
            "n_seeds": scn.n_seeds,
            "n_bootstrappers": scn.n_bootstrappers,
            "byzantine_seeds": [f"sim{k:03d}"
                                for k in sorted(scn.byzantine_seeds)],
            "completed": len(done),
            "failed": {b.name: b.error for b in self.boots if b.error},
            "restored_heights": restored_heights,
            "restored_state_matches_chain": restore_ok,
            "time_to_serving_height_s": {
                "min": dts[0] if dts else None,
                "p50": pct(0.50), "p90": pct(0.90),
                "max": dts[-1] if dts else None,
                "mean": round(sum(dts) / len(dts), 3) if dts else None,
                "all": dts,
            },
            "syncer_tallies": dict(sorted(tallies.items())),
            "byzantine_banned_by": banned_byz_by,
            "chaos": {"signature_len": len(failures.signature()),
                      "sites": {s: v["fired"] for s, v in sorted(
                          failures.stats().get("sites", {}).items())}},
            "virtual_duration_s": round(clock.monotonic() - t_start, 3),
        }


async def _run_async(scn: StatesyncScenario, device) -> dict:
    run = _LabRun(scn, device)
    try:
        await run.build()
        return await run.run()
    finally:
        await run.stop()
        failures.reset()


def run_statesync_scenario(scn: StatesyncScenario, device=None) -> dict:
    """Run one lab program to verdict on a fresh virtual-time loop, its
    device work on ``device``.  Same scenario and seed: the same
    verdict dict."""
    _plan.resolve_devices(device)          # raises without a card
    return vtime.run(lambda: _run_async(scn, device), seed=scn.seed)


def curated_statesync_scenario(small: bool = False) -> StatesyncScenario:
    """The flagship 50-node program: 40 bootstrappers sync concurrently
    from 4 seeds under drop/delay gray failures while seed ``sim003``
    serves corrupt chunks (``small=True`` shrinks it for CI-speed
    tests)."""
    byz = "sim003.ss"
    scn = StatesyncScenario(
        name="fleet-bootstrap-50",
        seed=1801,
        n_validators=10, n_seeds=4, n_bootstrappers=40,
        byzantine_seeds=[3],
        # gray failures: one seed delayed on every link, another
        # dropping every 13th p2p send (bounded) — slow paths, not
        # dead ones
        link_specs=["link:node=sim001:peer=*:delay=0.05"],
        faults=[f"statesync.serve.corrupt:node={byz}:every=1",
                "p2p.send.drop:node=sim002:every=13:max=400"],
        tuning=SimTuning(statesync_chunk_timeout=3.0,
                         statesync_discovery=0.5))
    if small:
        scn.name = "fleet-bootstrap-small"
        scn.seed = 1802
        scn.n_validators = 4
        scn.n_seeds = 3
        scn.n_bootstrappers = 4
        scn.byzantine_seeds = [2]
        scn.n_txs = 20
        scn.tx_value_bytes = 16384
        scn.faults = ["statesync.serve.corrupt:node=sim002.ss:every=1"]
        scn.link_specs = []
    return scn
