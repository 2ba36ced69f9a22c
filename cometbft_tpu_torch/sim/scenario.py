"""Scenario programs (counterpart of ``cometbft_tpu/sim/scenario.py``):
seeded, declarative adversarial runs over the virtual clock, each
emitting a machine-readable verdict.

A :class:`Scenario` is pure data (JSON-able through ``to_dict``/
``from_dict``; the JAX package's dicts load unchanged): the net's shape,
the byzantine cast, fault-plane specs armed at t=0, transport shaping,
and a list of timed steps ``{"at": <virtual s>, "op": <op>, ...}``:

- ``partition``: ``groups``, lists of node indices; ``one_way`` for the
  asymmetric cut (requests vanish, replies flow),
- ``heal``: clear every cut,
- ``link``: ``spec``, transport shaping in the ``libs/failures``
  grammar (``link:node=sim003:peer=*:delay=0.2``),
- ``arm`` / ``disarm``: add or remove a fault-plane rule mid-run,
- ``crash`` / ``restore``: ``node``, an index; a crash stops the node's
  consensus and switch, a restore rebuilds it wiped and rejoins.

Every field of the verdict is a pure function of the scenario and its
seed (virtual timestamps, block hashes, the fault plane's signature, the
ban and evidence ledgers), so ``run_scenario(s) == run_scenario(s)`` and
the port's verdict equals the JAX package's.  Wall-clock cost lives
outside the verdict.

The run installs one ``VerificationScheduler`` on ``device`` and never
starts it: every cache miss is one synchronous device call on the
device-owner thread (a one-lane check), which blocks the loop, so the
verdict does not depend on the device's speed.  ``device=None`` means
the card and raises where there is none.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field

from ..crypto import plan as _plan
from ..libs import clock, failures
from ..libs import log as tmlog
from . import adversary, vtime
from .node import SimNode, SimTuning, make_genesis, make_sim_node
from .transport import MemNetwork

__all__ = ["Scenario", "run_scenario", "chaos_signature_of",
           "curated_suite", "POLL_S"]

POLL_S = 0.05        # verdict monitor cadence (virtual)


@functools.cache
def _sim_metrics():
    from ..libs import metrics as m

    return (
        m.counter("sim_scenario_runs_total",
                  "scenario-lab runs completed, by scenario"),
        m.counter("sim_scenario_forks_total",
                  "scenario runs that ended with a fork across honest "
                  "nodes (any nonzero is a consensus safety bug)"),
        m.counter("sim_scenario_virtual_seconds_total",
                  "virtual seconds simulated across scenario runs"),
        m.gauge("sim_scenario_time_to_recover_seconds",
                "virtual seconds from the last disruptive step to "
                "full honest progress, most recent run, by scenario"),
    )


@dataclass
class Scenario:
    name: str
    seed: int = 0
    n_nodes: int = 4
    out_links: int = 2               # dials per node (ring + skips)
    target_height: int = 5
    max_virtual_s: float = 600.0
    byzantine: dict[int, str] = field(default_factory=dict)
    steps: list[dict] = field(default_factory=list)
    faults: list[str] = field(default_factory=list)      # chaos specs, t=0
    link_specs: list[str] = field(default_factory=list)  # transport, t=0
    tuning: SimTuning = field(default_factory=SimTuning)
    key_types: list[str] = field(default_factory=list)   # per-validator algo

    def to_dict(self) -> dict:
        return {"name": self.name, "seed": self.seed,
                "n_nodes": self.n_nodes, "out_links": self.out_links,
                "target_height": self.target_height,
                "max_virtual_s": self.max_virtual_s,
                "byzantine": {str(k): v for k, v in self.byzantine.items()},
                "steps": list(self.steps), "faults": list(self.faults),
                "link_specs": list(self.link_specs),
                "tuning": self.tuning.to_dict(),
                "key_types": list(self.key_types)}

    @classmethod
    def from_dict(cls, d: dict) -> "Scenario":
        return cls(name=d["name"], seed=int(d.get("seed", 0)),
                   n_nodes=int(d.get("n_nodes", 4)),
                   out_links=int(d.get("out_links", 2)),
                   target_height=int(d.get("target_height", 5)),
                   max_virtual_s=float(d.get("max_virtual_s", 600.0)),
                   byzantine={int(k): v
                              for k, v in d.get("byzantine", {}).items()},
                   steps=list(d.get("steps", [])),
                   faults=list(d.get("faults", [])),
                   link_specs=list(d.get("link_specs", [])),
                   tuning=SimTuning.from_dict(d["tuning"])
                   if "tuning" in d else SimTuning(),
                   key_types=list(d.get("key_types", [])))

    def honest_indices(self) -> list[int]:
        return [i for i in range(self.n_nodes) if i not in self.byzantine]


class _Run:
    """One in-flight scenario: nodes, the step driver, the monitor."""

    def __init__(self, scn: Scenario, device=None):
        self.scn = scn
        self.device = device
        self.log = tmlog.logger("sim", node=scn.name)
        self.network = MemNetwork()
        self.nodes: list[SimNode] = []
        self.t0 = 0.0
        self.commit_done_at: dict[int, float] = {}   # height -> virtual s
        self.step_log: list[dict] = []               # executed steps
        self.last_disruption_at: float | None = None
        self.recovered_at: float | None = None
        self.crashed: set[int] = set()

    # ------------------------------------------------------------- build

    async def build(self) -> None:
        scn = self.scn
        failures.reset()
        failures.configure(enabled=True, seed=scn.seed,
                           faults=list(scn.faults))
        # Flight recorder ON for the run: every node's spans land in the
        # shared process-wide ring with virtual-time stamps, and the
        # verdict folds them into per-phase latency attribution
        # (libs/timeline).  Ring sized to hold the whole fleet's
        # timeline; record COUNT is deterministic, so any eviction is
        # replay-identical too.  Restored (and cleared) after the run.
        from ..libs import tracing as _tracing

        st = _tracing.stats()
        self._prev_tracing = (st["enabled"], st["ring_size"])
        self._tracing_installed = True
        _tracing.clear()
        _tracing.configure(
            enabled=True,
            ring_size=max(8192,
                          scn.n_nodes * max(scn.target_height, 1) * 128))
        # One process-wide verified-signature cache shared by every sim
        # node (the positive-only cache of a scheduler that is never
        # started: verify_sync is one synchronous device call a miss).
        # Ed25519 verification is a pure function, so N nodes re-checking
        # one gossiped vote would be N-1 redundant checks.  Verdicts are
        # unaffected (a hit returns the bool a fresh check would) and the
        # evidence paths stay on verify_uncached.
        from ..crypto import scheduler as _vsched

        self._prev_sched = _vsched.get_scheduler()
        self._sched_installed = True
        _vsched.set_scheduler(_vsched.VerificationScheduler(
            device=self.device, cache_size=262144))
        for spec in scn.link_specs:
            self.network.apply_spec(spec)
        doc, pvs = make_genesis(scn.n_nodes,
                                chain_id=f"sim-{scn.name}",
                                key_types=scn.key_types)
        for i, pv in enumerate(pvs):
            node = await make_sim_node(i, doc, pv, self.network,
                                       tuning=scn.tuning,
                                       device=self.device)
            kind = scn.byzantine.get(i)
            if kind:
                adversary.attach(node, kind, scn.seed)
            self.nodes.append(node)
        self._doc = doc

    async def start(self) -> None:
        import asyncio

        for node in self.nodes:
            await node.start()

        async def _dial(node: SimNode, peer: SimNode) -> None:
            try:
                await node.dial(peer, persistent=True)
            except Exception:
                # a link cut at t=0 (or a racing duplicate): hand the
                # address to the persistent-reconnect machinery so the
                # topology self-heals when the cut lifts
                node.switch._schedule_reconnect(peer.listen_addr)

        # concurrent dial storm: sequential awaits would consume k*n
        # handshake round-trips of VIRTUAL time before t0, skewing
        # every step's schedule
        await asyncio.gather(*[
            _dial(self.nodes[i], self.nodes[j])
            for i, j in self._topology()])

    def _topology(self) -> list[tuple[int, int]]:
        """Seeded small-world mesh: a 2-out ring (connectivity floor)
        plus ``out_links - 2`` seeded long-range links per node.  A pure
        k-out ring has diameter n/2k — at 100 nodes every gossip wave
        pays ~17 sequential link latencies and heights take virtual
        *seconds*; the shortcuts bring the diameter to ~log n, which is
        also what a PEX-formed production mesh actually looks like."""
        import random as _random

        n = len(self.nodes)
        k = max(1, self.scn.out_links)
        rng = _random.Random(f"{self.scn.seed}:topology")
        edges: set[tuple[int, int]] = set()

        def add(i: int, j: int) -> None:
            if i != j and (i, j) not in edges and (j, i) not in edges:
                edges.add((i, j))
        for i in range(n):
            for d in range(1, min(2, k) + 1):
                add(i, (i + d) % n)
            for _ in range(k - 2):
                for _attempt in range(8):
                    j = rng.randrange(n)
                    if j != i and (i, j) not in edges and \
                            (j, i) not in edges:
                        add(i, j)
                        break
        return sorted(edges)

    async def stop(self) -> None:
        for node in self.nodes:
            try:
                await node.stop()
            except Exception:
                pass
        self._restore_scheduler()

    def _restore_scheduler(self) -> None:
        if getattr(self, "_sched_installed", False):
            from ..crypto import scheduler as _vsched

            self._sched_installed = False
            _vsched.set_scheduler(self._prev_sched)
        if getattr(self, "_tracing_installed", False):
            from ..libs import tracing as _tracing

            self._tracing_installed = False
            enabled, ring = self._prev_tracing
            _tracing.clear()        # sim records must not leak out
            _tracing.configure(enabled=enabled, ring_size=ring)

    # ------------------------------------------------------------- steps

    def _names(self, indices) -> list[str]:
        return [self.nodes[int(i)].name for i in indices]

    async def _apply_step(self, step: dict) -> None:
        op = step.get("op")
        now = clock.monotonic() - self.t0
        disruptive = True
        if op == "partition":
            groups = [self._names(g) for g in step["groups"]]
            self.network.partition(*groups,
                                   one_way=bool(step.get("one_way")))
        elif op == "heal":
            self.network.heal()
        elif op == "link":
            self.network.apply_spec(step["spec"])
            disruptive = "cut" in step["spec"] or "delay" in step["spec"]
        elif op == "arm":
            failures.arm(step["spec"])
        elif op == "disarm":
            failures.disarm(step["site"])
            disruptive = False
        elif op == "crash":
            idx = int(step["node"])
            self.crashed.add(idx)
            await self.nodes[idx].stop()
        elif op == "restore":
            idx = int(step["node"])
            node = await self._rebuild(idx)
            self.crashed.discard(idx)
            await node.start()
            k = max(1, self.scn.out_links)
            for d in range(1, k + 1):
                peer = self.nodes[(idx + d) % len(self.nodes)]
                try:
                    await node.dial(peer, persistent=True)
                except Exception:
                    pass
            disruptive = False
        else:
            raise ValueError(f"unknown scenario op {op!r}")
        if disruptive:
            self.last_disruption_at = now
            self.recovered_at = None
        self.step_log.append({"at": round(now, 3), "op": op})
        self.log.info("scenario step", op=op, at=round(now, 3))

    async def _rebuild(self, idx: int) -> SimNode:
        """Restore a crashed node as a WIPED rejoin: fresh stores and a
        fresh app, same validator key and name.  It re-syncs from
        genesis through the consensus reactor's catch-up gossip — the
        harshest restart shape (a resume-from-stores restart would need
        app-state replay the in-memory kvstore can't provide)."""
        old = self.nodes[idx]
        node = await make_sim_node(idx, self._doc, old.pv, self.network,
                                   tuning=self.scn.tuning,
                                   name=old.name, device=self.device)
        kind = self.scn.byzantine.get(idx)
        if kind:
            adversary.attach(node, kind, self.scn.seed)
        self.nodes[idx] = node
        return node

    # ----------------------------------------------------------- monitor

    def _honest_nodes(self) -> list[SimNode]:
        return [self.nodes[i] for i in self.scn.honest_indices()
                if i not in self.crashed]

    async def run(self) -> dict:
        await self.start()
        # t0 AFTER the net is up: step schedules are relative to a
        # connected mesh, not to however long the dial storm took
        self.t0 = clock.monotonic()
        steps = sorted(self.scn.steps, key=lambda s: float(s.get("at", 0)))
        step_i = 0
        deadline = self.t0 + self.scn.max_virtual_s
        target = self.scn.target_height
        try:
            while True:
                now = clock.monotonic()
                while step_i < len(steps) and \
                        now - self.t0 >= float(steps[step_i].get("at", 0)):
                    await self._apply_step(steps[step_i])
                    step_i += 1
                honest = self._honest_nodes()
                floor = min((n.height() for n in honest), default=0)
                for h in range(1, floor + 1):
                    self.commit_done_at.setdefault(
                        h, round(now - self.t0, 3))
                if self.last_disruption_at is not None and \
                        self.recovered_at is None:
                    done = self.commit_done_at.get(floor)
                    if done is not None and \
                            done > self.last_disruption_at:
                        self.recovered_at = done
                if floor >= target and step_i >= len(steps):
                    break
                if now >= deadline:
                    break
                await clock.sleep(POLL_S)
        finally:
            verdict = self._verdict()
            await self.stop()
        return verdict

    # ----------------------------------------------------------- verdict

    def _verdict(self) -> dict:
        scn = self.scn
        honest = self._honest_nodes()
        common = min((n.height() for n in honest), default=0)
        fork_free = True
        hashes: list[str] = []
        for h in range(1, common + 1):
            blocks = (n.block_store.load_block(h) for n in honest)
            hs = {b.hash() for b in blocks if b is not None}
            if len(hs) != 1:
                fork_free = False
                hashes.append("FORK:" + ",".join(
                    sorted(x.hex()[:16] for x in hs)))
            else:
                hashes.append(hs.pop().hex())
        ev_heights: list[int] = []
        ev_committed = 0
        punished: set[str] = set()
        if honest:
            witness = honest[0]
            for h in range(1, common + 1):
                blk = witness.block_store.load_block(h)
                if blk is not None and blk.evidence:
                    ev_heights.append(h)
                    ev_committed += len(blk.evidence)
                    for ev in blk.evidence:
                        addr = getattr(getattr(ev, "vote_a", None),
                                       "validator_address", None)
                        if addr is not None:
                            for node in self.nodes:
                                if node.pv.get_pub_key().address() == addr:
                                    punished.add(node.name)
        bans_total = 0
        ban_reasons: dict[str, int] = {}
        event_totals: dict[str, int] = {}
        banned_ids: set[str] = set()
        name_by_id = {n.node_key.id: n.name for n in self.nodes}
        for node in honest:
            scorer = node.switch.scorer
            bans_total += scorer.bans_total
            for pid, ban in scorer._bans.items():
                ban_reasons[ban["reason"]] = \
                    ban_reasons.get(ban["reason"], 0) + 1
                banned_ids.add(name_by_id.get(pid, pid[:12]))
            for rec in scorer._peers.values():
                for evname, cnt in rec.events.items():
                    event_totals[evname] = \
                        event_totals.get(evname, 0) + cnt
        mp_tally = {"full_skips": 0, "announced": 0, "ann_dedup": 0,
                    "fetch_requests": 0, "fetch_fulfilled": 0,
                    "fetch_timeouts": 0}
        for node in honest:
            r = node.mempool_reactor
            if r is None:
                continue
            for k in mp_tally:
                mp_tally[k] += r.tallies.get(k, 0)
        # fold the fleet's shared flight-recorder ring into per-phase
        # commit-latency attribution: one sample per (node, height),
        # virtual-time stamps => byte-identical on replay
        from ..libs import timeline, tracing

        waterfalls = timeline.fold(tracing.snapshot(), limit=0)
        tl = timeline.phase_stats(waterfalls)
        ttr = None
        if self.last_disruption_at is not None and \
                self.recovered_at is not None:
            ttr = round(self.recovered_at - self.last_disruption_at, 3)
        virt = round(clock.monotonic() - self.t0, 3)
        runs, forks, vsecs, ttr_g = _sim_metrics()
        runs.inc(scenario=scn.name)
        if not fork_free:
            forks.inc(scenario=scn.name)
        vsecs.inc(virt)
        if ttr is not None:
            ttr_g.set(ttr, scenario=scn.name)
        return {
            "scenario": scn.name,
            "seed": scn.seed,
            "n_nodes": scn.n_nodes,
            "byzantine": {f"sim{i:03d}": k
                          for i, k in sorted(scn.byzantine.items())},
            "target_height": scn.target_height,
            "reached_target": common >= scn.target_height,
            "common_height": common,
            "fork_free": fork_free,
            "block_hashes": hashes,
            "commit_latency_s": [self.commit_done_at.get(h)
                                 for h in range(1, common + 1)],
            "time_to_recover_s": ttr,
            "steps": self.step_log,
            "evidence": {
                "heights_with_evidence": ev_heights,
                "committed_total": ev_committed,
                "byzantine_punished": sorted(punished),
            },
            "bans": {"total": bans_total,
                     "by_reason": dict(sorted(ban_reasons.items())),
                     "banned_nodes": sorted(banned_ids)},
            "misbehavior_events": dict(sorted(event_totals.items())),
            "mempool": mp_tally,
            "chaos": {"signature_len": len(failures.signature()),
                      "sites": {s: v["fired"] for s, v in sorted(
                          failures.stats().get("sites", {}).items())}},
            "timeline": tl,
            "virtual_duration_s": virt,
        }


async def _run_async(scn: Scenario, device) -> dict:
    run = _Run(scn, device)
    try:
        await run.build()
        return await run.run()
    finally:
        run._restore_scheduler()
        failures.reset()


def run_scenario(scn: Scenario, device=None) -> dict:
    """Run one scenario to verdict on a fresh virtual-time loop, its
    checks on ``device``.  Same scenario and seed: the same verdict dict
    and the same fault-plane ``signature()``."""
    _plan.resolve_devices(device)          # raises without a card
    return vtime.run(lambda: _run_async(scn, device), seed=scn.seed)


def chaos_signature_of(scn: Scenario, device=None) -> tuple[dict, list]:
    """Run and also return the fault plane's signature, taken before
    the plane is reset (for replay-identity checks)."""
    _plan.resolve_devices(device)

    async def _main():
        run = _Run(scn, device)
        try:
            await run.build()
            verdict = await run.run()
            return verdict, failures.signature()
        finally:
            run._restore_scheduler()
            failures.reset()

    return vtime.run(_main, seed=scn.seed)


# ------------------------------------------------------- curated scenarios

def curated_suite() -> list[Scenario]:
    """The JAX package's regression suite, one scenario per adversarial
    axis, 12 to 100 nodes (the same dicts)."""
    return [
        Scenario(
            name="partition-heal-25",
            seed=1101, n_nodes=25, out_links=3, target_height=5,
            steps=[
                {"at": 1.0, "op": "partition",
                 "groups": [list(range(8)), list(range(8, 25))]},
                {"at": 4.0, "op": "heal"},
            ]),
        Scenario(
            name="asym-cut-gray-25",
            seed=1102, n_nodes=25, out_links=3, target_height=5,
            link_specs=["link:node=sim003:peer=*:delay=0.15"],
            steps=[
                {"at": 1.0, "op": "partition", "one_way": True,
                 "groups": [list(range(5)), list(range(5, 25))]},
                {"at": 2.0, "op": "arm",
                 "spec": "p2p.send.delay:node=sim007:every=2:delay=0.2"},
                {"at": 4.5, "op": "heal"},
            ]),
        Scenario(
            name="equivocator-25",
            seed=1103, n_nodes=25, out_links=3, target_height=6,
            byzantine={6: "equivocator"}),
        Scenario(
            name="spam-flood-ban-25",
            seed=1104, n_nodes=25, out_links=3, target_height=12,
            max_virtual_s=900.0,
            byzantine={4: "spammer", 17: "flooder"},
            tuning=SimTuning(ban_ttl_s=3.0)),
        Scenario(
            name="txflood-shed-25",
            seed=1107, n_nodes=25, out_links=3, target_height=8,
            max_virtual_s=900.0,
            byzantine={9: "flooder"},
            # a TINY pool: the flood fills it, so honest nodes must
            # SHED (full-pool skips, no CheckTx round trip) while the
            # announce/fetch path and the invalid_tx->ban cycle run
            tuning=SimTuning(ban_ttl_s=3.0, mempool_size=24,
                             mempool_gossip_sleep=0.1)),
        Scenario(
            name="crash-restore-16",
            seed=1105, n_nodes=16, out_links=3, target_height=6,
            steps=[
                {"at": 1.5, "op": "crash", "node": 5},
                {"at": 4.0, "op": "restore", "node": 5},
            ]),
        Scenario(
            # mixed-key lab: half the valset signs BLS (their
            # precommits fold into the commit's aggregate lane block),
            # half Ed25519, under a partition, a crash+wipe restart of a
            # BLS validator, and a BLS equivocator whose duplicate votes
            # must still become committed evidence.  Fork-free +
            # replay-identical is the aggregation-correctness acceptance
            # gate: a domain mix-up between the zero-timestamp fold and
            # the reference encoding would surface here as a fork or a
            # stalled chain, not as a unit-test failure.
            name="bls-mixed-lab-12",
            seed=1108, n_nodes=12, out_links=3, target_height=6,
            max_virtual_s=900.0,
            key_types=["bls12_381" if i % 2 == 0 else "ed25519"
                       for i in range(12)],
            byzantine={4: "equivocator"},     # BLS-keyed equivocator
            steps=[
                {"at": 1.0, "op": "partition",
                 "groups": [list(range(4)), list(range(4, 12))]},
                {"at": 3.0, "op": "heal"},
                {"at": 4.0, "op": "crash", "node": 2},
                {"at": 6.0, "op": "restore", "node": 2},
            ]),
        Scenario(
            name="megamix-100",
            seed=1106, n_nodes=100, out_links=3, target_height=3,
            max_virtual_s=900.0,
            byzantine={23: "equivocator", 61: "amnesiac"},
            link_specs=["link:node=sim011:peer=*:delay=0.1"],
            steps=[
                {"at": 0.5, "op": "partition", "one_way": True,
                 "groups": [list(range(20)), list(range(20, 100))]},
                {"at": 0.8, "op": "arm",
                 "spec": "p2p.send.drop:node=sim041:every=7:max=200"},
                {"at": 1.5, "op": "heal"},
            ]),
    ]
