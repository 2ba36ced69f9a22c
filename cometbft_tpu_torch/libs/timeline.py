"""Height-timeline attribution (counterpart of
``cometbft_tpu/libs/timeline.py``): fold the flight-recorder ring
(``libs/tracing``) into per-height commit-latency **waterfalls**.

The ring answers "what happened"; this module answers "where did height
H's latency go, on which node".  A waterfall is one (node, height) pair
broken into the ordered consensus phases

    propose -> gossip -> prevote -> precommit -> commit

bounded by the emitter marks every commit-path subsystem stamps
(``proposal_received``, ``block_assembled``, the step-span transitions
into PRECOMMIT / COMMIT, the ``commit`` event), plus residual-time
**buckets** (``gossip_wait``, ``verify``, ``app``, ``wal``, ``idle``)
that decompose the same total exactly — buckets are clipped against the
remaining budget in a fixed order, so their sum always equals the
measured commit latency and never exceeds it.

Correlation rules by subsystem:

- ``consensus`` records REQUIRE ``node`` + ``height`` attrs (the attr
  contract pinned by ``tests/test_timeline.py``) and key the waterfall.
- ``abci`` call spans join on ``height`` (+ ``node`` when stamped — the
  sim lab shares one process ring across the fleet).
- ``wal`` fsync events join on ``height``.
- ``crypto.sched`` dispatch spans join on their ``h_lo``..``h_hi``
  window (a micro-batch mixes heights) and are clipped to the
  waterfall's interval: verification is a shared resource, so its time
  is attributed to every height it overlapped.
- ``crypto.agg`` verify spans (the BLS aggregate-commit pairing check)
  join on ``height`` and feed the same ``verify`` bucket.

Everything here is pure computation over a snapshot: no clocks are
read, so folding the virtual-time ring of a scenario-lab run yields
waterfalls that are a pure function of the scenario seed (the replay
contract ``bench.py --mode scenarios`` asserts on the ``timeline``
verdict field).
"""

from __future__ import annotations

import math

# waterfall phase taxonomy, in commit order.  Each phase starts at its
# mark and runs to the next present mark (the last runs to the commit):
#   propose    height start -> proposal received (includes commit-wait)
#   gossip     proposal received -> block parts complete
#   prevote    parts complete -> +2/3 prevotes (PRECOMMIT step entered)
#   precommit  +2/3 prevotes -> +2/3 precommits (COMMIT step entered)
#   commit     +2/3 precommits -> block applied (save/WAL/app inside)
PHASES = ("propose", "gossip", "prevote", "precommit", "commit")

# residual buckets, in clipping order (see fold()); "idle" takes the
# remainder, so the five always sum to the waterfall's total
BUCKETS = ("gossip_wait", "verify", "app", "wal", "idle")


def _r(ns: int) -> float:
    """ns -> seconds, rounded for a stable JSON surface."""
    return round(ns / 1e9, 6)


class _Acc:
    """Per-(node, height) accumulator while scanning the ring."""

    __slots__ = ("steps", "proposal_rx", "parts_done", "commit_t",
                 "commit_round", "catchup", "abci", "fsyncs", "wall0",
                 "t_min", "t_max")

    def __init__(self):
        self.steps = []          # (round, step, t0, t1)
        self.proposal_rx = None  # latest proposal_received event ns
        self.parts_done = None   # latest block_assembled event ns
        self.commit_t = None     # commit event ns
        self.commit_round = None
        self.catchup = False
        self.abci = []           # (method, t0, t1)
        self.fsyncs = []         # (t, dur_ns)
        self.wall0 = None        # wall ns of the earliest record
        self.t_min = None
        self.t_max = None

    def note(self, wall0: int, t0: int, t1: int) -> None:
        if self.t_min is None or t0 < self.t_min:
            self.t_min = t0
            self.wall0 = wall0
        if self.t_max is None or t1 > self.t_max:
            self.t_max = t1


def fold(records, *, node: str | None = None, height: int | None = None,
         limit: int = 8) -> list[dict]:
    """Fold raw ring tuples (``tracing.snapshot()``) into waterfalls,
    newest heights first, at most ``limit`` per node (``limit <= 0``:
    all).  ``node``/``height`` filter the output."""
    accs: dict[tuple, _Acc] = {}
    shared_abci = []     # abci spans with no node attr: join on height
    fsyncs = []          # (height, t, dur_ns)
    dispatches = []      # (h_lo, h_hi, t0, t1)

    for kind, _rid, _par, sub, name, wall0, t0, t1, attrs in records:
        if sub == "consensus":
            n, h = attrs.get("node"), attrs.get("height")
            if n is None or h is None:
                continue             # attr contract violated: skip
            if node is not None and n != node:
                continue
            if height is not None and h != height:
                continue
            acc = accs.get((n, h))
            if acc is None:
                acc = accs[(n, h)] = _Acc()
            acc.note(wall0, t0, t1)
            if name == "step":
                acc.steps.append((attrs.get("round", 0),
                                  attrs.get("step", ""), t0, t1))
            elif name == "proposal_received":
                acc.proposal_rx = t0
            elif name == "block_assembled":
                acc.parts_done = t0
            elif name == "commit":
                acc.commit_t = t0
                acc.commit_round = attrs.get("round", 0)
                acc.catchup = bool(attrs.get("catchup"))
        elif sub == "abci" and name == "call":
            h = attrs.get("height")
            if h is None:
                continue
            n = attrs.get("node")
            item = (attrs.get("method", ""), t0, t1)
            if n is None:
                shared_abci.append((h, item))
            else:
                acc = accs.get((n, h))
                if acc is not None:
                    acc.abci.append(item)
                else:
                    shared_abci.append((h, item))
        elif sub == "wal" and name == "fsync":
            h = attrs.get("height")
            if h is not None:
                fsyncs.append((h, t0, int(attrs.get("dur_us", 0)) * 1000))
        elif sub == "crypto.sched" and name == "dispatch":
            lo, hi = attrs.get("h_lo"), attrs.get("h_hi")
            if lo:
                dispatches.append((lo, hi or lo, t0, t1))
        elif sub == "crypto.agg" and name == "verify":
            # BLS aggregate-commit pairing check: a single-height window
            h = attrs.get("height")
            if h:
                dispatches.append((h, h, t0, t1))

    for h, item in shared_abci:
        for (n, hh), acc in accs.items():
            if hh == h:
                acc.abci.append(item)
    for h, t, dur in fsyncs:
        for (n, hh), acc in accs.items():
            if hh == h:
                acc.fsyncs.append((t, dur))

    out = []
    per_node: dict[str, int] = {}
    for (n, h) in sorted(accs, key=lambda k: (-k[1], k[0])):
        if limit and limit > 0:
            if per_node.get(n, 0) >= limit:
                continue
            per_node[n] = per_node.get(n, 0) + 1
        out.append(_waterfall(n, h, accs[(n, h)], dispatches))
    out.sort(key=lambda w: (w["height"], w["node"]))
    return out


def _waterfall(node: str, height: int, acc: _Acc, dispatches) -> dict:
    t0h = min((t0 for _r_, s, t0, _t1 in acc.steps if s == "NewHeight"),
              default=acc.t_min)
    end = acc.commit_t if acc.commit_t is not None else acc.t_max
    complete = acc.commit_t is not None
    cr = acc.commit_round

    def _step_start(step_name: str):
        cands = [(r, t0) for r, s, t0, _ in acc.steps if s == step_name]
        if not cands:
            return None
        if cr is not None:
            exact = [t0 for r, t0 in cands if r == cr]
            if exact:
                return min(exact)
        return max(t0 for _, t0 in cands)      # latest round's entry

    finalize = None
    app_ns = 0
    for method, a0, a1 in acc.abci:
        app_ns += max(0, min(a1, end) - max(a0, t0h))
        if method == "finalize_block":
            finalize = a1 if finalize is None else max(finalize, a1)
    wal_ns = sum(d for t, d in acc.fsyncs if t0h <= t <= end)
    fsync_mark = max((t for t, _ in acc.fsyncs if t0h <= t <= end),
                     default=None)
    verify_ns = 0
    for lo, hi, d0, d1 in dispatches:
        if lo <= height <= hi:
            verify_ns += max(0, min(d1, end) - max(d0, t0h))

    marks_abs = {
        "proposal_received": acc.proposal_rx,
        "parts_complete": acc.parts_done,
        "prevote_23": _step_start("Precommit"),
        "precommit_23": _step_start("Commit"),
        "commit": acc.commit_t,
        "finalize": finalize,
        "fsync": fsync_mark,
    }

    # phase boundaries: drop absent marks (evicted ring records, or a
    # catch-up commit that never saw vote phases); clamp to monotonic
    bounds = [("propose", t0h)]
    for phase, mark in (("gossip", acc.proposal_rx),
                        ("prevote", acc.parts_done),
                        ("precommit", marks_abs["prevote_23"]),
                        ("commit", marks_abs["precommit_23"])):
        if mark is not None:
            bounds.append((phase, max(mark, bounds[-1][1])))
    phases = []
    for i, (phase, t) in enumerate(bounds):
        nxt = bounds[i + 1][1] if i + 1 < len(bounds) else max(end, t)
        phases.append({"phase": phase,
                       "start_s": _r(t - t0h),
                       "dur_s": _r(max(0, min(nxt, end) - t))})

    total_ns = max(0, end - t0h)
    gossip_ns = 0
    if acc.proposal_rx is not None and acc.parts_done is not None:
        gossip_ns = max(0, acc.parts_done - acc.proposal_rx)
    # decompose total exactly: clip each bucket to the remaining budget
    rem = total_ns
    buckets = {}
    for name_, val in (("gossip_wait", gossip_ns), ("verify", verify_ns),
                       ("app", app_ns), ("wal", wal_ns)):
        val = min(max(0, val), rem)
        buckets[name_] = _r(val)
        rem -= val
    # idle takes the remainder in ROUNDED space, so the five rounded
    # values sum to the rounded total exactly
    buckets["idle"] = max(0.0, round(
        _r(total_ns) - sum(buckets.values()), 6))

    return {
        "node": node,
        "height": height,
        "rounds": max((r for r, *_ in acc.steps), default=cr or 0),
        "complete": complete,
        "catchup": acc.catchup,
        "wall0_ns": acc.wall0,
        "total_s": _r(total_ns),
        "phases": phases,
        "marks": {k: (_r(v - t0h) if v is not None else None)
                  for k, v in marks_abs.items()},
        "buckets": buckets,
    }


def _pctl(xs: list[float], q: float) -> float:
    """Nearest-rank percentile over a sorted list (deterministic — no
    interpolation, so verdict JSON is stable across platforms)."""
    i = max(0, math.ceil(q * len(xs)) - 1)
    return xs[min(i, len(xs) - 1)]


def phase_stats(waterfalls: list[dict]) -> dict:
    """Aggregate completed waterfalls into per-phase p50/p99 — the
    scenario-lab verdict surface (one sample per (node, height))."""
    samples: dict[str, list[float]] = {p: [] for p in PHASES}
    samples["total"] = []
    bsamples: dict[str, list[float]] = {b: [] for b in BUCKETS}
    n = 0
    for wf in waterfalls:
        if not wf.get("complete"):
            continue
        n += 1
        samples["total"].append(wf["total_s"])
        for seg in wf["phases"]:
            samples[seg["phase"]].append(seg["dur_s"])
        for b in BUCKETS:
            bsamples[b].append(wf["buckets"][b])
    def _stats(xs):
        xs = sorted(xs)
        return {"n": len(xs),
                "p50_s": _pctl(xs, 0.50) if xs else None,
                "p99_s": _pctl(xs, 0.99) if xs else None}
    return {
        "samples": n,
        "phases": {k: _stats(v) for k, v in samples.items()},
        "buckets": {k: _stats(v) for k, v in bsamples.items()},
    }
