"""The port's height timeline (``cometbft_tpu_torch/libs/timeline.py``)
against the JAX package's, on the CPU: the cases of
``tests/test_timeline.py``, each ring of records folded by both packages
and compared exactly (waterfalls, marks, buckets, filters, per-node
limits, phase statistics), seeded random rings of the same shapes, and
the port's own flight recorder from an in-process network: every
consensus record carries node and height, and the port's
``/consensus_timeline`` answers the JAX package's fold of that ring."""

import asyncio
import random

import pytest
import torch

from cometbft_tpu.libs import timeline as jtl
from cometbft_tpu_torch.libs import timeline as ttl
from cometbft_tpu_torch.libs import tracing as ttr

pytestmark = pytest.mark.timeout(150)

torch.set_num_threads(1)

S = 1_000_000_000
WALL = 1_800_000_000 * S
_ids = iter(range(1, 1 << 20))


def ev(sub, name, t, **attrs):
    return ("event", next(_ids), 0, sub, name, WALL + t, t, t, attrs)


def sp(sub, name, t0, t1, **attrs):
    return ("span", next(_ids), 0, sub, name, WALL + t0, t0, t1, attrs)


def height_records(node="n0", h=5, t0=0, round_=0):
    a = dict(node=node, height=h)
    return [
        sp("consensus", "step", t0, t0 + 1 * S, step="NewHeight",
           round=round_, **a),
        ev("consensus", "proposal_received", t0 + 1 * S, round=round_, **a),
        sp("consensus", "step", t0 + 1 * S, t0 + 3 * S, step="Propose",
           round=round_, **a),
        ev("consensus", "block_assembled", t0 + 2 * S, **a),
        sp("consensus", "step", t0 + 3 * S, t0 + 4 * S, step="Precommit",
           round=round_, **a),
        sp("consensus", "step", t0 + 4 * S, t0 + 5 * S, step="Commit",
           round=round_, **a),
        ev("consensus", "commit", t0 + 5 * S, round=round_, **a),
    ]


def _interleaved():
    quads = [height_records("a", 5, 0), height_records("b", 5, S // 2),
             height_records("a", 6, 6 * S), height_records("b", 6, 7 * S)]
    return [q[i] for i in range(7) for q in quads]


def _buckets():
    recs = height_records()
    recs += [sp("abci", "call", 4 * S, int(4.5 * S),
                method="finalize_block", height=5, node="n0"),
             ev("wal", "fsync", int(4.6 * S), height=5, dur_us=100_000),
             sp("crypto.sched", "dispatch", 3 * S, int(3.25 * S), h_lo=4,
                h_hi=6, n=64),
             sp("crypto.agg", "verify", int(3.5 * S), int(3.6 * S),
                height=5, lanes=7, ok=True),
             sp("abci", "call", 2 * S, int(2.2 * S), method="check_tx",
                height=5)]
    return recs


def _multi_round():
    a = dict(node="n0", height=9)
    return [
        sp("consensus", "step", 0, 1 * S, step="NewHeight", round=0, **a),
        ev("consensus", "proposal_received", 1 * S, round=0, **a),
        ev("consensus", "block_assembled", 2 * S, **a),
        sp("consensus", "step", 3 * S, 4 * S, step="Precommit", round=0,
           **a),
        sp("consensus", "step", 5 * S, 6 * S, step="NewRound", round=1,
           **a),
        sp("consensus", "step", 7 * S, 8 * S, step="Precommit", round=1,
           **a),
        sp("consensus", "step", 8 * S, 9 * S, step="Commit", round=1, **a),
        ev("consensus", "commit", 9 * S, round=1, **a)]


def _catchup():
    a = dict(node="n3", height=12)
    return [
        sp("consensus", "step", 0, 1 * S, step="NewHeight", round=0, **a),
        ev("consensus", "proposal_received", 1 * S, round=0, **a),
        ev("consensus", "block_assembled", 2 * S, **a),
        ev("consensus", "commit", 3 * S, round=0, catchup=True, **a)]


def _evicted_and_inflight():
    a, b = dict(node="n0", height=7), dict(node="n0", height=8)
    return [
        sp("consensus", "step", 10 * S, 11 * S, step="Precommit", round=0,
           **a),
        sp("consensus", "step", 11 * S, 12 * S, step="Commit", round=0,
           **a),
        ev("consensus", "commit", 12 * S, round=0, **a),
        sp("consensus", "step", 20 * S, 21 * S, step="NewHeight", round=0,
           **b),
        ev("consensus", "proposal_received", 21 * S, round=0, **b)]


def _violations():
    return height_records() + [
        ev("consensus", "commit", 99 * S, height=77),
        ev("consensus", "commit", 99 * S, node="x"),
        sp("abci", "call", 0, S, method="echo"),
        sp("crypto.sched", "dispatch", 0, S, h_lo=0, h_hi=0),
        ev("wal", "fsync", int(4.5 * S), height=5, dur_us=3_600_000_000)]


def _many():
    recs = []
    for i in range(10):
        recs += height_records("n0", 10 + i, i * 10 * S)
    recs.append(sp("consensus", "step", 200 * S, 201 * S, step="NewHeight",
                   round=0, node="n0", height=99))
    return recs


CASES = {"basic": height_records, "buckets": _buckets,
         "multi_round": _multi_round, "catchup": _catchup,
         "evicted_inflight": _evicted_and_inflight,
         "interleaved": _interleaved, "violations": _violations,
         "many": _many}
QUERIES = [{}, {"node": "a"}, {"node": "n0"}, {"height": 6},
           {"height": 5}, {"limit": 1}, {"limit": 0}, {"limit": 3}]


def _fold_both(recs):
    for q in QUERIES:
        got = ttl.fold(recs, **q)
        assert got == jtl.fold(recs, **q), q
        assert ttl.phase_stats(got) == jtl.phase_stats(got)
    return ttl.fold(recs, limit=0)


@pytest.mark.parametrize("case", sorted(CASES))
def test_fold_matches_jax(case):
    wfs = _fold_both(CASES[case]())
    for wf in wfs:
        assert sum(wf["buckets"].values()) == pytest.approx(wf["total_s"])
    if case == "basic":
        assert wfs[0]["total_s"] == 5.0 and wfs[0]["complete"]
        assert [p["phase"] for p in wfs[0]["phases"]] == list(ttl.PHASES)
    if case == "buckets":
        assert wfs[0]["buckets"]["verify"] == pytest.approx(0.35)
    if case == "multi_round":
        assert wfs[0]["marks"]["prevote_23"] == 7.0
    if case == "many":
        st = ttl.phase_stats(wfs)
        assert st["samples"] == 10
        assert st["phases"]["total"] == {"n": 10, "p50_s": 5.0,
                                         "p99_s": 5.0}


@pytest.mark.parametrize("seed", range(6))
def test_random_rings_match_jax(seed):
    """Shuffled, truncated and mixed rings of the cases' shapes with
    jittered times: both folds agree record for record."""
    rng = random.Random(seed)
    recs = []
    for k in range(rng.randrange(3, 9)):
        node = rng.choice(["a", "b", "n0", "n3"])
        h = rng.randrange(1, 12)
        t0 = rng.randrange(0, 50) * S + rng.randrange(S)
        for r in height_records(node, h, t0, rng.randrange(2)):
            if rng.random() < 0.85:
                recs.append(r)
        if rng.random() < 0.5:
            a, b = sorted(rng.randrange(t0, t0 + 6 * S) for _ in range(2))
            recs.append(sp("abci", "call", a, b, method="finalize_block",
                           height=h, **({"node": node}
                                        if rng.random() < 0.5 else {})))
        if rng.random() < 0.5:
            recs.append(ev("wal", "fsync", t0 + rng.randrange(6 * S),
                           height=h, dur_us=rng.randrange(10**6)))
        if rng.random() < 0.5:
            a = t0 + rng.randrange(5 * S)
            recs.append(sp("crypto.sched", "dispatch", a,
                           a + rng.randrange(S), h_lo=max(1, h - 1),
                           h_hi=h + rng.randrange(2), n=4))
    rng.shuffle(recs)
    _fold_both(recs)


def test_live_port_ring_attr_contract_and_route():
    """A 2-validator in-process port network with tracing on: every
    consensus record stamps node and height, step spans stamp round and
    step, and ``/consensus_timeline`` is the JAX package's fold of the
    same ring."""
    from cometbft_tpu_torch.rpc import core as rpc_core
    from cometbft_tpu_torch.testing import make_inproc_network

    async def main():
        ttr.configure(enabled=True, ring_size=32768)
        ttr.clear()
        net = await make_inproc_network(2, device="cpu")
        try:
            await net.start()
            await net.wait_for_height(2, timeout=100)
        finally:
            await net.stop()
        recs = ttr.snapshot()
        out = await rpc_core.consensus_timeline(None, height=0, n=4)
        h2 = await rpc_core.consensus_timeline(None, height=2)
        return recs, out, h2

    loop = asyncio.new_event_loop()
    try:
        recs, out, h2 = loop.run_until_complete(main())
    finally:
        loop.close()
        ttr.configure(enabled=False, ring_size=8192)
        ttr.clear()
    cons = [r for r in recs if r[3] == "consensus"]
    assert cons
    for r in cons:
        assert r[8].get("node") is not None and \
            r[8].get("height") is not None, r
        if r[4] == "step":
            assert "round" in r[8] and "step" in r[8], r
    done = [w for w in _fold_both(recs) if w["complete"]]
    assert len(done) >= 4
    assert out["enabled"] is True
    assert out["phases"] == list(jtl.PHASES)
    assert out["buckets"] == list(jtl.BUCKETS)
    assert out["waterfalls"] == jtl.fold(recs, limit=4)
    assert {w["height"] for w in h2["waterfalls"]} == {2}


def test_span_context_manager_like_the_jax_package():
    """``tracing.span`` in both packages: a no-op when disabled, and
    nested spans and events record the same kinds, names, attrs and
    parent links."""
    from cometbft_tpu.libs import tracing as jtr

    def run(tr):
        was = tr.is_enabled()
        tr.clear()
        try:
            tr.configure(enabled=False)
            with tr.span("crypto", "off") as o:
                assert o is None
            assert tr.snapshot() == []
            tr.configure(enabled=True)
            with tr.span("consensus", "outer", height=3):
                with tr.span("crypto.agg", "verify", lanes=7):
                    tr.event("wal", "fsync", height=3)
            recs = tr.snapshot()
        finally:
            tr.configure(enabled=was)
            tr.clear()
        ids = {r[1]: i for i, r in enumerate(recs)}
        return [(r[0], r[3], r[4], r[8], ids.get(r[2])) for r in recs]

    got = run(ttr)
    assert got == run(jtr)
    assert [g[2] for g in got] == ["fsync", "verify", "outer"]
    assert got[0][4] == 1 and got[1][4] == 2 and got[2][4] is None

