"""The port's query language (``cometbft_tpu_torch/libs/query.py``) against
the JAX package's on the same inputs: a seeded set of query strings and
event maps goes through both ``Query.parse``; ``str``, the conditions,
``equality_clauses`` and ``matches`` must be equal, and a malformed
string must raise the same ``QuerySyntaxError`` message in both.  Also
the port's event bus with a string, a ``Query`` and an equality dict
subscription over the same messages."""

import asyncio
import datetime as dt

import numpy as np
import pytest

from cometbft_tpu.libs import query as JQ
from cometbft_tpu_torch.libs import pubsub as TP
from cometbft_tpu_torch.libs import query as TQ

KEYS = ("tm.event", "tx.height", "tx.hash", "app.key", "transfer.amount",
        "transfer.to", "account.created", "tx.time", "tx.date", "p.x")
OPS = ("=", "<", "<=", ">", ">=")
STRS = ("NewBlock", "Tx", "bob", "uatom", "it's", "a b", "")
TIMES = ("2023-05-03T14:45:00Z", "2023-05-03T14:45:00.25+02:00",
         "2024-01-01T00:00:00")
DATES = ("2023-05-03", "2024-02-29")
VALUES = ("5", "07", "-3", "0.75", "7atom", "NewBlock", "Tx", "bob",
          "alice", "100uatom", "2023-05-03T15:00:00Z",
          "2023-05-03T00:00:00Z", "2024-02-29T12:00:00Z", "", "it's")
BAD = ("", "AND", "tx.height", "tx.height >", "tx.height > 'x'",
       "a CONTAINS 5", "a = 1 AND", "a = 1 OR b = 2", "a = TIME",
       "a = TIME 2023-13-45T00:00:00Z", "a = DATE 2023-02-30",
       "a = 1 b = 2", "= 5", "a EXISTS AND", "a = 'unterminated",
       "a < TIME x", "5 = a", "a = 1 AND AND b = 2", "a ?= 1")


def _quote(s: str) -> str:
    return "'" + s.replace("\\", "\\\\").replace("'", "\\'") + "'"


def _clause(rng) -> str:
    key = KEYS[rng.integers(len(KEYS))]
    kind = rng.integers(7)
    if kind == 0:
        return f"{key} EXISTS"
    if kind == 1:
        return f"{key} CONTAINS {_quote(STRS[rng.integers(len(STRS))])}"
    if kind == 2:
        return f"{key} = {_quote(STRS[rng.integers(len(STRS))])}"
    op = OPS[rng.integers(len(OPS))]
    if kind == 3:
        return f"{key} {op} TIME {TIMES[rng.integers(len(TIMES))]}"
    if kind == 4:
        return f"{key} {op} DATE {DATES[rng.integers(len(DATES))]}"
    if kind == 5:
        return f"{key} {op} {rng.integers(-10, 20)}"
    return f"{key} {op} {rng.integers(-10, 20) + rng.random():.3f}"


def _queries(seed: int, n: int) -> list[str]:
    rng = np.random.default_rng(seed)
    return [" AND ".join(_clause(rng) for _ in range(rng.integers(1, 5)))
            for _ in range(n)]


def _events(seed: int, n: int) -> list[dict]:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        m = {}
        for key in KEYS:
            if rng.random() < 0.6:
                m[key] = [VALUES[rng.integers(len(VALUES))]
                          for _ in range(rng.integers(1, 3))]
        out.append(m)
    return out


def _conds(q) -> list:
    out = []
    for c in q.conditions:
        arg = c.arg.isoformat() if isinstance(c.arg, dt.datetime) else c.arg
        out.append((c.key, c.op, type(c.arg).__name__, arg, str(c)))
    return out


@pytest.mark.parametrize("seed", range(4))
def test_parse_and_match_equal_jax(seed):
    queries = _queries(seed, 60)
    events = _events(1000 + seed, 40)
    matched = 0
    for s in queries:
        tq, jq = TQ.Query.parse(s), JQ.Query.parse(s)
        assert str(tq) == str(jq) == s
        assert repr(tq) == repr(jq)
        assert _conds(tq) == _conds(jq)
        assert tq.equality_clauses() == jq.equality_clauses()
        got = [tq.matches(e) for e in events]
        assert got == [jq.matches(e) for e in events], s
        matched += sum(got)
        for c_t, c_j in zip(tq.conditions, jq.conditions):
            for e in events[:10]:
                vals = e.get(c_t.key)
                assert c_t.matches(vals) == c_j.matches(vals)
    assert matched > 0


def test_syntax_errors_equal_jax():
    for s in BAD:
        with pytest.raises(JQ.QuerySyntaxError) as je:
            JQ.Query.parse(s)
        with pytest.raises(TQ.QuerySyntaxError) as te:
            TQ.Query.parse(s)
        assert str(te.value) == str(je.value), s
        assert isinstance(te.value, ValueError)


def test_query_built_from_conditions_prints_like_jax():
    conds = [("tm.event", "=", "Tx"), ("tx.height", ">=", 5),
             ("app.key", "contains", "k"), ("account.created", "exists",
                                            None),
             ("tx.time", "<", dt.datetime(2023, 5, 3, 14, 45,
                                          tzinfo=dt.timezone.utc))]
    tq = TQ.Query([TQ.Condition(*c) for c in conds])
    jq = JQ.Query([JQ.Condition(*c) for c in conds])
    assert str(tq) == str(jq)
    assert str(TQ.Query.parse(str(tq))) == str(tq)


def test_event_bus_takes_strings_queries_and_dicts():
    async def main():
        bus = TP.EventBus()
        s = bus.subscribe("s", "tm.event='Tx' AND tx.height > 5")
        q = bus.subscribe("q", TQ.Query.parse("app.key CONTAINS 'k'"))
        d = bus.subscribe("d", {"tm.event": "Tx", "tx.height": "7"})
        nb = bus.subscribe("nb", {"tm.event": "NewBlock"})
        bus.publish("Tx", 1, {"tx.height": "7", "app.key": "kk"})
        bus.publish("Tx", 2, {"tx.height": "3", "app.key": "x"})
        bus.publish("NewBlock", 3, {"block.height": "7"})
        got = {name: [] for name in ("s", "q", "d", "nb")}
        for name, sub in (("s", s), ("q", q), ("d", d), ("nb", nb)):
            while not sub.queue.empty():
                got[name].append(sub.queue.get_nowait().data)
        assert got == {"s": [1], "q": [1], "d": [1], "nb": [3]}
        with pytest.raises(TQ.QuerySyntaxError):
            bus.subscribe("bad", "tm.event =")
        with pytest.raises(TypeError):
            bus.subscribe("bad", 5)
        bus.unsubscribe("s")
        assert bus.num_subscribers() == 3

    asyncio.run(main())
