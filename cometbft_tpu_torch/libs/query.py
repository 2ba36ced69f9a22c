"""Event query language (counterpart of ``cometbft_tpu/libs/query.py``;
reference: ``libs/pubsub/query/query.go`` and the grammar of
``libs/pubsub/query/syntax/``).

Strings such as::

    tm.event = 'Tx' AND tx.height > 5 AND transfer.amount CONTAINS 'uatom'
    tm.event = 'NewBlock' AND block.height <= 100
    account.created EXISTS
    tx.time >= TIME 2023-05-03T14:45:00Z
    tx.date = DATE 2023-05-03

compile into a conjunction of conditions evaluated against an event
attribute map ``composite key -> list of string values``:

- conditions are AND-joined (the grammar has no OR and no parentheses);
- operators: ``=  <  <=  >  >=  CONTAINS  EXISTS``;
- operands: single-quoted strings, numbers (int or float, signed),
  ``TIME <RFC3339>`` and ``DATE <YYYY-MM-DD>``;
- a condition holds when ANY value of its key matches (``query.go``
  matchEventValues): numeric conditions parse each value as a number and
  skip those that do not parse; CONTAINS is a substring test; EXISTS
  tests the key's presence.
"""

from __future__ import annotations

import datetime as _dt
import re
from dataclasses import dataclass

__all__ = ["Query", "Condition", "QuerySyntaxError"]


class QuerySyntaxError(ValueError):
    pass


# operator tokens, longest-first so "<=" wins over "<"
_OPS = ("<=", ">=", "=", "<", ">")

_TOKEN_RE = re.compile(
    r"""\s*(?:
        (?P<op><=|>=|=|<|>)
      | (?P<str>'(?:[^'\\]|\\.)*')
      | (?P<time>\d{4}-\d{2}-\d{2}
            (?:T\d{2}:\d{2}:\d{2}(?:\.\d+)?(?:Z|[+-]\d{2}:\d{2})?)?)
      | (?P<num>-?\d+(?:\.\d+)?)
      | (?P<word>[A-Za-z_][A-Za-z0-9_.\-]*)
    )""",
    re.VERBOSE,
)

_KEYWORDS = {"AND", "CONTAINS", "EXISTS", "TIME", "DATE"}


def _tokenize(s: str) -> list[tuple[str, str]]:
    toks, pos = [], 0
    while pos < len(s):
        m = _TOKEN_RE.match(s, pos)
        if not m or m.end() == pos:
            rest = s[pos:].strip()
            if not rest:
                break
            raise QuerySyntaxError(f"unexpected input at {rest[:20]!r}")
        pos = m.end()
        if m.group("op"):
            toks.append(("op", m.group("op")))
        elif m.group("str"):
            raw = m.group("str")[1:-1]
            toks.append(("str", raw.replace("\\'", "'").replace("\\\\", "\\")))
        elif m.group("time"):
            toks.append(("time", m.group("time")))
        elif m.group("num"):
            toks.append(("num", m.group("num")))
        else:
            w = m.group("word")
            toks.append(("kw", w) if w.upper() in _KEYWORDS and w.isupper()
                        else ("key", w))
    return toks


def _parse_time(v: str) -> _dt.datetime:
    try:
        t = _dt.datetime.fromisoformat(v.replace("Z", "+00:00"))
    except ValueError as e:
        raise QuerySyntaxError(f"bad TIME operand {v!r}") from e
    if t.tzinfo is None:
        t = t.replace(tzinfo=_dt.timezone.utc)
    return t


def _parse_date(v: str) -> _dt.datetime:
    try:
        d = _dt.date.fromisoformat(v)
    except ValueError as e:
        raise QuerySyntaxError(f"bad DATE operand {v!r}") from e
    return _dt.datetime(d.year, d.month, d.day, tzinfo=_dt.timezone.utc)


@dataclass(frozen=True)
class Condition:
    """One ``key op operand`` clause.  ``op`` is one of
    ``= < <= > >= contains exists``; ``arg`` is ``str`` (string equality /
    CONTAINS), ``int | float`` (numeric), ``datetime`` (TIME/DATE), or
    ``None`` (EXISTS)."""

    key: str
    op: str
    arg: object = None

    # -- evaluation ------------------------------------------------------

    def matches(self, values: list[str] | None) -> bool:
        if self.op == "exists":
            return values is not None
        if not values:
            return False
        if self.op == "contains":
            return any(self.arg in v for v in values)
        if isinstance(self.arg, str):
            # string operand: only "=" reaches here (grammar restriction)
            return any(v == self.arg for v in values)
        if isinstance(self.arg, _dt.datetime):
            cast = _try_time
        else:
            cast = _try_number
        for v in values:
            got = cast(v)
            if got is None:
                continue
            if self.op == "=" and got == self.arg:
                return True
            if self.op == "<" and got < self.arg:
                return True
            if self.op == "<=" and got <= self.arg:
                return True
            if self.op == ">" and got > self.arg:
                return True
            if self.op == ">=" and got >= self.arg:
                return True
        return False

    def __str__(self) -> str:
        if self.op == "exists":
            return f"{self.key} EXISTS"
        if self.op == "contains":
            return f"{self.key} CONTAINS '{self.arg}'"
        if isinstance(self.arg, _dt.datetime):
            return f"{self.key} {self.op} TIME {self.arg.isoformat()}"
        if isinstance(self.arg, str):
            return f"{self.key} {self.op} '{self.arg}'"
        return f"{self.key} {self.op} {self.arg}"


def _try_number(v: str):
    try:
        return int(v)
    except ValueError:
        try:
            return float(v)
        except ValueError:
            return None  # "5atom" is not a number; the condition skips it


def _try_time(v: str):
    try:
        return _parse_time(v)
    except QuerySyntaxError:
        return None


class Query:
    """A compiled conjunction of :class:`Condition`."""

    def __init__(self, conditions: list[Condition], source: str = ""):
        self.conditions = conditions
        self._source = source or " AND ".join(str(c) for c in conditions)

    # -- parsing ---------------------------------------------------------

    @classmethod
    def parse(cls, s: str) -> "Query":
        toks = _tokenize(s)
        conds: list[Condition] = []
        i = 0
        while i < len(toks):
            kind, val = toks[i]
            if kind != "key":
                raise QuerySyntaxError(f"expected event key, got {val!r}")
            key = val
            i += 1
            if i >= len(toks):
                raise QuerySyntaxError(f"dangling key {key!r}")
            kind, val = toks[i]
            if kind == "kw" and val == "EXISTS":
                conds.append(Condition(key, "exists"))
                i += 1
            elif kind == "kw" and val == "CONTAINS":
                i += 1
                if i >= len(toks) or toks[i][0] != "str":
                    raise QuerySyntaxError("CONTAINS needs a string operand")
                conds.append(Condition(key, "contains", toks[i][1]))
                i += 1
            elif kind == "op":
                op = val
                i += 1
                if i >= len(toks):
                    raise QuerySyntaxError(f"missing operand after {op}")
                tkind, tval = toks[i]
                if tkind == "str":
                    if op != "=":
                        raise QuerySyntaxError(
                            f"operator {op} needs a numeric or time operand")
                    conds.append(Condition(key, op, tval))
                elif tkind == "num":
                    n = float(tval) if "." in tval else int(tval)
                    conds.append(Condition(key, op, n))
                elif tkind == "kw" and tval in ("TIME", "DATE"):
                    i += 1
                    if i >= len(toks) or toks[i][0] != "time":
                        raise QuerySyntaxError(f"missing {tval} value")
                    lit = toks[i][1]
                    arg = (_parse_time(lit) if tval == "TIME"
                           else _parse_date(lit))
                    conds.append(Condition(key, op, arg))
                else:
                    raise QuerySyntaxError(f"bad operand {tval!r}")
                i += 1
            else:
                raise QuerySyntaxError(
                    f"expected operator after {key!r}, got {val!r}")
            if i < len(toks):
                kind, val = toks[i]
                if not (kind == "kw" and val == "AND"):
                    raise QuerySyntaxError(f"expected AND, got {val!r}")
                i += 1
                if i >= len(toks):
                    raise QuerySyntaxError("dangling AND")
        if not conds:
            raise QuerySyntaxError("empty query")
        return cls(conds, s)

    # -- evaluation ------------------------------------------------------

    def matches(self, events: dict[str, list[str]]) -> bool:
        return all(c.matches(events.get(c.key)) for c in self.conditions)

    def equality_clauses(self) -> dict[str, str]:
        """The ``key -> value`` map of plain string-equality conditions —
        what posting-list indexes can answer directly; the rest of the
        query post-filters."""
        return {c.key: c.arg for c in self.conditions
                if c.op == "=" and isinstance(c.arg, str)}

    def __str__(self) -> str:
        return self._source

    def __repr__(self) -> str:
        return f"Query({self._source!r})"
