"""Deterministic node-wide fault-injection plane (counterpart of
``cometbft_tpu/libs/failures.py``, without its config-file and
environment wiring, which belong to the node).

- **Named sites.**  Each injection point is a named site
  (``wal.fsync.eio``, ``wal.write.torn``, ``sched.dispatch.raise``); a
  site is one :func:`fire` call, which returns ``None`` (no fault this
  time) or the armed rule's parameter dict (inject now).
- **Seeded, deterministic schedules.**  Every site is gated by a
  :class:`FaultRule` parsed from a spec string
  (``"site:key=value:key=value"``).  Index triggers (``at=N``,
  ``count=N``, ``every=K``, offset ``after=N``, bound ``max=M``) depend
  only on the site's own call counter; ``prob=P`` draws from a per-site
  ``random.Random`` seeded from ``"{seed}:{site}"``.
- **Bounded event log.**  Every fired fault appends one dict to a
  ``deque(maxlen=N)``, read by :func:`events`.
- **Zero overhead when disabled**: a module flag and a
  first-instruction return from :func:`fire`.

Arm it with :func:`configure` (``faults=["wal.fsync.eio:at=40"]``);
:func:`reset` disarms everything.
"""

from __future__ import annotations

import functools
import random
import threading
from collections import deque


_ENABLED = False
_PLANE: "ChaosPlane | None" = None
_CONF_LOCK = threading.Lock()

# rule keys with non-float values, everything else in a spec parses as
# float (``prob=0.02``) with int-preservation (``at=40`` stays an int).
# "peer" is the scenario lab's link-spec far end (sim/transport
# apply_spec) — a plain param here, never a selector.
_STR_KEYS = ("cut", "chan", "mode", "node", "file", "peer")
# str params that act as SELECTORS when present on a rule: the site
# only counts/fires calls whose `detail` carries the same value, so
# "p2p.send.corrupt:node=bad0:every=3" arms ONE node's links in an
# in-proc ensemble, "chan=vote" one channel's packets, and
# "db.replay.corrupt:file=blockstore.db" one store's log among the
# several LogDB files a node opens.  Calls that don't match don't
# advance the call index — the schedule is a pure function of the
# MATCHING stream.
_SELECTOR_KEYS = ("chan", "node", "file")


class FaultSpecError(ValueError):
    """A fault spec string that cannot parse — raised at configure time
    (config load / node start), never from a hot-path ``fire`` call."""


@functools.cache
def _chaos_metrics():
    from . import metrics as m

    return m.counter("chaos_faults_fired_total",
                     "fault-plane injections, by site")


class FaultRule:
    """One armed site: trigger bookkeeping + pass-through params.

    Trigger precedence when several are given: ``at`` wins, then
    ``count``, then ``every``, then ``prob``.  ``after=N`` offsets any
    of them by N calls; ``max=M`` bounds total fires.
    """

    __slots__ = ("site", "at", "count", "every", "prob", "after",
                 "max_fires", "params", "selectors", "calls", "fired")

    def __init__(self, site: str, at=None, count=None, every=None,
                 prob=None, after=0, max_fires=None, params=None):
        self.site = site
        self.at = set(at) if at else None
        self.count = count
        self.every = every
        self.prob = prob
        self.after = int(after)
        self.max_fires = max_fires
        self.params = params or {}
        self.selectors = {k: v for k, v in self.params.items()
                          if k in _SELECTOR_KEYS}
        self.calls = 0              # per-site call index (1-based)
        self.fired = 0

    def decide(self, rng: random.Random) -> bool:
        """One site call: advance the counter, return fire/no-fire.
        The probabilistic draw happens on EVERY call (fired or not) so
        the set of firing call-indices is a pure function of the seed,
        independent of ``max``/``after`` bookkeeping."""
        self.calls += 1
        n = self.calls
        draw = rng.random() if self.prob is not None else 0.0
        if n <= self.after:
            return False
        if self.max_fires is not None and self.fired >= self.max_fires:
            return False
        if self.at is not None:
            hit = n in self.at
        elif self.count is not None:
            hit = (n - self.after) <= self.count
        elif self.every is not None:
            hit = (n - self.after) % self.every == 0
        elif self.prob is not None:
            hit = draw < self.prob
        else:
            hit = True              # bare site spec: always fire
        if hit:
            self.fired += 1
        return hit


def parse_fault_spec(spec: str) -> FaultRule:
    """``"site:key=value:key=value"`` -> :class:`FaultRule`.  Unknown
    keys become pass-through params the call site can read (``delay``,
    ``cut``, ...)."""
    parts = [p.strip() for p in str(spec).split(":") if p.strip()]
    if not parts or "=" in parts[0]:
        raise FaultSpecError(f"fault spec needs a leading site: {spec!r}")
    site = parts[0]
    at: list[int] = []
    kw: dict = {"params": {}}
    for part in parts[1:]:
        key, eq, raw = part.partition("=")
        if not eq:
            raise FaultSpecError(f"bad fault spec clause {part!r} "
                                 f"in {spec!r}")
        key = key.strip()
        raw = raw.strip()
        try:
            if key in _STR_KEYS:
                val: object = raw
            else:
                val = int(raw) if raw.lstrip("-").isdigit() else float(raw)
        except ValueError:
            raise FaultSpecError(
                f"bad value {raw!r} for {key!r} in {spec!r}") from None
        if key == "at":
            at.append(int(val))
        elif key == "count":
            kw["count"] = int(val)
        elif key == "every":
            kw["every"] = int(val)
        elif key == "prob":
            p = float(val)
            if not 0.0 <= p <= 1.0:
                raise FaultSpecError(f"prob must be in [0,1]: {spec!r}")
            kw["prob"] = p
        elif key == "after":
            kw["after"] = int(val)
        elif key == "max":
            kw["max_fires"] = int(val)
        else:
            kw["params"][key] = val
    if at:
        kw["at"] = at
    return FaultRule(site, **kw)


class ChaosPlane:
    """The armed schedule: rules by site, per-site seeded RNGs, and the
    bounded fault event log."""

    def __init__(self, seed: int = 0, rules: "list[FaultRule] | None" = None,
                 log_size: int = 8192):
        self.seed = int(seed)
        self.rules: dict[str, FaultRule] = {}
        for r in rules or []:
            if r.site in self.rules:
                raise FaultSpecError(f"duplicate fault site {r.site!r}")
            self.rules[r.site] = r
        self.log: deque = deque(maxlen=max(16, int(log_size)))
        self._rngs: dict[str, random.Random] = {}
        self._seq = 0

    def site_rng(self, site: str) -> random.Random:
        """Deterministic per-site RNG for payload draws (which byte to
        corrupt, how long to delay): seeded from ``seed`` + the site
        name so one site's draws never depend on another site's call
        volume.  The seed is a STRING — str/bytes seeds hash through
        sha512, stable across processes and Python versions, whereas a
        tuple seed is rejected on 3.11+ and falls back to the
        process-salted ``hash()`` on 3.10 (not reproducible)."""
        rng = self._rngs.get(site)
        if rng is None:
            rng = self._rngs[site] = random.Random(f"{self.seed}:{site}")
        return rng

    def fire(self, site: str, **detail) -> "dict | None":
        rule = self.rules.get(site)
        if rule is None:
            return None
        for k, v in rule.selectors.items():
            # selector mismatch: not part of this rule's stream at all
            # (the call index does not advance)
            if detail.get(k) != v:
                return None
        if not rule.decide(self.site_rng(site)):
            return None
        self._seq += 1
        ev = dict(rule.params)
        ev.update(detail)
        ev.update(site=site, n=rule.calls, fire=rule.fired, seq=self._seq)
        self.log.append(ev)
        _chaos_metrics().inc(site=site)
        return ev

    def events(self) -> list[dict]:
        return [dict(e) for e in self.log]

# ------------------------------------------------------------- module API


def is_enabled() -> bool:
    """Hot-path gate for call sites that would otherwise build detail
    dicts or bytearrays just to have :func:`fire` drop them."""
    return _ENABLED


def fire(site: str, **detail) -> "dict | None":
    """THE injection point: ``None`` means proceed normally; a dict
    means inject (its keys are the rule's params + the caller's
    detail).  First instruction returns when chaos is disabled.  The
    plane is snapshotted locally: injection sites run on worker threads
    (device dispatch, WAL writes, the scheduler pool), so a concurrent
    ``reset()`` must degrade to a no-op, never an AttributeError."""
    if not _ENABLED:
        return None
    plane = _PLANE
    if plane is None:
        return None
    return plane.fire(site, **detail)


def site_rng(site: str) -> random.Random:
    """Per-site payload RNG; callers sit behind a :func:`fire` hit.  If
    a concurrent ``reset()`` won the race since that hit, hand back a
    throwaway RNG — the in-flight injection still completes, it just
    stops being seeded (the event was already logged or dropped)."""
    plane = _PLANE
    if plane is None:
        return random.Random(0)
    return plane.site_rng(site)


def configure(enabled: bool | None = None, seed: int | None = None,
              faults: "list[str] | None" = None,
              log_size: int | None = None) -> None:
    """Install (or clear) the process-wide plane.  ``faults`` are spec
    strings (:func:`parse_fault_spec`); passing any of ``seed`` /
    ``faults`` / ``log_size`` rebuilds the plane (fresh counters, fresh
    per-site RNGs, empty log) — re-arming the same seed+specs is
    exactly the "replay the schedule" operation."""
    global _ENABLED, _PLANE
    with _CONF_LOCK:
        if seed is not None or faults is not None or log_size is not None:
            cur = _PLANE
            _PLANE = ChaosPlane(
                seed=seed if seed is not None
                else (cur.seed if cur else 0),
                rules=[parse_fault_spec(s) for s in (faults or [])],
                log_size=log_size if log_size is not None
                else (cur.log.maxlen if cur else 8192))
        if enabled is not None:
            if enabled and _PLANE is None:
                _PLANE = ChaosPlane()
            _ENABLED = bool(enabled)


def reset() -> None:
    """Disarm everything (tests)."""
    global _ENABLED, _PLANE
    with _CONF_LOCK:
        _ENABLED = False
        _PLANE = None


def events() -> list[dict]:
    return _PLANE.events() if _PLANE is not None else []

