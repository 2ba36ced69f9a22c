"""Metrics: counters, gauges and histograms with labels (counterpart of
``cometbft_tpu/libs/metrics.py``, without its Prometheus text
exposition, which the networked node's RPC serves; reference:
``libs/metrics/metrics.go`` and the per-subsystem ``metrics.gen.go``).

One process-wide default registry: subsystems (consensus, the WAL, the
mempool, the verification scheduler) construct their metric sets
against it; callers read them through ``value``, ``count`` and ``sum``."""

from __future__ import annotations

import threading
import time
from bisect import bisect_right


class Registry:
    def __init__(self):
        self._metrics: dict[str, "_Metric"] = {}
        self._lock = threading.Lock()

    def register(self, metric: "_Metric") -> "_Metric":
        with self._lock:
            existing = self._metrics.get(metric.name)
            if existing is not None:
                if type(existing) is not type(metric):
                    # silently handing back a Counter to code that asked
                    # for a Gauge produces AttributeErrors (or worse,
                    # wrong series) far from the offending registration
                    raise ValueError(
                        f"metric {metric.name!r} already registered as "
                        f"{type(existing).__name__}, cannot re-register "
                        f"as {type(metric).__name__}")
                return existing
            self._metrics[metric.name] = metric
            return metric

DEFAULT = Registry()


# Default ceiling on distinct label sets per metric.  Per-peer labels
# (p2p telemetry) would otherwise grow the registry without bound as
# peers churn over a long-running node's lifetime; closed label sets
# (step names, channel names...) never come near it.
DEFAULT_MAX_LABEL_SETS = 512


class _Metric:
    TYPE = "untyped"

    def __init__(self, name: str, help_: str = "",
                 max_label_sets: int = DEFAULT_MAX_LABEL_SETS):
        self.name = name
        self.help = help_
        self.max_label_sets = max(1, int(max_label_sets))
        self.evicted_total = 0        # guarded by self._lock
        self._lock = threading.Lock()

    def _evict_locked(self, *value_dicts: dict) -> None:
        """Drop the oldest labeled child so a new one fits the cap
        (called with self._lock held, BEFORE inserting the new key).
        The unlabeled series ``()`` is never the victim — it is the
        metric itself, not a per-entity child.  Insertion order is the
        eviction order (dicts preserve it), which approximates
        oldest-peer-first under churn."""
        primary = value_dicts[0]
        victim = None
        for k in primary:
            if k != ():
                victim = k
                break
        if victim is None:       # only the unlabeled series exists
            return
        for d in value_dicts:
            d.pop(victim, None)
        self.evicted_total += 1


class Counter(_Metric):
    TYPE = "counter"

    def __init__(self, name, help_="",
                 max_label_sets: int = DEFAULT_MAX_LABEL_SETS):
        super().__init__(name, help_, max_label_sets)
        self._values: dict[tuple, float] = {}

    def inc(self, amount: float = 1.0, **labels) -> None:
        self._inc_key(tuple(sorted(labels.items())), amount)

    def _inc_key(self, key: tuple, amount: float) -> None:
        with self._lock:
            try:                      # common path: key exists, no guard
                self._values[key] += amount
            except KeyError:
                if len(self._values) >= self.max_label_sets:
                    self._evict_locked(self._values)
                self._values[key] = float(amount)

    def bind(self, **labels) -> "_BoundCounter":
        """Pre-resolve a label set for hot paths: ``bind(...)`` once,
        then ``.inc()`` skips the per-call label sort (worth ~3us per
        event on the vote-gossip path)."""
        return _BoundCounter(self, tuple(sorted(labels.items())))

    def value(self, **labels) -> float:
        return self._values.get(tuple(sorted(labels.items())), 0.0)

class _BoundCounter:
    """A counter pre-bound to one label set (see :meth:`Counter.bind`)."""

    __slots__ = ("_c", "_key")

    def __init__(self, counter: Counter, key: tuple):
        self._c = counter
        self._key = key

    def inc(self, amount: float = 1.0) -> None:
        self._c._inc_key(self._key, amount)


class Gauge(_Metric):
    TYPE = "gauge"

    def __init__(self, name, help_="",
                 max_label_sets: int = DEFAULT_MAX_LABEL_SETS):
        super().__init__(name, help_, max_label_sets)
        self._values: dict[tuple, float] = {}

    def set(self, value: float, **labels) -> None:
        self._set_key(tuple(sorted(labels.items())), value)

    def _set_key(self, key: tuple, value: float) -> None:
        with self._lock:
            if key not in self._values and \
                    len(self._values) >= self.max_label_sets:
                self._evict_locked(self._values)
            self._values[key] = float(value)

    def add(self, amount: float, **labels) -> None:
        self._add_key(tuple(sorted(labels.items())), amount)

    def _add_key(self, key: tuple, amount: float) -> None:
        with self._lock:
            try:
                self._values[key] += amount
            except KeyError:
                if len(self._values) >= self.max_label_sets:
                    self._evict_locked(self._values)
                self._values[key] = float(amount)

    def bind(self, **labels) -> "_BoundGauge":
        """Pre-resolve a label set for hot paths (see Counter.bind)."""
        return _BoundGauge(self, tuple(sorted(labels.items())))

    def value(self, **labels) -> float:
        return self._values.get(tuple(sorted(labels.items())), 0.0)

class _BoundGauge:
    """A gauge pre-bound to one label set (see :meth:`Gauge.bind`)."""

    __slots__ = ("_g", "_key")

    def __init__(self, gauge: Gauge, key: tuple):
        self._g = gauge
        self._key = key

    def set(self, value: float) -> None:
        self._g._set_key(self._key, value)

    def add(self, amount: float) -> None:
        self._g._add_key(self._key, amount)


DEFAULT_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                   0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


class Histogram(_Metric):
    TYPE = "histogram"

    def __init__(self, name, help_="", buckets=DEFAULT_BUCKETS,
                 max_label_sets: int = DEFAULT_MAX_LABEL_SETS):
        super().__init__(name, help_, max_label_sets)
        self.buckets = tuple(sorted(buckets))
        self._counts: dict[tuple, list[int]] = {}
        self._sums: dict[tuple, float] = {}
        self._totals: dict[tuple, int] = {}

    def observe(self, value: float, **labels) -> None:
        self._observe_key(tuple(sorted(labels.items())), value)

    def _observe_key(self, key: tuple, value: float) -> None:
        with self._lock:
            counts = self._counts.get(key)
            if counts is None:
                if len(self._counts) >= self.max_label_sets:
                    self._evict_locked(self._counts, self._sums,
                                       self._totals)
                counts = self._counts[key] = [0] * (len(self.buckets) + 1)
            # cumulative-bucket semantics: le is inclusive
            idx = bisect_right(self.buckets, value)
            if idx > 0 and self.buckets[idx - 1] == value:
                idx -= 1
            counts[min(idx, len(self.buckets))] += 1
            self._sums[key] = self._sums.get(key, 0.0) + value
            self._totals[key] = self._totals.get(key, 0) + 1

    def bind(self, **labels) -> "_BoundHistogram":
        """Pre-resolve a label set for hot paths (see Counter.bind)."""
        return _BoundHistogram(self, tuple(sorted(labels.items())))

    def count(self, **labels) -> int:
        """Total observations for a label set (programmatic consumers:
        bench output, scheduler occupancy stats)."""
        return self._totals.get(tuple(sorted(labels.items())), 0)

    def sum(self, **labels) -> float:
        """Sum of observed values for a label set."""
        return self._sums.get(tuple(sorted(labels.items())), 0.0)


class _BoundHistogram:
    """A histogram pre-bound to one label set (see Histogram.bind)."""

    __slots__ = ("_h", "_key")

    def __init__(self, hist: Histogram, key: tuple):
        self._h = hist
        self._key = key

    def observe(self, value: float) -> None:
        self._h._observe_key(self._key, value)


def counter(name: str, help_: str = "",
            registry: Registry | None = None,
            max_label_sets: int = DEFAULT_MAX_LABEL_SETS) -> Counter:
    return (registry or DEFAULT).register(
        Counter(name, help_, max_label_sets))


def gauge(name: str, help_: str = "",
          registry: Registry | None = None,
          max_label_sets: int = DEFAULT_MAX_LABEL_SETS) -> Gauge:
    return (registry or DEFAULT).register(Gauge(name, help_, max_label_sets))


def histogram(name: str, help_: str = "", buckets=DEFAULT_BUCKETS,
              registry: Registry | None = None,
              max_label_sets: int = DEFAULT_MAX_LABEL_SETS) -> Histogram:
    return (registry or DEFAULT).register(
        Histogram(name, help_, buckets, max_label_sets))
