"""Liveness watchdog: the node diagnoses its own stalls (counterpart of
``cometbft_tpu/node/watchdog.py``).

``/status`` gives operators ``step_age_s``/``last_commit_age_s`` — but
a human still had to be polling when the stall happened, and by
the time they dump ``/dump_trace`` the flight-recorder ring has often
rolled past the interesting window.  This service closes that loop: it
periodically evaluates three stall conditions and, when one fires,
writes a rate-limited **black-box incident bundle** to disk while the
evidence is still hot:

- ``consensus_step_stalled`` — the state machine has sat in one step
  past the threshold (a wedged round: lost proposer, split vote, ...),
- ``no_recent_commit`` — commits stopped arriving even though steps may
  still churn (round thrash without progress),
- ``peers_quiet`` — connected peers exist but none has produced a
  packet within the threshold (network partition / silent death the
  pong timeout has not caught yet),
- ``consensus_fatal_error`` — the state machine recorded a fatal error.

A bundle is one JSON file carrying the flight-recorder ring dump, the
per-peer telemetry snapshot (`Switch.peer_snapshot`), a consensus state
summary, and the newest WAL records — everything a post-mortem needs,
captured at trip time.  ``GET /dump_incidents`` lists and serves them.

Disk discipline: bundles are rate-limited (``watchdog_min_interval_s``
between writes; a persisting stall re-dumps at that cadence, not per
check tick), written via tmp+rename so readers never see a torn file,
and pruned to the newest ``watchdog_max_bundles``.
"""

from __future__ import annotations

import asyncio
import functools
import json
import os

from ..consensus.wal import wal_segments, _iter_segment_file
from ..libs import clock, tracing
from ..libs.service import BaseService

BUNDLE_PREFIX = "incident-"
BUNDLE_SUFFIX = ".json"
TRACE_DUMP_LIMIT = 4000         # newest flight-recorder records bundled


@functools.cache
def _watchdog_metrics():
    from ..libs import metrics as m

    return (
        m.counter("watchdog_trips_total",
                  "liveness watchdog stall detections, by reason (one "
                  "inc per reason per evaluation that found it)"),
        m.counter("watchdog_bundles_written_total",
                  "incident bundles written to disk"),
        m.counter("watchdog_suppressed_total",
                  "stall detections that wrote no bundle (rate limit)"),
    )


def resolve_incident_dir(config, home: str | None) -> str | None:
    """Where bundles live: the configured path, resolved against the
    node home when relative.  A home-less node (pure in-memory test
    assembly) gets None unless the operator pointed at an absolute
    directory — bundles are a disk artifact by design and an implicit
    cwd-relative dump would litter.  Shared by the live Node and
    inspect mode so both views resolve the same data directory."""
    path = config.instrumentation.watchdog_incident_dir
    if os.path.isabs(path):
        return path
    if home is None:
        return None
    return os.path.join(home, path)


def _jsonable(v):
    """Best-effort JSON projection for bundle payloads (WAL records are
    msgpack dicts that may carry raw bytes)."""
    if isinstance(v, (bytes, bytearray)):
        return v.hex()
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return repr(v)


def wal_tail(wal, limit: int) -> list[dict]:
    """The newest ``limit`` records of a live WAL, read-only (walks the
    segment files backward from the active one until the quota fills;
    flushes the append buffer first so the tail is current).  Returns []
    on any trouble — the bundle must never fail because the WAL is
    mid-rotation."""
    if wal is None or limit <= 0:
        return []
    try:
        f = getattr(wal, "_f", None)
        if f is not None:
            f.flush()
        groups: list[list] = []       # oldest-first record groups
        remaining = limit
        for seg in reversed(wal_segments(wal.path)):
            seg_records = []
            for item in _iter_segment_file(seg):
                if isinstance(item, bool):
                    break
                seg_records.append(item)
            take = seg_records[-remaining:]
            groups.insert(0, take)
            remaining -= len(take)
            if remaining <= 0:
                break
        return [_jsonable(r) for group in groups for r in group]
    except Exception:
        return []


class LivenessWatchdog(BaseService):
    """Rides the node: reads consensus/step ages and p2p liveness, never
    writes to either.  All thresholds come from
    ``[instrumentation] watchdog_*`` (see config.py)."""

    def __init__(self, node, incident_dir: str,
                 stall_threshold_s: float = 60.0,
                 check_interval_s: float = 5.0,
                 min_interval_s: float = 300.0,
                 max_bundles: int = 16,
                 wal_tail_records: int = 200):
        super().__init__(name=f"{getattr(node, 'name', 'node')}.watchdog")
        self.node = node
        self.incident_dir = incident_dir
        self.stall_threshold_s = stall_threshold_s
        self.check_interval_s = check_interval_s
        self.min_interval_s = min_interval_s
        self.max_bundles = max_bundles
        self.wal_tail_records = wal_tail_records
        self.trips = 0                    # detections (pre rate limit)
        self.bundles_written = 0
        self.last_reasons: list[str] = []
        self._last_bundle_mono: float | None = None
        self._task: asyncio.Task | None = None
        self._seq = 0

    # ----------------------------------------------------------- service

    async def on_start(self) -> None:
        os.makedirs(self.incident_dir, exist_ok=True)
        self._task = asyncio.create_task(self._run())

    async def on_stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except (asyncio.CancelledError, Exception):
                pass
            self._task = None

    async def _run(self) -> None:
        try:
            while True:
                await clock.sleep(self.check_interval_s)
                try:
                    reasons = self._evaluate()
                    if reasons is not None:
                        # snapshot the live state on the loop (cheap:
                        # attribute reads + a ring copy), then push the
                        # disk work — WAL segment reads, JSON encode of
                        # a possibly-multi-MB bundle, fsync-adjacent
                        # writes — off the loop so the diagnostic never
                        # causes the pong timeouts it would then report
                        bundle = self.build_bundle(reasons)
                        await asyncio.to_thread(
                            self._write_bundle_file, bundle)
                except asyncio.CancelledError:
                    raise
                except Exception as e:   # diagnosing must never harm
                    self.log.error("watchdog check failed", err=repr(e))
        except asyncio.CancelledError:
            raise

    # ------------------------------------------------------------ checks

    def _evaluate(self) -> list[str] | None:
        """Detection + rate limiting; returns the reasons when a bundle
        is due, None otherwise (no stall, or suppressed)."""
        reasons = self.stall_reasons()
        if not reasons:
            return None
        self.trips += 1
        self.last_reasons = reasons
        trips, _, suppressed = _watchdog_metrics()
        for r in reasons:
            trips.inc(reason=r, node=self.node.name)
        if self._last_bundle_mono is not None and \
                clock.monotonic() - self._last_bundle_mono \
                < self.min_interval_s:
            suppressed.inc(node=self.node.name)
            return None
        return reasons

    def check(self) -> str | None:
        """One synchronous evaluation (tests, tooling): returns the
        bundle path if one was written."""
        reasons = self._evaluate()
        if reasons is None:
            return None
        return self.write_bundle(reasons)

    def stall_reasons(self) -> list[str]:
        thr = self.stall_threshold_s
        reasons = []
        node = self.node
        cs = node.consensus
        # truthiness, not None-ness: inspect-mode shims are falsy.  Only
        # a STARTED state machine can stall (blocksync/statesync phases
        # park consensus legitimately).
        if cs and getattr(cs, "_task", None) is not None:
            if getattr(cs, "fatal_error", None) is not None:
                reasons.append("consensus_fatal_error")
            if cs.step_age_s() > thr:
                reasons.append("consensus_step_stalled")
            last_wall = getattr(cs, "_last_commit_wall_ns", 0)
            if last_wall and \
                    (cs.now_ns() - last_wall) / 1e9 > thr:
                # only after a first commit: a net that never committed
                # is a bootstrap problem the step age already covers
                reasons.append("no_recent_commit")
        sw = node.switch
        if sw is not None and getattr(sw, "peers", None):
            quiet = sw.quietest_peer_recv_age_s()
            if quiet is not None and quiet > thr:
                reasons.append("peers_quiet")
        return reasons

    # ------------------------------------------------------------ bundle

    def build_bundle(self, reasons: list[str]) -> dict:
        node = self.node
        cs = node.consensus
        consensus = None
        if cs:
            last_wall = getattr(cs, "_last_commit_wall_ns", 0)
            consensus = {
                "height": cs.rs.height,
                "round": cs.rs.round,
                "step": cs.rs.step_name(),
                "step_age_s": round(cs.step_age_s(), 6),
                "last_commit_age_s": (
                    round(max(cs.now_ns() - last_wall, 0) / 1e9, 6)
                    if last_wall else None),
                "fatal_error": (repr(cs.fatal_error)
                                if cs.fatal_error else None),
            }
        sw = node.switch
        tstats = tracing.stats()
        return {
            "version": 1,
            "node": node.name,
            "reasons": reasons,
            "wall_time_ns": clock.walltime_ns(),
            "stall_threshold_s": self.stall_threshold_s,
            "height": (node.block_store.height()
                       if node.block_store is not None else None),
            "consensus": consensus,
            "peers": sw.peer_snapshot() if sw is not None else [],
            "peer_quality": (sw.scorer.snapshot()
                             if sw is not None
                             and getattr(sw, "scorer", None) is not None
                             else None),
            "trace": {
                "enabled": tstats["enabled"],
                "buffered": tstats["buffered"],
                "records": tracing.dump(TRACE_DUMP_LIMIT),
            },
        }

    def write_bundle(self, reasons: list[str]) -> str:
        return self._write_bundle_file(self.build_bundle(reasons))

    def _write_bundle_file(self, bundle: dict) -> str:
        """Disk half (runs in a worker thread from the service loop):
        WAL-tail capture, JSON encode, tmp+rename write, pruning.  The
        rate-limit clock advances only on success — a full disk must not
        buy the NEXT trip a 5-minute silence on top of this one."""
        cs = self.node.consensus
        bundle["wal_tail"] = wal_tail(
            getattr(cs, "wal", None) if cs else None,
            self.wal_tail_records)
        self._seq += 1
        # '.' joins reasons: it survives a URL query string verbatim
        # ('+' would decode as a space in GET /dump_incidents?name=...)
        reason_slug = ".".join(bundle["reasons"])[:80].replace("/", "_")
        name = (f"{BUNDLE_PREFIX}{bundle['wall_time_ns']}"
                f"-{self._seq:03d}-{reason_slug}{BUNDLE_SUFFIX}")
        path = os.path.join(self.incident_dir, name)
        tmp = path + ".tmp"
        try:
            with open(tmp, "w") as f:
                json.dump(bundle, f, separators=(",", ":"))
                f.write("\n")
            os.replace(tmp, path)   # readers never see a torn bundle
        except BaseException:
            # a torn .tmp must not compound the disk pressure that
            # likely caused the failure (pruning skips non-.json names)
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        self._last_bundle_mono = clock.monotonic()
        self.bundles_written += 1
        _watchdog_metrics()[1].inc(node=self.node.name)
        self._prune()
        self.log.error("liveness stall: incident bundle written",
                       reasons=",".join(bundle["reasons"]), path=path)
        return path

    def _prune(self) -> None:
        try:
            listing = os.listdir(self.incident_dir)
        except OSError:
            return
        names = sorted(n for n in listing
                       if n.startswith(BUNDLE_PREFIX)
                       and n.endswith(BUNDLE_SUFFIX))
        stale = names[:-self.max_bundles]
        # orphaned .tmp files (a crash mid-write) are always stale
        stale += [n for n in listing if n.startswith(BUNDLE_PREFIX)
                  and n.endswith(BUNDLE_SUFFIX + ".tmp")]
        for name in stale:
            try:
                os.unlink(os.path.join(self.incident_dir, name))
            except OSError:
                pass


def list_incidents(incident_dir: str, limit: int = 50) -> list[dict]:
    """Bundle metadata, newest first, WITHOUT parsing bundle bodies (a
    ring dump can run megabytes; the listing must stay cheap).  The
    filename carries the wall timestamp and reasons."""
    try:
        names = [n for n in os.listdir(incident_dir)
                 if n.startswith(BUNDLE_PREFIX)
                 and n.endswith(BUNDLE_SUFFIX)]
    except OSError:
        return []
    out = []
    for name in sorted(names, reverse=True)[:max(0, int(limit))]:
        path = os.path.join(incident_dir, name)
        try:
            st = os.stat(path)
        except OSError:
            continue
        body = name[len(BUNDLE_PREFIX):-len(BUNDLE_SUFFIX)]
        parts = body.split("-", 2)
        wall_ns = int(parts[0]) if parts and parts[0].isdigit() else None
        reasons = parts[2].split(".") if len(parts) == 3 else []
        out.append({"name": name, "size_bytes": st.st_size,
                    "wall_time_ns": wall_ns, "reasons": reasons})
    return out


def load_incident(incident_dir: str, name: str) -> dict | None:
    """One parsed bundle by listing name; None if absent.  The name is
    validated against the bundle pattern — this is reachable from RPC,
    so no path components may sneak in."""
    if (os.sep in name or (os.altsep and os.altsep in name)
            or not name.startswith(BUNDLE_PREFIX)
            or not name.endswith(BUNDLE_SUFFIX)):
        return None
    path = os.path.join(incident_dir, name)
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None
