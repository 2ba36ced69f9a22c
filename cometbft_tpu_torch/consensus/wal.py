"""Consensus write-ahead log (counterpart of
``cometbft_tpu/consensus/wal.py``; reference: ``internal/consensus/wal.go``
over ``internal/autofile/group.go``'s rotating file groups).

Every message (peer message, own message, timeout) is logged before it is
processed; own votes and proposals are fsync'd before they can be sent.
Records are ``crc32(body) | len | body`` with MessagePack bodies from the
port's own subset (``types/_msgpack.py``), byte for byte what the JAX
package's ``msgpack`` writes, so each package reads the other's WAL.  A
height sentinel (``EndHeightMessage``, wal.go:43) marks each committed
height so replay starts after the last one.

The log rotates into fixed-size segments (``<path>``, ``<path>.001``,
...); segments wholly behind the previous EndHeight sentinel are pruned.
A torn tail is truncated on open, and reading stops at the first corrupt
record.  The read-only tooling (``iter_wal_records_readonly``,
``last_end_height``) and ``quarantine_wal`` serve the storage doctor,
the liveness watchdog's WAL tail and inspect mode."""

from __future__ import annotations

import errno
import functools
import os
import struct
import time
import zlib

from ..libs import failures, tracing
from ..types import _msgpack

_HDR = struct.Struct("<II")
MAX_BODY = 1 << 20            # 1 MB cap, like the reference's maxMsgSizeBytes
DEFAULT_SEGMENT_BYTES = 4 << 20


class WALError(Exception):
    pass


@functools.cache
def _wal_metrics():
    """WAL latency series (registered once): fsync stalls on a loaded
    disk are a classic hidden consensus-latency source — every own vote
    is fsync'd before it may be broadcast."""
    from ..libs import metrics as m

    return (
        m.histogram("consensus_wal_write_seconds",
                    "WAL record append latency (buffered write)",
                    buckets=(0.00005, 0.0001, 0.00025, 0.0005, 0.001,
                             0.0025, 0.005, 0.01, 0.05, 0.1)),
        m.histogram("consensus_wal_fsync_seconds",
                    "WAL flush+fsync latency",
                    buckets=(0.0001, 0.00025, 0.0005, 0.001, 0.0025,
                             0.005, 0.01, 0.025, 0.05, 0.1, 0.5, 1)),
    )


def wal_segments(path: str) -> list[str]:
    """Existing segment paths in write order (directory scan: pruning may
    leave index gaps)."""
    d = os.path.dirname(path) or "."
    base = os.path.basename(path)
    found = []          # (index, path); the bare path is index 0
    try:
        names = os.listdir(d)
    except OSError:
        names = []
    for name in names:
        if name == base:
            found.append((0, path))
        elif name.startswith(base + "."):
            suffix = name[len(base) + 1:]
            if suffix.isdigit():
                found.append((int(suffix), os.path.join(d, name)))
    return [p for _, p in sorted(found)]


def _iter_segment_file(path: str):
    """Yields records; final item is the sentinel True when the whole
    segment decoded cleanly, False when it ended in corruption."""
    try:
        with open(path, "rb") as f:
            raw = f.read()
    except OSError:
        yield False
        return
    off = 0
    while off + _HDR.size <= len(raw):
        crc, ln = _HDR.unpack_from(raw, off)
        end = off + _HDR.size + ln
        if ln > MAX_BODY or end > len(raw) or \
                zlib.crc32(raw[off + _HDR.size:end]) != crc:
            yield off == len(raw)
            return
        yield _msgpack.unpackb(raw[off + _HDR.size:end])
        off = end
    yield True


def iter_wal_records_readonly(path: str):
    """Strictly read-only record stream across segments for tooling
    (scripts/wal2json): no truncation, no append handle, no fsync, no
    directory creation.  Raises WALError if the WAL does not exist;
    raises WALError at a corrupt record (after yielding everything intact
    before it) so callers can report instead of silently stopping."""
    segs = wal_segments(path)
    if not segs:
        raise WALError(f"no WAL at {path}")
    for seg in segs:
        clean = False
        for item in _iter_segment_file(seg):
            if isinstance(item, bool):
                clean = item
                break
            yield item
        if not clean:
            raise WALError(f"corrupt record in {seg}; later segments "
                           f"not decoded")


def last_end_height(path: str) -> int | None:
    """Read-only: the last EndHeight sentinel across all segments (the
    storage doctor's WAL-lineage anchor).  Stops at the first corruption
    like replay does — records past a corrupt span are unreachable by
    any replay, so their sentinels must not anchor anything."""
    last = None
    for seg in wal_segments(path):
        clean = False
        for item in _iter_segment_file(seg):
            if isinstance(item, bool):
                clean = item
                break
            if item.get("#") == "endheight":
                last = item["h"]
        if not clean:
            break
    return last


def quarantine_wal(path: str) -> list[str]:
    """Move every WAL segment aside (``<seg>.quarantine``), returning
    the new paths.  Used by the storage doctor when the WAL's lineage
    runs AHEAD of the (repaired) stores: replaying records for heights
    the stores no longer hold would feed consensus a stream from a
    discarded timeline.  Double-sign safety does not depend on the WAL —
    the privval last-sign-state survives untouched."""
    moved = []
    for seg in wal_segments(path):
        dst = seg + ".quarantine"
        i = 0
        while os.path.exists(dst):
            i += 1
            dst = f"{seg}.quarantine.{i}"
        os.replace(seg, dst)
        moved.append(dst)
    return moved


class WAL:
    def __init__(self, path: str,
                 max_segment_bytes: int = DEFAULT_SEGMENT_BYTES):
        self.path = path
        self.max_segment_bytes = max_segment_bytes
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        segs = self._segments()
        if not segs:
            segs = [path]
        self._truncate_torn_tail(segs[-1])
        self._cur_path = segs[-1]
        self._f = open(self._cur_path, "ab")
        # segment holding the PREVIOUS EndHeight sentinel: the safe prune
        # boundary (see prune note below).  Unknown after reopen -> prune
        # nothing until two sentinels have been written in this process.
        self._prev_sentinel_seg: str | None = None
        # fsyncgate: once ANY write/fsync on this handle failed, the
        # kernel may have dropped the dirty pages — a later fsync that
        # "succeeds" on the same fd proves nothing.  The WAL goes dead
        # (every further write/sync raises); recovery is a process
        # restart reopening the file, which truncates the torn tail.
        self._io_failed: Exception | None = None
        # height attribution for fsync tracing events: EndHeight(h)
        # stamps h on its own fsync, then advances the hint — every
        # later fsync (own votes, timeouts) belongs to height h+1
        self._height_hint = 0

    # ------------------------------------------------------------ segments

    def _segments(self) -> list[str]:
        return wal_segments(self.path)

    def _next_segment_path(self) -> str:
        segs = self._segments()
        if not segs or segs[-1] == self.path:
            return f"{self.path}.001"
        idx = int(segs[-1].rsplit(".", 1)[1])
        return f"{self.path}.{idx + 1:03d}"

    def _maybe_rotate(self) -> None:
        if self._f.tell() < self.max_segment_bytes:
            return
        self.flush_and_sync()
        self._f.close()
        self._cur_path = self._next_segment_path()
        self._f = open(self._cur_path, "ab")

    def _truncate_torn_tail(self, path: str) -> None:
        if not os.path.exists(path):
            return
        with open(path, "rb") as f:
            raw = f.read()
        off = 0
        good = 0
        while off + _HDR.size <= len(raw):
            crc, ln = _HDR.unpack_from(raw, off)
            if ln > MAX_BODY:
                break
            end = off + _HDR.size + ln
            if end > len(raw) or zlib.crc32(raw[off + _HDR.size:end]) != crc:
                break
            off = good = end
        if good < len(raw):
            with open(path, "r+b") as f:
                f.truncate(good)

    def prune_completed_segments(self) -> int:
        """Drop whole segments strictly older than the segment holding the
        PREVIOUS EndHeight sentinel (autofile group head checkpointing).

        The previous sentinel — not the latest — is the safe boundary:
        the latest EndHeight(h) is written BEFORE the state for h is
        persisted (state.go:1899 ordering), so a crash right after it
        still replays from EndHeight(h-1).  Everything strictly before
        EndHeight(h-1)'s segment is unreachable by any replay.  Tracked
        in memory at sentinel-write time, so pruning never re-reads the
        log (no file scans on the commit path); after a reopen the
        boundary is unknown and nothing is pruned until two sentinels
        have been written.  Returns segments removed."""
        boundary = self._prev_sentinel_seg
        if boundary is None:
            return 0
        segs = self._segments()
        if boundary not in segs:
            return 0
        removed = 0
        for path in segs:
            if path == boundary or path == self._cur_path:
                break
            os.unlink(path)
            removed += 1
        return removed

    # -------------------------------------------------------------- write

    def _check_alive(self) -> None:
        if self._io_failed is not None:
            raise WALError(
                "WAL is dead after an earlier IO failure (fsyncgate: "
                "never retry on the same fd)") from self._io_failed

    def write(self, record: dict) -> None:
        t0 = time.perf_counter()
        self._check_alive()
        body = _msgpack.packb(record)
        if len(body) > MAX_BODY:
            raise WALError(f"record too big: {len(body)}")
        rec = _HDR.pack(zlib.crc32(body), len(body)) + body
        f = failures.fire("wal.write.torn")
        if f is not None:
            # a torn write IS a crash from the record's point of view:
            # persist a seeded prefix (mid-header or mid-body per the
            # rule's cut= param), then fail the handle like the outage
            # that tore it
            self._io_failed = self._torn_write(rec, f)
            raise WALError("chaos: torn WAL write") from self._io_failed
        try:
            self._f.write(rec)
        except OSError as e:
            self._io_failed = e
            raise
        self._maybe_rotate()
        _wal_metrics()[0].observe(time.perf_counter() - t0)

    def _torn_write(self, rec: bytes, rule: dict) -> Exception:
        """Persist a strict prefix of ``rec`` (the chaos analogue of
        power loss mid-append).  ``cut=header`` tears inside the 8-byte
        crc|len header, ``cut=body`` after a whole header; default draws
        anywhere in the record."""
        rng = failures.site_rng("wal.write.torn")
        cut = rule.get("cut")
        if cut == "header":
            keep = rng.randrange(1, _HDR.size)
        elif cut == "body":
            keep = _HDR.size + rng.randrange(0, max(len(rec) - _HDR.size, 1))
        else:
            keep = rng.randrange(1, len(rec))
        self._f.write(rec[:keep])
        self._f.flush()
        return OSError(errno.EIO, "chaos: write torn mid-record")

    def write_sync(self, record: dict) -> None:
        self.write(record)
        self.flush_and_sync()

    def write_end_height(self, height: int) -> None:
        """fsync'd height sentinel (wal.go:202 EndHeightMessage)."""
        sentinel_seg = self._cur_path
        self._height_hint = height
        self.write_sync({"#": "endheight", "h": height})
        self._height_hint = height + 1
        try:
            self.prune_completed_segments()
        except OSError:
            pass
        self._prev_sentinel_seg = sentinel_seg

    def flush_and_sync(self) -> None:
        t0 = time.perf_counter()
        self._check_alive()
        try:
            self._f.flush()
            f = failures.fire("wal.fsync.eio")
            if f is not None:
                raise OSError(errno.EIO, "chaos: injected fsync EIO")
            os.fsync(self._f.fileno())
        except OSError as e:
            # fsyncgate semantics: an fsync failure is FATAL for this
            # handle.  Linux drops the dirty pages after reporting the
            # error, so retrying fsync on the same fd can "succeed"
            # while the data never hit the platter — mark the WAL dead
            # and let the caller halt consensus.
            self._io_failed = e
            raise
        dt = time.perf_counter() - t0
        _wal_metrics()[1].observe(dt)
        tracing.event("wal", "fsync", path=self._cur_path,
                      height=self._height_hint, dur_us=int(dt * 1e6))

    # --------------------------------------------------------------- read

    def _iter_segment(self, path: str):
        return _iter_segment_file(path)

    def iter_records(self):
        """All intact records across segments, oldest first.  Stops at the
        first corruption: continuing into later segments would hand replay
        a record stream with a silent hole (the single-file WAL's
        truncate-at-corruption semantics, generalized)."""
        self.flush_and_sync()
        for path in self._segments():
            clean = False
            for item in self._iter_segment(path):
                if isinstance(item, bool):
                    clean = item
                    break
                yield item
            if not clean:
                return

    def _segment_first_endheight(self, path: str):
        """First EndHeight sentinel value in a segment, or None (no
        sentinel / unreadable).  Decodes only up to the first sentinel —
        the binary-search probe cost."""
        for item in self._iter_segment(path):
            if isinstance(item, bool):
                return None
            if item.get("#") == "endheight":
                return item["h"]
        return None

    def _search_start_segment(self, segs: list[str], height: int) -> int:
        """Binary search for the last segment that can contain the
        EndHeight(height) sentinel (reference: autofile group binary
        search, ``internal/autofile/group.go:34-54`` via
        ``internal/consensus/wal.go:232`` SearchForEndHeight): sentinel
        heights increase monotonically across segments, so the segment
        whose FIRST sentinel is <= height is a safe scan start — a
        restarting validator reads O(log n) segment heads plus the tail
        instead of every record of every segment.  Segments without any
        sentinel probe their nearest keyed predecessor."""
        if height == 0 or len(segs) <= 1:
            return 0
        probed: dict = {}            # memo: a keyless segment decodes once

        def first_eh(i):
            if i not in probed:
                probed[i] = self._segment_first_endheight(segs[i])
            return probed[i]

        best = 0
        lo, hi = 0, len(segs) - 1
        while lo <= hi:
            mid = (lo + hi) // 2
            j, key = mid, None
            while j >= lo:           # nearest keyed segment at/below mid
                key = first_eh(j)
                if key is not None:
                    break
                j -= 1
            if key is None:          # no sentinel anywhere in [lo, mid]
                lo = mid + 1
                continue
            if key <= height:
                best = j
                lo = mid + 1
            else:
                hi = j - 1
        return best

    def records_after_height(self, height: int) -> list[dict]:
        """Records following the EndHeight(h) sentinel for h == height
        (replay input: catchupReplay, replay.go:95).  If the sentinel is
        missing, returns records from the start (fresh WAL).  Scans only
        from the binary-searched start segment — corruption in the
        unreachable earlier segments is not re-verified (their records
        cannot be replay input)."""
        self.flush_and_sync()
        segs = self._segments()
        out: list[dict] = []
        found = height == 0
        for path in segs[self._search_start_segment(segs, height):]:
            clean = False
            for item in self._iter_segment(path):
                if isinstance(item, bool):
                    clean = item
                    break
                rec = item
                if rec.get("#") == "endheight":
                    if rec["h"] == height:
                        found = True
                        out = []
                    elif rec["h"] > height and not found:
                        raise WALError(
                            f"WAL jumped past height {height} "
                            f"(saw {rec['h']})")
                    continue
                if found or height == 0:
                    out.append(rec)
            if not clean:
                break                 # same stop-at-corruption semantics
        return out

    def close(self) -> None:
        self._f.close()
