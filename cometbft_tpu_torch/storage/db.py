"""Key-value store abstraction (reference: the cometbft-db interface:
Get/Set/Delete/Iterator/Batch over pluggable backends).

Counterpart of ``cometbft_tpu/storage/db.py``: the ``KVStore``
interface, ``DataDirLock``, the height-ordered key layout, the in-memory
``MemDB`` and ``LogDB``, a crash-safe append-only record log with an
in-memory index and size-triggered compaction, whose files are the JAX
package's byte for byte (each package opens the other's).  ``open_db``
makes the ``"memdb"`` and ``"logdb"`` backends and the C++ engine
(``"native"``, ``storage/nativedb.py``).
"""

from __future__ import annotations

import errno
import fcntl
import functools
import json
import os
import struct
import zlib
from abc import ABC, abstractmethod

from ..libs import failures
from ..types import _msgpack

__all__ = ["KVStore", "DataDirLock", "height_key", "MemDB", "LogDB",
           "open_db"]


@functools.cache
def _salvage_metrics():
    """Mid-log corruption accounting (registered once): every salvage is
    a data-loss event an operator must hear about."""
    from ..libs import metrics as m

    return (
        m.counter("db_corrupt_records_total",
                  "LogDB record parses that failed mid-log (one per "
                  "quarantined span; torn tails are truncated, not "
                  "counted here)"),
        m.counter("db_salvaged_spans_total",
                  "corrupt LogDB byte spans skipped and quarantined to "
                  "the .quarantine sidecar on open"),
    )


class KVStore(ABC):
    @abstractmethod
    def get(self, key: bytes) -> bytes | None: ...

    @abstractmethod
    def set(self, key: bytes, value: bytes) -> None: ...

    @abstractmethod
    def delete(self, key: bytes) -> None: ...

    @abstractmethod
    def iterate(self, start: bytes = b"", end: bytes | None = None):
        """Yield (key, value) sorted ascending, key in [start, end)."""

    @abstractmethod
    def close(self) -> None: ...

    def set_batch(self, items: dict[bytes, bytes | None]) -> None:
        """Grouped write: a None value deletes.  Backends may override it
        to make the batch one durable append."""
        for k, v in items.items():
            if v is None:
                self.delete(k)
            else:
                self.set(k, v)

    def has(self, key: bytes) -> bool:
        return self.get(key) is not None


class DataDirLock:
    """Exclusive advisory lock on a node home's data dir, held for the
    life of the process, so offline tooling refuses to touch a live
    node's stores.  flock is released when the process dies, so a
    crashed node never wedges its home."""

    def __init__(self, data_dir: str):
        os.makedirs(data_dir, exist_ok=True)
        self.path = os.path.join(data_dir, "LOCK")
        self._fd = os.open(self.path, os.O_CREAT | os.O_RDWR, 0o644)
        try:
            fcntl.flock(self._fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError:
            os.close(self._fd)
            raise RuntimeError(
                f"data dir {data_dir} is locked by a running node — "
                "stop it before running offline tooling") from None
        os.write(self._fd, str(os.getpid()).encode())

    def release(self) -> None:
        if self._fd is not None:
            fcntl.flock(self._fd, fcntl.LOCK_UN)
            os.close(self._fd)
            self._fd = None


def height_key(prefix: bytes, height: int) -> bytes:
    """Height-ordered key: ``prefix`` then the height as 8 big-endian
    bytes, so keys sort by height."""
    return prefix + height.to_bytes(8, "big")


class MemDB(KVStore):
    def __init__(self):
        self._data: dict[bytes, bytes] = {}

    def get(self, key):
        return self._data.get(key)

    def set(self, key, value):
        self._data[bytes(key)] = bytes(value)

    def delete(self, key):
        self._data.pop(key, None)

    def iterate(self, start=b"", end=None):
        for k in sorted(self._data):
            if k < start:
                continue
            if end is not None and k >= end:
                break
            yield k, self._data[k]

    def close(self):
        pass


# LogDB record: u32 crc | u32 klen | u32 vlen(or 0xFFFFFFFF tombstone) | k | v
_HDR = struct.Struct("<III")
_TOMBSTONE = 0xFFFFFFFF


class LogDB(KVStore):
    """Append-only log + in-memory index.  Two distinct corruption
    classes are handled on open:

    - **torn tail** (a crash mid-append): no valid record follows the bad
      bytes — truncate to the last good record, exactly the crash-safety
      contract of the reference's WAL-substrate autofile;
    - **mid-log bit-rot**: valid records FOLLOW the bad bytes — replay
      forward-scans to the next valid ``crc|klen|vlen`` boundary,
      quarantines the corrupt span to a ``<path>.quarantine`` sidecar,
      rewrites the log clean, and marks the store **dirty**
      (``<path>.dirty``).  Salvage alone is not trustworthy — a skipped
      span can resurrect a stale value or lose a tombstone — so the
      dirty marker stays until a deep verification clears it (the JAX
      package's storage doctor, ``node/doctor.py``, which the port has
      not yet).
    """

    def __init__(self, path: str):
        self.path = path
        self._base = os.path.basename(path)
        self._data: dict[bytes, bytes] = {}
        self._live_bytes = 0
        self._log_bytes = 0
        # salvage report for this open (the doctor reads these)
        self.salvaged = False
        self.salvage_spans: list[tuple[int, int]] = []
        # same fsyncgate discipline as consensus/wal.py: after one
        # write/fsync failure the handle is dead — the in-memory index
        # may already be ahead of what durably landed, and a retried
        # fsync on the same fd proves nothing.  Every further write
        # raises; recovery is a restart replaying the intact log prefix.
        self._io_failed: Exception | None = None
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._replay()
        self._f = open(path, "ab")

    # ------------------------------------------------------ replay/salvage

    @staticmethod
    def _parse_at(raw: bytes, off: int):
        """One record at ``off`` -> (key, value|None, end) or None if the
        bytes there do not decode to a CRC-valid record."""
        if off + _HDR.size > len(raw):
            return None
        crc, klen, vlen = _HDR.unpack_from(raw, off)
        vl = 0 if vlen == _TOMBSTONE else vlen
        end = off + _HDR.size + klen + vl
        if end > len(raw):
            return None
        body = raw[off + _HDR.size:end]
        if zlib.crc32(body) != crc:
            return None
        key = body[:klen]
        return key, (None if vlen == _TOMBSTONE else body[klen:]), end

    @classmethod
    def _scan_next_record(cls, raw: bytes, start: int) -> int | None:
        """Forward-scan for the next offset where a CRC-valid record
        parses (a 32-bit CRC over the candidate body makes a false
        boundary astronomically unlikely; implausible lengths reject
        candidates before any CRC is computed)."""
        n = len(raw)
        for off in range(start, n - _HDR.size + 1):
            if cls._parse_at(raw, off) is not None:
                return off
        return None

    def _replay(self):
        if not os.path.exists(self.path):
            return
        with open(self.path, "rb") as f:
            raw = f.read()
        fired = failures.fire("db.replay.corrupt", file=self._base)
        if fired is not None and len(raw) > _HDR.size:
            # seeded bit-flip on open: the chaos analogue of at-rest
            # bit-rot.  frac= pins the flip position (fraction of the
            # file); otherwise the per-site RNG draws it.
            rng = failures.site_rng("db.replay.corrupt")
            frac = fired.get("frac")
            pos = int(float(frac) * (len(raw) - 1)) if frac is not None \
                else rng.randrange(len(raw))
            mut = bytearray(raw)
            mut[pos] ^= 1 << rng.randrange(8)
            raw = bytes(mut)
        off = 0
        good_end = 0
        spans: list[tuple[int, int]] = []
        while off + _HDR.size <= len(raw):
            parsed = self._parse_at(raw, off)
            if parsed is None:
                resume = self._scan_next_record(raw, off + 1)
                if resume is None:
                    break                 # torn tail: truncate below
                spans.append((off, resume))
                off = resume
                continue
            key, value, end = parsed
            if value is None:
                self._data.pop(key, None)
            else:
                self._data[key] = value
            off = good_end = end
        self._live_bytes = sum(len(k) + len(v)
                               for k, v in self._data.items())
        if spans:
            self._salvage(raw, spans)
            return
        if good_end < len(raw):
            with open(self.path, "r+b") as f:
                f.truncate(good_end)
        self._log_bytes = good_end

    def _salvage(self, raw: bytes, spans: list[tuple[int, int]]) -> None:
        """Mid-log corruption found: quarantine every corrupt span to the
        sidecar, rewrite the log from the surviving index, and mark the
        store dirty until deep verification clears it."""
        with open(self.path + ".quarantine", "ab") as f:
            for lo, hi in spans:
                f.write(_msgpack.packb(
                    {"off": lo, "len": hi - lo, "data": raw[lo:hi]}))
            f.flush()
            os.fsync(f.fileno())
        corrupt, salvaged = _salvage_metrics()
        for _ in spans:
            corrupt.inc(file=self._base)
            salvaged.inc(file=self._base)
        self.salvaged = True
        self.salvage_spans = list(spans)
        self.mark_dirty({"spans": [[lo, hi] for lo, hi in spans],
                         "file": self._base})
        # rewrite the log clean so the next open replays without
        # re-salvaging (and the torn tail past the last span is dropped)
        tmp = self.path + ".salvage"
        total = 0
        with open(tmp, "wb") as f:
            for k, v in self._data.items():
                rec = self._record(k, v)
                f.write(rec)
                total += len(rec)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)
        self._log_bytes = total

    # ------------------------------------------------------- dirty marker

    def _dirty_path(self) -> str:
        return self.path + ".dirty"

    def mark_dirty(self, info: dict | None = None) -> None:
        """Persist the needs-deep-verification flag (survives restarts: a
        crash between salvage and verification must not lose it)."""
        with open(self._dirty_path(), "w") as f:
            json.dump(info or {}, f)
            f.flush()
            os.fsync(f.fileno())

    def clear_dirty(self) -> None:
        try:
            os.unlink(self._dirty_path())
        except FileNotFoundError:
            pass

    def is_dirty(self) -> bool:
        return os.path.exists(self._dirty_path())

    def dirty_info(self) -> dict | None:
        try:
            with open(self._dirty_path()) as f:
                return json.load(f)
        except (OSError, ValueError):   # the marker's detail only
            return None

    @staticmethod
    def _record(key: bytes, value: bytes | None) -> bytes:
        vlen = _TOMBSTONE if value is None else len(value)
        body = key + (value or b"")
        return _HDR.pack(zlib.crc32(body), len(key), vlen) + body

    def _append(self, key: bytes, value: bytes | None):
        self._append_raw(self._record(key, value))

    def _append_raw(self, rec: bytes):
        if self._io_failed is not None:
            raise OSError(
                errno.EIO,
                "LogDB is dead after an earlier IO failure (never retry "
                "on the same fd)") from self._io_failed
        try:
            f = failures.fire("db.append.enospc", file=self._base)
            if f is not None:
                raise OSError(errno.ENOSPC,
                              "chaos: injected ENOSPC on append")
            self._f.write(rec)
            self._f.flush()
            f = failures.fire("db.fsync.eio", file=self._base)
            if f is not None:
                raise OSError(errno.EIO, "chaos: injected fsync EIO")
            os.fsync(self._f.fileno())
        except OSError as e:
            self._io_failed = e
            raise
        self._log_bytes += len(rec)
        if (self._log_bytes > 1 << 20
                and self._log_bytes > 4 * max(self._live_bytes, 1)):
            self._compact()

    def set_batch(self, items):
        """All records in one append + one fsync (block-save hot path)."""
        recs = []
        for k, v in items.items():
            k = bytes(k)
            old = self._data.get(k)
            if v is None:
                if old is None:
                    continue
                del self._data[k]
                self._live_bytes -= len(k) + len(old)
            else:
                v = bytes(v)
                self._data[k] = v
                self._live_bytes += len(k) + len(v) - (
                    len(k) + len(old) if old is not None else 0)
            recs.append(self._record(k, v))
        if recs:
            self._append_raw(b"".join(recs))

    def _compact(self):
        # any IO failure here is fsyncgate-fatal for the handle: an
        # exception between the close and the reopen used to leave later
        # appends dying on a closed-file ValueError instead of the
        # dead-handle OSError discipline — route every failure through
        # _io_failed so the caller sees one consistent contract
        tmp = self.path + ".compact"
        try:
            with open(tmp, "wb") as f:
                total = 0
                for k, v in self._data.items():
                    body = k + v
                    rec = _HDR.pack(zlib.crc32(body), len(k), len(v)) + body
                    f.write(rec)
                    total += len(rec)
                f.flush()
                os.fsync(f.fileno())
            self._f.close()
            fired = failures.fire("db.compact.eio", file=self._base)
            if fired is not None:
                raise OSError(errno.EIO,
                              "chaos: injected EIO mid-compaction")
            os.replace(tmp, self.path)
            self._f = open(self.path, "ab")
        except OSError as e:
            self._io_failed = e
            raise
        self._log_bytes = total

    def get(self, key):
        return self._data.get(key)

    def set(self, key, value):
        key, value = bytes(key), bytes(value)
        old = self._data.get(key)
        self._data[key] = value
        self._live_bytes += len(key) + len(value) - (
            len(key) + len(old) if old is not None else 0)
        self._append(key, value)

    def delete(self, key):
        if key in self._data:
            old = self._data.pop(key)
            self._live_bytes -= len(key) + len(old)
            self._append(key, None)

    def iterate(self, start=b"", end=None):
        for k in sorted(self._data):
            if k < start:
                continue
            if end is not None and k >= end:
                break
            yield k, self._data[k]

    def close(self):
        self._f.close()


def open_db(backend: str, path: str | None = None) -> KVStore:
    """Backend factory, the one dispatch point (``storage.db_backend``):
    ``"memdb"``, ``"logdb"`` or ``"native"`` (the C++ engine of
    ``storage/nativedb.py``, file-compatible with ``"logdb"``)."""
    if backend == "memdb":
        return MemDB()
    if backend == "logdb":
        if not path:
            raise ValueError("logdb requires a path")
        return LogDB(path)
    if backend == "native":
        from .nativedb import NativeDB

        if not path:
            raise ValueError("native requires a path")
        return NativeDB(path)
    raise ValueError(f"unknown db backend {backend!r}")
