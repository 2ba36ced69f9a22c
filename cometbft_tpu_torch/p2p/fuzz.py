"""Fuzzed peer connections (counterpart of ``cometbft_tpu/p2p/fuzz.py``;
reference: ``p2p/fuzz.go`` FuzzedConnection and
``config.FuzzConnConfig``): wrap the raw stream pair under the secret
connection and, per IO, delay it, drop a write, or kill the connection.

Dropping an encrypted frame's write desynchronises the AEAD nonce
sequence, so the peer's next decrypt fails and the connection tears down
through the real error path: the switch's redial of persistent peers,
pex's redial of the others, and gossip resuming after.

Decisions come from the config's own ``random.Random(seed)``
(``p2p.fuzz_seed``), never the module ``random``: the same seed gives
the same decision stream, as in the JAX package.  With the fault plane
(``libs/failures.py``) armed, the sites ``p2p.fuzz.drop``,
``p2p.fuzz.delay`` and ``p2p.fuzz.kill`` decide before the local
probabilities, and land in the plane's event log."""

from __future__ import annotations

import asyncio
import random

from ..libs import clock, failures

__all__ = ["MODE_DROP", "MODE_DELAY", "FuzzConnConfig", "FuzzedReader",
           "FuzzedWriter", "fuzz_streams"]

MODE_DROP = "drop"
MODE_DELAY = "delay"


class FuzzConnConfig:
    """config.FuzzConnConfig's defaults (config/config.go
    DefaultFuzzConnConfig): drop mode, 3 s of delay at most, 1% drops."""

    def __init__(self, mode: str = MODE_DROP,
                 max_delay_s: float = 3.0,
                 prob_drop_rw: float = 0.01,
                 prob_drop_conn: float = 0.0,
                 prob_sleep: float = 0.0,
                 start_after_s: float = 0.0,
                 seed: int = 0):
        self.mode = mode
        self.max_delay_s = max_delay_s
        self.prob_drop_rw = prob_drop_rw
        self.prob_drop_conn = prob_drop_conn
        self.prob_sleep = prob_sleep
        self.start_after_s = start_after_s
        self.rng = random.Random(seed)
        # decisions taken, by kind: what a run reads of its fuzzing
        self.counts = {"drop": 0, "kill": 0, "delay": 0, "pass": 0}


class _Fuzzer:
    def __init__(self, cfg: FuzzConnConfig, writer):
        self.cfg = cfg
        self.writer = writer
        self._t0 = clock.monotonic()

    def _active(self) -> bool:
        return (clock.monotonic() - self._t0) >= self.cfg.start_after_s

    async def fuzz(self) -> bool:
        """Whether this IO is swallowed (fuzz.go:110)."""
        if not self._active():
            return False
        cfg = self.cfg
        counts = cfg.counts
        if failures.is_enabled():
            # an armed p2p.fuzz.* site decides, and logs, instead of the
            # local draw
            if failures.fire("p2p.fuzz.kill") is not None:
                counts["kill"] += 1
                self.writer.close()
                return True
            if failures.fire("p2p.fuzz.drop") is not None:
                counts["drop"] += 1
                return True
            f = failures.fire("p2p.fuzz.delay")
            if f is not None:
                counts["delay"] += 1
                await clock.sleep(float(f.get(
                    "delay",
                    failures.site_rng("p2p.fuzz.delay").random()
                    * cfg.max_delay_s)))
                return False
        if cfg.mode == MODE_DELAY:
            counts["delay"] += 1
            await clock.sleep(cfg.rng.random() * cfg.max_delay_s)
            return False
        r = cfg.rng.random()
        if r <= cfg.prob_drop_rw:
            counts["drop"] += 1
            return True
        if r < cfg.prob_drop_rw + cfg.prob_drop_conn:
            counts["kill"] += 1
            self.writer.close()
            return True
        if r < cfg.prob_drop_rw + cfg.prob_drop_conn + cfg.prob_sleep:
            counts["delay"] += 1
            await clock.sleep(cfg.rng.random() * cfg.max_delay_s)
            return False
        counts["pass"] += 1
        return False


class FuzzedReader:
    """The StreamReader surface the secret connection uses."""

    def __init__(self, reader: asyncio.StreamReader, fuzzer: _Fuzzer):
        self._reader = reader
        self._fuzzer = fuzzer

    async def readexactly(self, n: int) -> bytes:
        # reads are only delayed, never dropped: a swallowed read on a
        # reliable stream would shift the frame boundary
        f = self._fuzzer
        if f._active() and f.cfg.mode == MODE_DELAY:
            f.cfg.counts["delay"] += 1
            await clock.sleep(f.cfg.rng.random() * f.cfg.max_delay_s)
        return await self._reader.readexactly(n)

    def __getattr__(self, name):
        return getattr(self._reader, name)


class FuzzedWriter:
    """The StreamWriter surface the secret connection uses.

    Drains are serialised: each takes what was written before it, and
    its decision, delay and write come after those of the drain before.
    The JAX writer lets a later drain whose delay is shorter write first;
    an MConnection has two writers (its send routine and its ping
    routine), so in delay mode its encrypted frames could reach the peer
    out of nonce order and tear the connection down, which a delay must
    not do.  The decisions are the JAX writer's, drawn in the same
    order for sequential IO."""

    def __init__(self, writer: asyncio.StreamWriter, fuzzer: _Fuzzer):
        self._writer = writer
        self._fuzzer = fuzzer
        self._buffer = b""
        self._lock = asyncio.Lock()

    def write(self, data: bytes) -> None:
        # write() is synchronous in asyncio: the decision is taken at
        # drain(), the flush point, for everything buffered since
        self._buffer += bytes(data)

    async def drain(self) -> None:
        data, self._buffer = self._buffer, b""
        async with self._lock:
            if await self._fuzzer.fuzz():
                return                 # swallowed: the peer never sees it
            if data:
                self._writer.write(data)
            await self._writer.drain()

    def close(self) -> None:
        self._writer.close()

    def __getattr__(self, name):
        return getattr(self._writer, name)


def fuzz_streams(reader, writer, cfg: FuzzConnConfig):
    """Wrap a stream pair (FuzzConnAfterFromConfig when
    ``cfg.start_after_s`` > 0, FuzzConnFromConfig otherwise)."""
    fz = _Fuzzer(cfg, writer)
    return FuzzedReader(reader, fz), FuzzedWriter(writer, fz)
