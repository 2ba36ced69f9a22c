"""Light client (reference: ``light/client.go:133`` Client).

Counterpart of ``cometbft_tpu/light/client.py``.  It keeps a trusted
header chain from a trust anchor (height and hash inside the trusting
period), fetches light blocks from a primary provider and cross-checks
them against witnesses (``detector.py``) before anything is saved.
Verification skips with bisection by default (``light/client.go:702``
verifySkipping): it jumps straight to the target and fetches
intermediate headers only while the trusted validator set has rotated
too far (ErrNewValSetCantBeTrusted).  Sequential mode fetches every
header and proves each run of headers under one validator set in one
dense device call (``verify_sequential_batched``).  ``device`` is where
the commit rules and the set hashes run (None: CUDA; ``"cpu"``: the
plain versions).
"""

from __future__ import annotations

import time
from fractions import Fraction

from .detector import detect_divergence
from .provider import Provider
from .store import TrustedStore
from .types import (ErrNewValSetCantBeTrusted, LightBlock, LightClientError)
from .verifier import (DEFAULT_TRUST_LEVEL, MAX_CLOCK_DRIFT_NS,
                       verify_non_adjacent, verify_sequential_batched)

__all__ = ["SEQUENTIAL", "SKIPPING", "TrustOptions", "Client"]

SEQUENTIAL = "sequential"
SKIPPING = "skipping"


class TrustOptions:
    """Trust anchor (light.TrustOptions, light/client.go:60)."""

    def __init__(self, period_ns: int, height: int, header_hash: bytes):
        self.period_ns = period_ns
        self.height = height
        self.header_hash = header_hash


class Client:
    def __init__(self, chain_id: str, trust_options: TrustOptions,
                 primary: Provider, witnesses: list[Provider] | None = None,
                 store: TrustedStore | None = None,
                 mode: str = SKIPPING,
                 trust_level: Fraction = DEFAULT_TRUST_LEVEL,
                 max_clock_drift_ns: int = MAX_CLOCK_DRIFT_NS,
                 device=None,
                 pruning_size: int = 1000,
                 now_ns=time.time_ns):
        self.chain_id = chain_id
        self.trust = trust_options
        self.primary = primary
        self.witnesses = list(witnesses or [])
        self.store = store or TrustedStore()
        self.mode = mode
        self.trust_level = trust_level
        self.max_clock_drift_ns = max_clock_drift_ns
        self.device = device
        # light/client.go:26 defaultPruningSize: the store keeps at most
        # this many light blocks (0 = unbounded)
        if pruning_size < 0:
            raise ValueError("pruning_size must be >= 0")
        self.pruning_size = pruning_size
        self.now_ns = now_ns

    def _save(self, lb) -> None:
        self.store.save(lb)
        if self.pruning_size:
            self.store.prune(self.pruning_size)

    # ------------------------------------------------------------ anchor

    async def initialize(self) -> LightBlock:
        """Fetch + pin the trust anchor (light/client.go initializeWithTrustOptions)."""
        lb = await self.primary.light_block(self.trust.height)
        if lb.header.hash() != self.trust.header_hash:
            raise LightClientError(
                "primary's header at trust height does not match the "
                "trusted hash")
        err = lb.validate_basic(self.chain_id, self.device)
        if err:
            raise LightClientError(f"invalid trust anchor: {err}")
        self._save(lb)
        return lb

    def latest_trusted(self) -> LightBlock | None:
        return self.store.latest()

    # ------------------------------------------------------------ verify

    async def verify_light_block_at_height(self, height: int,
                                           now_ns: int | None = None
                                           ) -> LightBlock:
        """light/client.go:470 VerifyLightBlockAtHeight."""
        now_ns = now_ns if now_ns is not None else self.now_ns()
        got = self.store.get(height)
        if got is not None:
            return got
        trusted = self.store.latest()
        if trusted is None:
            trusted = await self.initialize()
        if height <= trusted.height:
            return await self._verify_backwards_or_fetch(height, trusted,
                                                         now_ns)
        target = await self.primary.light_block(height)
        verified = await self._verify_light_block(trusted, target, now_ns)
        # cross-check BEFORE anything is persisted: a divergent target must
        # never enter the trusted store (it would short-circuit future
        # calls via the cache above and skew the detector's common height).
        # The verification trace (trusted root + every newly verified
        # block, ascending) lets the detector walk to the true fork height.
        await self._cross_check(target, now_ns,
                                trace=[trusted] + sorted(
                                    verified, key=lambda b: b.height))
        for lb in verified:
            self.store.save(lb)
        if self.pruning_size:        # one pass after the batch, not per save
            self.store.prune(self.pruning_size)
        return target

    async def update(self, now_ns: int | None = None) -> LightBlock | None:
        """Verify the primary's latest header (light/client.go:432)."""
        now_ns = now_ns if now_ns is not None else self.now_ns()
        latest = await self.primary.light_block(0)
        trusted = self.store.latest()
        if trusted is not None and latest.height <= trusted.height:
            return trusted
        return await self.verify_light_block_at_height(latest.height,
                                                       now_ns)

    async def _verify_light_block(self, trusted: LightBlock,
                                  target: LightBlock,
                                  now_ns: int) -> list[LightBlock]:
        """Returns the newly verified blocks WITHOUT persisting them — the
        caller saves only after the witness cross-check passes."""
        if self.mode == SEQUENTIAL:
            return await self._verify_sequential(trusted, target, now_ns)
        return await self._verify_skipping(trusted, target, now_ns)

    async def _verify_sequential(self, trusted: LightBlock,
                                 target: LightBlock,
                                 now_ns: int) -> list[LightBlock]:
        """Fetch every intermediate header and prove them in batched
        device calls (client.go:609 verifySequential)."""
        chain = []
        for h in range(trusted.height + 1, target.height):
            chain.append(await self.primary.light_block(h))
        chain.append(target)
        verify_sequential_batched(self.chain_id, trusted, chain,
                                  self.trust.period_ns, now_ns,
                                  self.max_clock_drift_ns, self.device)
        return chain

    async def _verify_skipping(self, trusted: LightBlock,
                               target: LightBlock,
                               now_ns: int) -> list[LightBlock]:
        """client.go:702 verifySkipping: try the jump; on
        ErrNewValSetCantBeTrusted bisect down until it verifies, then
        continue up from the new pivot."""
        verified = []
        pivots = [target]
        cur = trusted
        while pivots:
            candidate = pivots[-1]
            try:
                verify_non_adjacent(self.chain_id, cur, candidate,
                                    self.trust.period_ns, now_ns,
                                    self.trust_level,
                                    self.max_clock_drift_ns, self.device)
            except ErrNewValSetCantBeTrusted:
                mid = (cur.height + candidate.height) // 2
                if mid in (cur.height, candidate.height):
                    raise LightClientError(
                        "bisection exhausted: adjacent header unverifiable")
                pivots.append(await self.primary.light_block(mid))
                continue
            verified.append(candidate)
            cur = candidate
            pivots.pop()
        return verified

    async def _verify_backwards_or_fetch(self, height: int,
                                         trusted: LightBlock,
                                         now_ns: int) -> LightBlock:
        """Historic header below the trusted head: fetch and hash-link
        backwards (client.go backwards)."""
        lb = await self.primary.light_block(height)
        err = lb.validate_basic(self.chain_id, self.device)
        if err:
            raise LightClientError(f"invalid historic header: {err}")
        # walk back from the closest trusted block above
        cur = trusted
        while cur.height > height + 1:
            prev = await self.primary.light_block(cur.height - 1)
            if cur.header.last_block_id.hash != prev.header.hash():
                raise LightClientError(
                    f"hash chain break at height {prev.height}")
            cur = prev
        if cur.header.last_block_id.hash != lb.header.hash():
            raise LightClientError(
                f"historic header {height} not linked to trusted chain")
        # no prune here: a backwards-verified HISTORIC block is the oldest
        # key by construction — pruning would delete it immediately and
        # the cache would never help repeat historic queries
        self.store.save(lb)
        return lb

    # ---------------------------------------------------------- detector

    async def _cross_check(self, lb: LightBlock, now_ns: int,
                           trace: list[LightBlock] | None = None) -> None:
        if self.witnesses:
            await detect_divergence(self, lb, now_ns, trace=trace)
