"""Light-client serving tier (counterpart of ``cometbft_tpu/light/
serve.py``): one full node answering a fleet of skipping light clients
("Practical Light Clients for Committee-Based Blockchains", PAPERS.md).
The producer side of the light client, on three pieces:

- the per-level merkle node cache (``crypto/merkle.TreeCache``): each
  block's tx or validator tree is built once and every later proof
  request is index arithmetic, with no re-hashing.  A tree of 2,048
  leaves or more (the validator tree of a 10,000-validator set) is one
  ``merkle_tree_leaves`` kernel call on the tier's ``device``;
- an LRU of signed headers, canonical commits and validator sets keyed
  by the trusting period: an entry whose header leaves the window is
  evicted on sight; repeated ``light_block(height)`` requests inside it
  hit memory, their JSON projection already made;
- batched verification of client-supplied trust anchors: every anchor
  of one validator set goes through one ``verify_commits_light_batched(
  ..., patient=True, use_cache=True)`` call (the RLC verdict over all
  their lanes, K5b naming a bad lane), riding the verification
  scheduler's verified-signature cache where one is registered; a
  whole-commit verdict memo answers an identical anchor from a dict
  (positive verdicts only: a bad commit re-verifies every time).

Every method is synchronous and thread-safe (one lock around the caches,
a per-key latch so that a tree or an entry is built once under a storm):
the RPC routes run them in worker threads.  Whatever such a thread sends
to the card (a verify, a tree of 2,048 leaves or more, the hash of such a
validator set) goes through ``crypto/batch.py:device_call``, queued on
the device-owner thread behind the consensus scheduler's batches: never
a second stream of CUDA calls from an arbitrary thread, and never a host
verify.  The JAX package's ``backend=`` is ``device=`` here: ``"cuda"``
(or None, the plan's first device) raises without a card, ``"cpu"`` runs
the kernels' plain versions.
"""

from __future__ import annotations

import functools
import hashlib
import json
import threading
import time

from ..crypto import batch as cryptobatch
from ..crypto import merkle
from ..crypto import plan as _plan
from ..libs import metrics
from ..rpc.json import from_jsonable, jsonable
from ..types.commit import Commit
from ..types.header import tx_hash as _tx_hash
from ..types.validation import (ErrBatchItemInvalid, ErrInvalidSignature,
                                verify_commits_light_batched)

__all__ = ["LightServeTier", "LightServeError", "LightServeRequestError",
           "PROOF_KINDS"]

NS = 1_000_000_000

PROOF_KINDS = ("tx", "validator")


class LightServeError(Exception):
    """Serving-tier failure surfaced to the RPC layer; ``code`` follows
    JSON-RPC (-32602 invalid request, -32603 internal/not-found)."""

    code = -32603


class LightServeRequestError(LightServeError):
    code = -32602


@functools.cache
def _ls_metrics():
    """Registered once (libs.metrics dedups by name)."""
    return (
        metrics.counter(
            "lightserve_proofs_served_total",
            "merkle inclusion proofs served by the light-serving tier, "
            "by leaf kind"),
        metrics.counter(
            "lightserve_light_blocks_served_total",
            "light blocks (header+commit+valset) served"),
        metrics.counter(
            "lightserve_cache_hits_total",
            "light-serve cache hits, by cache (header/proof/verify)"),
        metrics.counter(
            "lightserve_cache_misses_total",
            "light-serve cache misses, by cache"),
        metrics.counter(
            "lightserve_cache_evictions_total",
            "light-serve cache evictions, by cache and reason "
            "(lru/trust_period)"),
        metrics.counter(
            "lightserve_anchors_verified_total",
            "client-supplied trust anchors verified, by verdict "
            "(ok/bad/cached)"),
        metrics.histogram(
            "lightserve_request_seconds",
            "serving-tier request latency, by route (the p99 surface)"),
        metrics.gauge(
            "lightserve_header_cache_entries",
            "entries in the header/commit/valset LRU"),
        metrics.gauge(
            "lightserve_proof_cache_entries",
            "per-block proof trees retained ((height, kind) entries)"),
    )


class _LRU:
    """Insertion-ordered LRU (dict ordering) with an optional byte
    budget: a 10,000-validator light-block entry runs megabytes of commit
    and set JSON, so counting entries alone would let the header cache
    eat gigabytes.  Not thread-safe: the tier holds its lock."""

    __slots__ = ("max_size", "max_bytes", "d", "sizes", "bytes")

    def __init__(self, max_size: int, max_bytes: int = 0):
        self.max_size = max(0, int(max_size))
        self.max_bytes = max(0, int(max_bytes))
        self.d: dict = {}
        self.sizes: dict = {}
        self.bytes = 0

    def __len__(self) -> int:
        return len(self.d)

    def get(self, key):
        v = self.d.get(key)
        if v is not None:                      # move-to-end refresh
            del self.d[key]
            self.d[key] = v
        return v

    def pop(self, key) -> None:
        if key in self.d:
            del self.d[key]
            self.bytes -= self.sizes.pop(key, 0)

    def put(self, key, value, nbytes: int = 0) -> int:
        """Insert; returns how many entries were LRU-evicted (count cap
        or byte budget)."""
        if self.max_size == 0:
            return 0
        self.pop(key)
        self.d[key] = value
        self.sizes[key] = nbytes
        self.bytes += nbytes
        n = 0
        while len(self.d) > self.max_size or \
                (self.max_bytes and self.bytes > self.max_bytes
                 and len(self.d) > 1):
            oldest = next(iter(self.d))
            del self.d[oldest]
            self.bytes -= self.sizes.pop(oldest, 0)
            n += 1
        return n


class LightServeTier:
    """The node-side serving tier; constructed by ``Node.create`` and
    read by the ``light_*`` RPC routes (``rpc/core.py``).  ``device`` is
    where anchors are verified and large trees built (module
    docstring); it raises here without a card unless it is ``"cpu"``."""

    def __init__(self, block_store, state_store, chain_id: str, *,
                 device=None,
                 header_cache_size: int = 4096,
                 header_cache_bytes: int = 256 * 1024 * 1024,
                 proof_cache_blocks: int = 64,
                 verify_cache_size: int = 4096,
                 trust_period_ns: int = 168 * 3600 * NS,
                 max_batch: int = 128,
                 max_proofs: int = 4096,
                 now_ns=time.time_ns,
                 name: str = "node"):
        self.block_store = block_store
        self.state_store = state_store
        self.chain_id = chain_id
        _plan.resolve_devices(device)          # raises without a card
        self.device = device
        self.trust_period_ns = int(trust_period_ns)
        self.max_batch = max(1, int(max_batch))
        self.max_proofs = max(1, int(max_proofs))
        self.now_ns = now_ns
        self.name = name
        # RLock: tally/evict helpers take the lock themselves and are
        # also called from sections that already hold it
        self._lock = threading.RLock()
        self._headers = _LRU(header_cache_size,   # height -> entry dict
                             header_cache_bytes)
        self._trees = _LRU(proof_cache_blocks)    # (height, kind) -> TreeCache
        self._verify_memo = _LRU(verify_cache_size)  # (h, sha256) -> True
        self._valsets = _LRU(64)                  # height -> [set, hash]
        self._valset_json = _LRU(16)              # valset hash -> jsonable
        self._building: dict = {}                 # build-latch key -> Event
        m = _ls_metrics()
        self._m_proofs = {k: m[0].bind(kind=k) for k in PROOF_KINDS}
        self._m_blocks = m[1].bind()
        self._m_hit = {c: m[2].bind(cache=c)
                       for c in ("header", "proof", "verify")}
        self._m_miss = {c: m[3].bind(cache=c)
                        for c in ("header", "proof", "verify")}
        self._m_evict = m[4]
        self._m_anchor = {v: m[5].bind(verdict=v)
                          for v in ("ok", "bad", "cached")}
        self._m_lat = {r: m[6].bind(route=r)
                       for r in ("light_block", "light_blocks",
                                 "light_proofs", "light_verify")}
        self._g_headers = m[7].bind()
        self._g_trees = m[8].bind()
        # per-instance tallies for stats()/bench (the Prometheus registry
        # is process-global and outlives instances)
        self._t = {"blocks_served": 0, "proofs_served": 0,
                   "header_hits": 0, "header_misses": 0,
                   "proof_hits": 0, "proof_misses": 0,
                   "verify_hits": 0, "verify_misses": 0,
                   "evictions_lru": 0, "evictions_trust_period": 0,
                   "anchors_ok": 0, "anchors_bad": 0}

    # ----------------------------------------------------------- internals

    def _big(self, n: int) -> bool:
        return n >= merkle.MERKLE_KERNEL_MIN_LEAVES

    def _expired(self, time_ns: int) -> bool:
        return time_ns + self.trust_period_ns <= self.now_ns()

    def _tally(self, name: str, n: int = 1) -> None:
        """Per-instance counter bump under the lock — the tier is hit
        from many worker threads, and an unlocked += loses updates."""
        with self._lock:
            self._t[name] += n

    def _evict(self, cache: str, reason: str, n: int = 1) -> None:
        if n:
            self._m_evict.inc(n, cache=cache, reason=reason)
            self._tally(f"evictions_{reason}", n)

    def _resolve_height(self, height) -> int:
        bs = self.block_store
        if height in (None, 0, "0", ""):
            h = bs.height()
            if h == 0:
                raise LightServeError("empty block store")
            return h
        try:
            h = int(height)
        except (TypeError, ValueError):
            raise LightServeRequestError(f"bad height {height!r}") from None
        if h < bs.base() or h > bs.height():
            raise LightServeError(
                f"height {h} is not available (base {bs.base()}, "
                f"height {bs.height()})")
        return h

    def _valset_entry(self, height: int, vals=None) -> list:
        """The cached ``[set, hash or None]`` of ``height``, loaded (or
        given as ``vals``) on a miss."""
        with self._lock:
            ent = self._valsets.get(height)
        if ent is not None:
            return ent
        if vals is None:
            vals = self.state_store.load_validators(height)
        if vals is None:
            raise LightServeError(f"no validator set at height {height}")
        ent = [vals, None]
        with self._lock:
            self._valsets.put(height, ent)
        return ent

    def _valset(self, height: int):
        return self._valset_entry(height)[0]

    def _valset_hash(self, height: int, vals=None) -> tuple:
        """(the set at ``height``, its hash), the hash computed once: for
        a set of 2,048 validators or more it is a tree kernel call, on
        the device-owner thread."""
        ent = self._valset_entry(height, vals)
        if ent[1] is None:
            vals = ent[0]
            if self._big(vals.size()):
                ent[1] = cryptobatch.device_call(
                    lambda: vals.hash(device=self.device))
            else:
                ent[1] = vals.hash()
        return ent[0], ent[1]

    # --------------------------------------------------------- light blocks

    def _load_entry(self, h: int) -> dict:
        """Blockstore path: build + serialize one light-block entry."""
        block = self.block_store.load_block(h)
        commit = self.block_store.load_block_commit(h)
        canonical = True
        if commit is None:
            seen = self.block_store.load_seen_commit()
            if seen is not None and seen.height == h:
                commit, canonical = seen, False
        vals = self.state_store.load_validators(h)
        if block is None or commit is None or vals is None:
            raise LightServeError(f"no light block at height {h}")
        vals, vh = self._valset_hash(h, vals)
        with self._lock:
            vals_json = self._valset_json.get(vh)
        if vals_json is None:
            # one serialized set shared by every height of that set (at
            # 10,000 validators its JSON runs about 1 MB)
            vals_json = jsonable(vals)
            with self._lock:
                self._valset_json.put(vh, vals_json)
        return {
            "height": h,
            "canonical": canonical,
            "time_ns": block.header.time_ns,
            # rough retained-size estimate for the byte budget: commit
            # sigs dominate (~200 B of JSON each); aggregate lanes carry
            # no per-lane signature (~70 B addr+ts) and the one shared
            # aggregate+bitmap is ~300 B; the shared valset dict is
            # accounted once in its own small LRU
            "bytes": 2048
            + sum(70 if cs.is_aggregate() else 200
                  for cs in commit.signatures)
            + (300 if commit.agg_signature else 0),
            "light_block": {
                "header": jsonable(block.header),
                "commit": jsonable(commit),
                "validators": vals_json,
                "total_voting_power": vals.total_voting_power(),
            },
        }

    def _cached_entry(self, h: int) -> dict | None:
        """Header-LRU consult under the lock, applying the freshness
        rules (trust-period window, seen-commit superseded by a
        canonical commit).  Counts the hit; misses are counted by the
        builder."""
        tip = self.block_store.height()
        with self._lock:
            ent = self._headers.get(h)
            if ent is not None and self._expired(ent["time_ns"]):
                # trust-period window: a header that can no longer anchor
                # a skipping client stops earning its slot
                self._headers.pop(h)
                self._evict("header", "trust_period")
                self._g_headers.set(len(self._headers))
                ent = None
            if ent is not None and not ent["canonical"] and h < tip:
                # the seen-commit answer got superseded by a canonical
                # commit (next block landed): refresh from the store
                self._headers.pop(h)
                ent = None
            if ent is not None:
                self._m_hit["header"].inc()
                self._tally("header_hits")
        return ent

    def _light_block_entry(self, height) -> dict:
        h = self._resolve_height(height)
        key = ("hdr", h)
        while True:
            ent = self._cached_entry(h)
            if ent is not None:
                self._m_blocks.inc()
                self._tally("blocks_served")
                return ent
            with self._lock:
                ev = self._building.get(key)
                if ev is None:
                    self._building[key] = threading.Event()
                    break                      # we are the builder
            # a concurrent storm on a cold height (the fresh tip, a hot
            # bootstrap anchor) must build + serialize the entry ONCE —
            # followers wait for the builder, then re-read the cache
            ev.wait(timeout=30.0)
        try:
            self._m_miss["header"].inc()
            self._tally("header_misses")
            ent = self._load_entry(h)
            if not self._expired(ent["time_ns"]):
                with self._lock:
                    self._evict("header", "lru",
                                self._headers.put(h, ent, ent["bytes"]))
                    self._g_headers.set(len(self._headers))
            self._m_blocks.inc()
            self._tally("blocks_served")
            return ent
        finally:
            with self._lock:
                ev = self._building.pop(key, None)
            if ev is not None:
                ev.set()

    def light_block(self, height=None) -> dict:
        """One signed header + commit + validator set, cache-served."""
        t0 = time.perf_counter()
        try:
            ent = self._light_block_entry(height)
            return {"height": ent["height"], "canonical": ent["canonical"],
                    "light_block": ent["light_block"]}
        finally:
            self._m_lat["light_block"].observe(time.perf_counter() - t0)

    def light_blocks(self, heights) -> dict:
        """Batched bootstrap: many light blocks in ONE request.  Missing
        heights come back as per-item errors — a fleet bootstrap must not
        fail wholesale because one height was pruned."""
        t0 = time.perf_counter()
        try:
            hs = _as_int_list(heights, "heights")
            if not hs:
                raise LightServeRequestError("heights must be non-empty")
            if len(hs) > self.max_batch:
                raise LightServeRequestError(
                    f"{len(hs)} heights > lightserve.max_batch "
                    f"({self.max_batch})")
            out = []
            for h in hs:
                try:
                    ent = self._light_block_entry(h)
                    out.append({"height": ent["height"],
                                "canonical": ent["canonical"],
                                "light_block": ent["light_block"]})
                except LightServeError as e:
                    out.append({"height": h, "error": str(e)})
            return {"light_blocks": out,
                    "base": self.block_store.base(),
                    "latest": self.block_store.height()}
        finally:
            self._m_lat["light_blocks"].observe(time.perf_counter() - t0)

    # --------------------------------------------------------------- proofs

    def _leaves(self, h: int, kind: str) -> list[bytes]:
        if kind == "tx":
            block = self.block_store.load_block(h)
            if block is None:
                raise LightServeError(f"no block at height {h}")
            return [_tx_hash(t) for t in block.data.txs]
        if kind == "validator":
            return [v.simple_encode() for v in self._valset(h).validators]
        raise LightServeRequestError(
            f"unknown proof kind {kind!r} (expected one of {PROOF_KINDS})")

    def _tree(self, h: int, kind: str) -> merkle.TreeCache:
        """(height, kind) tree through the LRU, built at most once even
        under a concurrent storm (per-key build dedup: followers wait for
        the builder rather than burning a duplicate build)."""
        key = (h, kind)
        while True:
            with self._lock:
                tree = self._trees.get(key)
                if tree is not None:
                    self._m_hit["proof"].inc()
                    self._tally("proof_hits")
                    return tree
                ev = self._building.get(key)
                if ev is None:
                    self._building[key] = threading.Event()
                    break                      # we are the builder
            ev.wait(timeout=30.0)
            with self._lock:
                tree = self._trees.get(key)
            if tree is not None:
                self._m_hit["proof"].inc()
                self._tally("proof_hits")
                return tree
            # builder failed (missing block, ...): fall through and try
            # to build it ourselves — the same error will surface here
        try:
            self._m_miss["proof"].inc()
            self._tally("proof_misses")
            leaves = self._leaves(h, kind)
            if self._big(len(leaves)):
                tree = cryptobatch.device_call(lambda: merkle.TreeCache.build(
                    leaves, device=self.device))
            else:
                tree = merkle.TreeCache.build(leaves)
            with self._lock:
                self._evict("proof", "lru", self._trees.put(key, tree))
                self._g_trees.set(len(self._trees))
            return tree
        finally:
            with self._lock:
                ev = self._building.pop(key, None)
            if ev is not None:
                ev.set()

    def proofs(self, height=None, kind: str = "tx", indexes=None) -> dict:
        """Batched inclusion proofs for one block: the per-level node
        cache is built once, every requested index is gathered out of it.
        ``indexes=None`` serves every leaf (bounded by max_proofs)."""
        t0 = time.perf_counter()
        try:
            if kind not in PROOF_KINDS:
                raise LightServeRequestError(
                    f"unknown proof kind {kind!r} "
                    f"(expected one of {PROOF_KINDS})")
            h = self._resolve_height(height)
            tree = self._tree(h, kind)
            total = tree.total
            if indexes is None:
                if total > self.max_proofs:
                    raise LightServeRequestError(
                        f"{total} leaves > lightserve.max_proofs "
                        f"({self.max_proofs}); pass explicit indexes")
                idxs = list(range(total))
            else:
                idxs = _as_int_list(indexes, "indexes")
                if len(idxs) > self.max_proofs:
                    raise LightServeRequestError(
                        f"{len(idxs)} indexes > lightserve.max_proofs "
                        f"({self.max_proofs})")
                bad = [i for i in idxs if not 0 <= i < total]
                if bad:
                    raise LightServeRequestError(
                        f"leaf index {bad[0]} out of range "
                        f"(total {total})")
            proofs = tree.proofs(idxs)
            self._m_proofs[kind].inc(len(proofs))
            self._tally("proofs_served", len(proofs))
            return {
                "height": h,
                "kind": kind,
                "total": total,
                "root": tree.root.hex(),
                "proofs": [{"total": p.total, "index": p.index,
                            "leaf_hash": p.leaf_hash.hex(),
                            "aunts": [a.hex() for a in p.aunts]}
                           for p in proofs],
            }
        finally:
            self._m_lat["light_proofs"].observe(time.perf_counter() - t0)

    # ----------------------------------------------------- anchor verification

    @staticmethod
    def _anchor_key(height: int, commit_json) -> tuple:
        """Whole-commit verdict memo key: height + a digest of the RAW
        JSON form — a hot anchor hits before it is even deserialized."""
        raw = json.dumps(commit_json, sort_keys=True,
                         separators=(",", ":")).encode()
        return (height, hashlib.sha256(raw).digest())

    def verify_commits(self, anchors) -> dict:
        """Batched server-side verification of client-supplied trust
        anchors: each anchor is ``{"height": h, "commit": <jsonable>}``.
        The server attests per anchor that the commit is a valid > 2/3
        commit OF ITS OWN CHAIN's block at that height.  Same-valset runs
        verify in single batched dispatches
        (``verify_commits_light_batched`` with the verified-signature cache), and
        identical hot anchors hit a whole-commit verdict memo (positive
        verdicts only — a bad commit re-verifies every time)."""
        t0 = time.perf_counter()
        try:
            return self._verify_commits(anchors)
        finally:
            self._m_lat["light_verify"].observe(time.perf_counter() - t0)

    def _verify_commits(self, anchors) -> dict:
        if not isinstance(anchors, list) or not anchors:
            raise LightServeRequestError("anchors must be a non-empty list")
        if len(anchors) > self.max_batch:
            raise LightServeRequestError(
                f"{len(anchors)} anchors > lightserve.max_batch "
                f"({self.max_batch})")
        results: list[dict | None] = [None] * len(anchors)
        pending: list[tuple[int, int, object]] = []   # (slot, height, commit)
        keys: dict[int, tuple] = {}
        for slot, a in enumerate(anchors):
            if not isinstance(a, dict) or "height" not in a \
                    or "commit" not in a:
                raise LightServeRequestError(
                    f"anchor #{slot} must be {{height, commit}}")
            try:
                h = self._resolve_height(a["height"])
            except LightServeError as e:
                results[slot] = {"height": a.get("height"), "ok": False,
                                 "error": str(e)}
                self._m_anchor["bad"].inc()
                self._tally("anchors_bad")
                continue
            key = self._anchor_key(h, a["commit"])
            with self._lock:
                hit = self._verify_memo.get(key) is not None
            if hit:
                self._m_hit["verify"].inc()
                self._tally("verify_hits")
                self._m_anchor["cached"].inc()
                self._tally("anchors_ok")
                results[slot] = {"height": h, "ok": True, "cached": True}
                continue
            self._m_miss["verify"].inc()
            self._tally("verify_misses")
            try:
                commit = from_jsonable(a["commit"])
            except Exception as e:
                results[slot] = {"height": h, "ok": False,
                                 "error": f"undecodable commit: {e}"}
                self._m_anchor["bad"].inc()
                self._tally("anchors_bad")
                continue
            err = self._check_anchor_shape(h, commit)
            if err is not None:
                results[slot] = {"height": h, "ok": False, "error": err}
                self._m_anchor["bad"].inc()
                self._tally("anchors_bad")
                continue
            keys[slot] = key
            pending.append((slot, h, commit))
        # group by validator set and verify each group in batched
        # dispatches, demuxing per-item failures
        groups: dict[bytes, list] = {}
        for slot, h, commit in pending:
            try:
                vals, vh = self._valset_hash(h)
            except LightServeError as e:
                results[slot] = {"height": h, "ok": False, "error": str(e)}
                self._m_anchor["bad"].inc()
                self._tally("anchors_bad")
                continue
            if vh not in groups:
                groups[vh] = ([], vals)
            groups[vh][0].append((slot, h, commit))
        for _vh, (members, vals) in groups.items():
            self._verify_group(vals, members, results, keys)
        n_ok = sum(1 for r in results if r and r.get("ok"))
        return {"results": results, "ok": n_ok,
                "failed": len(results) - n_ok}

    def _check_anchor_shape(self, h: int, commit) -> str | None:
        """Pre-verification shape checks: the commit must BE a commit
        (the codec decodes any registered type — a Vote-shaped payload
        must fail here, not as an AttributeError mid-batch) and claim
        exactly our chain's block at that height."""
        if not isinstance(commit, Commit):
            return f"anchor commit is a {type(commit).__name__}, " \
                   "not a Commit"
        err = commit.validate_basic()
        if err:
            return f"invalid commit: {err}"
        if getattr(commit, "height", None) != h:
            return (f"commit height {getattr(commit, 'height', None)} "
                    f"!= anchor height {h}")
        meta = self.block_store.load_block_meta(h)
        if meta is None:
            return f"no block meta at height {h}"
        if commit.block_id.hash != meta.block_id.hash:
            return "commit signs a different block than this chain's"
        return None

    def _verify_group(self, vals, members: list, results: list,
                      keys: dict) -> None:
        """One same-valset run through the batched verifier; on a bad
        item, record its verdict and re-batch the remainder (the demux
        contract: an ErrInvalidSignature cause proves every EARLIER item;
        any other cause proves nothing about them)."""
        todo = list(members)
        while todo:
            items = [(c.block_id, h, c) for _s, h, c in todo]
            try:
                verify_commits_light_batched(
                    self.chain_id, vals, items, device=self.device,
                    patient=True, use_cache=True)
            except ErrBatchItemInvalid as e:
                bad_slot, bad_h, _c = todo[e.item]
                results[bad_slot] = {"height": bad_h, "ok": False,
                                     "error": str(e.cause)}
                self._m_anchor["bad"].inc()
                self._tally("anchors_bad")
                if isinstance(e.cause, ErrInvalidSignature):
                    # every earlier item's lanes are proven valid
                    for s, h, _c2 in todo[:e.item]:
                        self._record_ok(s, h, results, keys)
                    todo = todo[e.item + 1:]
                else:
                    # pre-dispatch failure: earlier items unproven
                    todo = todo[:e.item] + todo[e.item + 1:]
                continue
            for s, h, _c in todo:
                self._record_ok(s, h, results, keys)
            return

    def _record_ok(self, slot: int, h: int, results: list,
                   keys: dict) -> None:
        results[slot] = {"height": h, "ok": True, "cached": False}
        self._m_anchor["ok"].inc()
        self._tally("anchors_ok")
        key = keys.get(slot)
        if key is not None:
            with self._lock:
                self._verify_memo.put(key, True)

    # -------------------------------------------------------------- surface

    def stats(self) -> dict:
        """Operator surface (/status light_serve block, bench, tests)."""
        with self._lock:
            out = dict(self._t)
            out["header_cache_entries"] = len(self._headers)
            out["header_cache_bytes"] = self._headers.bytes
            out["proof_cache_entries"] = len(self._trees)
            out["verify_memo_entries"] = len(self._verify_memo)
        return out


def _as_int_list(v, what: str) -> list[int]:
    """Accept a JSON list of ints, a comma-separated string (URI-style
    GET can't carry arrays), or a bare int."""
    if isinstance(v, int):
        v = [v]
    if isinstance(v, str):
        v = [p for p in v.split(",") if p.strip()]
    if not isinstance(v, list):
        raise LightServeRequestError(f"{what} must be a list")
    try:
        return [int(x) for x in v]
    except (TypeError, ValueError):
        raise LightServeRequestError(
            f"{what} must contain only integers") from None
