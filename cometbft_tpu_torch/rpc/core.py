"""RPC core routes (counterpart of ``cometbft_tpu/rpc/core.py``;
reference: ``rpc/core/routes.go:15-62`` and the handler files
``rpc/core/{status,blocks,mempool,consensus,abci,net,evidence}.go``).

``Environment`` carries the node internals every handler reads
(``rpc/core/env.go``); ``ROUTES`` maps method name -> handler coroutine.
Handlers return plain JSON-able dicts (domain objects projected through
``rpc.json.jsonable``, equal to the JAX package's).  A route's
docstring is its ``/openapi`` summary, kept as the JAX package's.  The light routes run
the serving tier (``light/serve.py``) in worker threads, whose device
work queues on the device-owner thread.  ``consensus_timeline`` folds
the flight recorder (``libs/timeline.py``); ``dump_incidents`` lists the
liveness watchdog's bundles (``node/watchdog.py``)."""

from __future__ import annotations

import asyncio
import base64
import json as _json

from ..crypto import merkle
from ..libs import aio, tracing
from ..libs import log as tmlog
from ..libs.metrics import counter as _counter
from ..libs.query import QuerySyntaxError
from ..mempool.clist_mempool import TxRejectedError
from ..mempool.mempool import TxKey
from ..sm.execution import unpack_finalize_response
from ..types import events as ev
from ..types.evidence import EvidenceError
from ..types.header import tx_hash as _txh
from .json import from_jsonable, jsonable

__all__ = ["RPCError", "Environment", "ROUTES", "UNSAFE_ROUTES",
           "paginate_validators"]


class RPCError(Exception):
    def __init__(self, code: int, message: str, data: str = ""):
        self.code = code
        self.data = data
        super().__init__(message)
        self.message = message


class Environment:
    """rpc/core/env.go Environment: what routes need from the node."""

    def __init__(self, node):
        self.node = node
        self._gen_chunks: list[bytes] | None = None   # computed once

    @property
    def block_store(self):
        return self.node.block_store

    @property
    def state_store(self):
        return self.node.state_store


def _height_or_latest(env: Environment, height) -> int:
    if height in (None, 0, "0", ""):
        return env.block_store.height()
    h = int(height)
    if h < env.block_store.base() or h > env.block_store.height():
        raise RPCError(-32603, f"height {h} is not available "
                       f"(base {env.block_store.base()}, "
                       f"height {env.block_store.height()})")
    return h


# ------------------------------------------------------------------ info

async def health(env: Environment) -> dict:
    return {}


async def status(env: Environment) -> dict:
    """rpc/core/status.go Status, enriched with a live consensus-timeline
    block: current height/round/step plus how long the node has sat in
    that step and since its last commit (the flight-recorder's "is this
    node stuck RIGHT NOW" surface — see /dump_trace for the history)."""
    node = env.node
    h = env.block_store.height()
    meta = env.block_store.load_block_meta(h) if h else None
    pv = node.consensus.priv_validator if node.consensus else None
    consensus_info = None
    cs = node.consensus
    if cs:
        last_wall = getattr(cs, "_last_commit_wall_ns", 0)
        # the age comes from the clock that stamped the commit
        consensus_info = {
            "height": cs.rs.height,
            "round": cs.rs.round,
            "step": cs.rs.step_name(),
            "step_age_s": round(cs.step_age_s(), 6),
            "last_commit_age_s": (
                round(max(cs.now_ns() - last_wall, 0) / 1e9, 6)
                if last_wall else None),
            "fatal_error": repr(cs.fatal_error) if cs.fatal_error else None,
        }
    return {
        "node_info": {
            "id": node.node_key.id if node.node_key else "",
            "listen_addr": node.listen_addr or "",
            "network": node.genesis.chain_id,
            "moniker": node.name,
        },
        "sync_info": {
            "latest_block_height": h,
            "latest_block_hash": meta.block_id.hash.hex() if meta else "",
            "latest_block_time_ns":
                env.block_store.load_block(h).header.time_ns if h else 0,
            "earliest_block_height": env.block_store.base(),
            "catching_up": not (node.blocksync_reactor is None
                                or node.blocksync_reactor.synced.is_set()),
        },
        "validator_info": {
            "address": pv.get_pub_key().address().hex() if pv else "",
            "pub_key": pv.get_pub_key().bytes().hex() if pv else "",
        },
        "consensus_info": consensus_info,
        # the storage doctor's boot report (node/doctor.py) and the
        # kernel bundle's state from the warm boot (crypto/aotbundle.py;
        # None with base.device_warmup off)
        "doctor": (node.doctor_report.to_dict()
                   if getattr(node, "doctor_report", None) is not None
                   else None),
        "compile_bundle": getattr(node, "compile_bundle_info", None),
        # the light-serving tier's tallies (light/serve.py)
        "light_serve": (node.light_serve.stats()
                        if getattr(node, "light_serve", None) is not None
                        else None),
    }


async def net_info(env: Environment) -> dict:
    """rpc/core/net.go NetInfo, enriched with the live per-peer
    telemetry the p2p layer now keeps: per-channel bytes/msgs in both
    directions, send-queue depth/capacity and queue-full drops, the
    flowrate send/recv EMAs, last ping RTT, connection age, and the
    gossip useful/duplicate efficiency — so a bad gossip partner or a
    backpressured channel is visible from one curl, not a Prometheus
    deployment."""
    sw = env.node.switch
    peers = []
    if sw is not None and getattr(sw, "peer_snapshot", None) is not None:
        peers = sw.peer_snapshot()
    n_outbound = sum(1 for p in peers if p.get("outbound"))
    scorer = getattr(sw, "scorer", None)
    bans = scorer.bans_snapshot() if scorer is not None else []
    return {"listening": env.node.listen_addr is not None,
            "listen_addr": env.node.listen_addr or "",
            "n_peers": len(peers),
            "n_outbound": n_outbound,
            "n_inbound": len(peers) - n_outbound,
            "peers": peers,
            "bans": bans}


_GENESIS_CHUNK_SIZE = 16 * 1024 * 1024   # rpc/core/env.go:32


async def genesis(env: Environment) -> dict:
    def _build():
        # off the event loop: at the 16 MB ceiling the dump stalls it
        raw = env.node.genesis.to_json()
        if len(raw.encode()) > _GENESIS_CHUNK_SIZE:
            return None
        return _json.loads(raw)

    doc = await asyncio.to_thread(_build)
    if doc is None:
        raise RPCError(-32603, "genesis response is large, please use the "
                       "genesis_chunked API instead")
    return {"genesis": doc}


async def genesis_chunked(env: Environment, chunk=0) -> dict:
    """rpc/core/net.go:111 GenesisChunked: base64 16MB slices of the
    genesis JSON, so arbitrarily large app_state stays servable.  The
    chunk list is computed once (the genesis doc is immutable)."""
    if env._gen_chunks is None:
        raw = env.node.genesis.to_json().encode()
        env._gen_chunks = [raw[i:i + _GENESIS_CHUNK_SIZE]
                           for i in range(0, len(raw),
                                          _GENESIS_CHUNK_SIZE)] or [b""]
    chunks = env._gen_chunks
    cid = int(chunk)
    if not 0 <= cid < len(chunks):
        raise RPCError(-32603, f"there are {len(chunks) - 1} chunks, "
                       f"{cid} is invalid")
    return {"chunk": cid, "total": len(chunks),
            "data": base64.b64encode(chunks[cid]).decode()}


# ---------------------------------------------------------------- blocks

async def block(env: Environment, height=None) -> dict:
    h = _height_or_latest(env, height)
    blk = env.block_store.load_block(h)
    meta = env.block_store.load_block_meta(h)
    if blk is None:
        raise RPCError(-32603, f"no block at height {h}")
    return {"block_id": jsonable(meta.block_id), "block": jsonable(blk)}


def _height_by_hash(env: Environment, hash) -> int:
    if hash is None:
        raise RPCError(-32602, "missing block hash")
    want = bytes.fromhex(hash) if isinstance(hash, str) else bytes(hash)
    bs = env.block_store
    for h in range(bs.height(), bs.base() - 1, -1):
        meta = bs.load_block_meta(h)
        if meta is not None and meta.block_id.hash == want:
            return h
    raise RPCError(-32603, f"block with hash {want.hex()} not found")


async def block_by_hash(env: Environment, hash=None) -> dict:
    return await block(env, _height_by_hash(env, hash))


async def header(env: Environment, height=None) -> dict:
    h = _height_or_latest(env, height)
    blk = env.block_store.load_block(h)
    if blk is None:
        raise RPCError(-32603, f"no block at height {h}")
    return {"header": jsonable(blk.header)}


async def header_by_hash(env: Environment, hash=None) -> dict:
    return await header(env, _height_by_hash(env, hash))


async def commit(env: Environment, height=None) -> dict:
    h = _height_or_latest(env, height)
    cmt = env.block_store.load_block_commit(h)
    canonical = True
    if cmt is None:
        seen = env.block_store.load_seen_commit()
        if seen is not None and seen.height == h:
            cmt, canonical = seen, False
    if cmt is None:
        raise RPCError(-32603, f"no commit for height {h}")
    blk = env.block_store.load_block(h)
    return {"header": jsonable(blk.header) if blk else None,
            "commit": jsonable(cmt), "canonical": canonical}


async def blockchain(env: Environment, min_height=None,
                     max_height=None) -> dict:
    """rpc/core/blocks.go BlockchainInfo: metas for a height range,
    newest first, capped at 20."""
    bs = env.block_store
    maxh = int(max_height) if max_height else bs.height()
    maxh = min(maxh, bs.height())
    minh = int(min_height) if min_height else max(bs.base(), maxh - 19)
    minh = max(minh, bs.base(), maxh - 19)
    metas = []
    for h in range(maxh, minh - 1, -1):
        m = bs.load_block_meta(h)
        if m is not None:
            metas.append({"block_id": jsonable(m.block_id),
                          "header_height": m.header_height,
                          "num_txs": m.num_txs,
                          "block_size": m.block_size})
    return {"last_height": bs.height(), "block_metas": metas}


def _events_jsonable(events) -> list:
    return [{"type": e.type,
             "attributes": [{"key": a.key, "value": a.value,
                             "index": a.index}
                            for a in e.attributes]}
            for e in events or []]


async def block_results(env: Environment, height=None) -> dict:
    """rpc/core/blocks.go BlockResults / ResultBlockResults
    (responses.go:54): full FinalizeBlock output at a height."""
    h = _height_or_latest(env, height)
    raw = env.state_store.load_finalize_block_response(h)
    if raw is None:
        raise RPCError(-32603, f"no results for height {h}")
    resp = unpack_finalize_response(raw)
    return {
        "height": h,
        "tx_results": [{"code": r.code, "data": r.data.hex(),
                        "log": r.log, "gas_used": r.gas_used,
                        "events": _events_jsonable(r.events)}
                       for r in resp.tx_results],
        "finalize_block_events": _events_jsonable(resp.events),
        "validator_updates": [{"pub_key_type": u.pub_key_type,
                               "pub_key": u.pub_key_bytes.hex(),
                               "power": u.power}
                              for u in resp.validator_updates],
        "consensus_param_updates": (
            None if resp.consensus_param_updates is None
            else _params_jsonable(resp.consensus_param_updates)),
        "app_hash": resp.app_hash.hex(),
    }


def paginate_validators(vals, height: int, page, per_page) -> dict:
    """Shared validator-page serializer (also used by the light proxy so
    a light client can point at either endpoint)."""
    page, per_page = max(1, int(page)), min(100, max(1, int(per_page)))
    start = (page - 1) * per_page
    sel = vals.validators[start:start + per_page]
    return {"block_height": height,
            "validators": [{"address": v.address.hex(),
                            "pub_key_type": v.pub_key.type(),
                            "pub_key": v.pub_key.bytes().hex(),
                            "voting_power": v.voting_power,
                            "proposer_priority": v.proposer_priority}
                           for v in sel],
            "count": len(sel), "total": vals.size()}


async def validators(env: Environment, height=None, page=1,
                     per_page=30) -> dict:
    h = _height_or_latest(env, height)
    vals = env.state_store.load_validators(h)
    if vals is None:
        raise RPCError(-32603, f"no validator set at height {h}")
    return paginate_validators(vals, h, page, per_page)


def _params_jsonable(params) -> dict:
    return {
        "block": {"max_bytes": params.block.max_bytes,
                  "max_gas": params.block.max_gas},
        "evidence": {"max_age_num_blocks":
                     params.evidence.max_age_num_blocks,
                     "max_age_duration_ns":
                     params.evidence.max_age_duration_ns,
                     "max_bytes": params.evidence.max_bytes},
        "validator": {"pub_key_types": params.validator.pub_key_types},
        "version": {"app": params.version.app},
        "feature": {"vote_extensions_enable_height":
                    params.feature.vote_extensions_enable_height,
                    "pbts_enable_height":
                    params.feature.pbts_enable_height},
        "synchrony": {"precision_ns": params.synchrony.precision_ns,
                      "message_delay_ns":
                      params.synchrony.message_delay_ns},
    }


async def consensus_params(env: Environment, height=None) -> dict:
    h = _height_or_latest(env, height)
    params = env.state_store.load_params(h)
    if params is None:
        raise RPCError(-32603, f"no consensus params at height {h}")
    return {"block_height": h, "consensus_params": _params_jsonable(params)}


# --------------------------------------------------------- light serving
# (light/serve.py LightServeTier: every handler runs the tier's
# synchronous, thread-safe work in a worker thread, whose device calls
# queue on the device-owner thread; every route is behind the admission
# gate, so overload sheds with 503 + Retry-After.)

def _light_serve(env: Environment):
    tier = getattr(env.node, "light_serve", None)
    if tier is None:
        raise RPCError(-32601, "light-client serving tier is disabled "
                       "(lightserve.enable = false)")
    return tier


async def _ls_call(env: Environment, method: str, *args) -> dict:
    # lazy: light/serve.py imports rpc.json, whose package imports this
    from ..light.serve import LightServeError

    tier = _light_serve(env)
    try:
        return await asyncio.to_thread(getattr(tier, method), *args)
    except LightServeError as e:
        raise RPCError(e.code, str(e)) from e


async def light_block(env: Environment, height=None) -> dict:
    """One signed header + canonical commit + validator set — everything
    a light client needs to verify a height — served out of the tier's
    trust-period LRU.  ``canonical: false`` marks a tip answered from the
    seen-commit (not yet superseded by the next block)."""
    return await _ls_call(env, "light_block", height)


async def light_blocks(env: Environment, heights=None) -> dict:
    """Batched light-block bootstrap: many heights in ONE request (list
    or comma-separated string), each entry either a light block or a
    per-height error.  Bounded by ``lightserve.max_batch``."""
    return await _ls_call(env, "light_blocks", heights)


async def light_proofs(env: Environment, height=None, kind="tx",
                       indexes=None) -> dict:
    """Batched merkle inclusion proofs for one block: the per-level node
    cache is built once per (height, kind) and every requested index is
    gathered out of it with zero re-hashing.  ``kind`` is ``tx`` (leaves
    under the header's data_hash) or ``validator`` (leaves under
    validators_hash); ``indexes`` is a list or comma-separated string
    (omitted = every leaf, bounded by ``lightserve.max_proofs``)."""
    return await _ls_call(env, "proofs", height, str(kind), indexes)


async def light_verify(env: Environment, anchors=None) -> dict:
    """Batched server-side verification of client-supplied trust
    anchors (``[{height, commit}, ...]``): per anchor, attest that the
    commit is a valid > 2/3 commit of THIS chain's block at that height.
    Same-valset anchors verify in single batched dispatches riding the
    verified-signature dedup cache; identical hot anchors hit a
    whole-commit verdict memo (``cached: true``)."""
    return await _ls_call(env, "verify_commits", anchors)


# ------------------------------------------------------------- consensus

async def consensus_state(env: Environment) -> dict:
    """Compact round-state view (rpc/core/consensus.go ConsensusState)."""
    cs = env.node.consensus
    rs = cs.rs
    return {"round_state": {
        "height": rs.height, "round": rs.round, "step": rs.step,
        "proposal": rs.proposal is not None,
        "proposal_block": rs.proposal_block is not None,
        "locked_round": rs.locked_round,
        "valid_round": rs.valid_round,
        "fatal_error": repr(cs.fatal_error) if cs.fatal_error else None,
    }}


async def dump_consensus_state(env: Environment) -> dict:
    cs = env.node.consensus
    rs = cs.rs
    out = await consensus_state(env)
    votes = []
    if rs.votes is not None:
        for r in range(rs.round + 1):
            pv_ = rs.votes.prevotes(r)
            pc = rs.votes.precommits(r)
            votes.append({
                "round": r,
                "prevotes": str(pv_.bit_array()) if pv_ else None,
                "precommits": str(pc.bit_array()) if pc else None,
            })
        out["round_state"]["height_vote_set"] = votes
    peers = []
    if env.node.switch is not None:
        for p in env.node.switch.peers.values():
            ps = p.get("cons_peer_state")
            if ps is not None:
                peers.append({"node_id": p.id, "height": ps.height,
                              "round": ps.round, "step": ps.step})
    out["peers"] = peers
    return out


# --------------------------------------------------------------- mempool

async def unconfirmed_txs(env: Environment, limit=30) -> dict:
    mp = env.node.mempool
    txs = mp.contents()[:min(100, int(limit))]
    return {"n_txs": len(txs), "total": mp.size(),
            "total_bytes": mp.size_bytes(),
            "txs": [t.hex() for t in txs]}


async def num_unconfirmed_txs(env: Environment) -> dict:
    mp = env.node.mempool
    return {"n_txs": mp.size(), "total": mp.size(),
            "total_bytes": mp.size_bytes()}


def _tx_bytes(tx) -> bytes:
    if isinstance(tx, str):
        return bytes.fromhex(tx)
    return bytes(tx)


_shed_total = _counter("rpc_overload_shed_total",
                       "tx submissions rejected under loop overload")


def _check_overload(env: Environment) -> None:
    """Admission control for tx submission: while the event loop's
    scheduling lag (``libs/loopwatch``) exceeds ``rpc.overload_shed_lag_s``,
    reject with the retryable code -32099 instead of queueing more CheckTx
    work; a sustained flood would otherwise starve consensus's timers.
    0 disables."""
    node = env.node
    cfg = getattr(node, "config", None)
    thresh = getattr(getattr(cfg, "rpc", None), "overload_shed_lag_s", 0.0)
    wd = getattr(node, "loop_watchdog", None)
    if not thresh or wd is None:
        return
    lag = wd.last_lag_s
    if lag > thresh:
        _shed_total.inc()
        raise RPCError(-32099,
                       "server overloaded (event-loop lag "
                       f"{lag:.2f}s > {thresh:.2f}s); retry later")


async def broadcast_tx_async(env: Environment, tx=None) -> dict:
    _check_overload(env)
    raw = _tx_bytes(tx)

    async def _fire_and_forget():
        try:
            await env.node.mempool.check_tx(raw)
        except TxRejectedError:
            pass                 # async mode: rejection is not reported

    aio.spawn(_fire_and_forget())
    return {"hash": TxKey(raw).hex(), "code": 0}


async def broadcast_tx_sync(env: Environment, tx=None) -> dict:
    """CheckTx ran, result returned (rpc/core/mempool.go)."""
    _check_overload(env)
    raw = _tx_bytes(tx)
    try:
        await env.node.mempool.check_tx(raw)
    except TxRejectedError as e:
        return {"hash": TxKey(raw).hex(), "code": e.code, "log": e.log}
    return {"hash": TxKey(raw).hex(), "code": 0, "log": ""}


async def broadcast_tx_commit(env: Environment, tx=None,
                              timeout_s: float = 30.0) -> dict:
    """Submit and wait for the tx to land in a block (rpc/core/mempool.go
    BroadcastTxCommit; the reference subscribes to EventTx)."""
    _check_overload(env)
    raw = _tx_bytes(tx)
    key = TxKey(raw).hex()
    sub_id = f"rpc-commit-{key}-{id(raw)}"
    sub = env.node.event_bus.subscribe(
        sub_id, {"tm.event": ev.EVENT_TX, ev.TX_HASH_KEY: key})
    try:
        try:
            await env.node.mempool.check_tx(raw)
        except TxRejectedError as e:
            return {"hash": key, "check_tx": {"code": e.code, "log": e.log}}
        msg = await asyncio.wait_for(sub.queue.get(), timeout_s)
        res = msg.data["result"]
        return {"hash": key, "check_tx": {"code": 0},
                "tx_result": {"code": res.code, "log": res.log,
                              "data": res.data.hex()},
                "height": msg.data["height"]}
    except asyncio.TimeoutError:
        raise RPCError(-32603,
                       "timed out waiting for tx to be included in a block")
    finally:
        env.node.event_bus.unsubscribe(sub_id)


async def check_tx(env: Environment, tx=None) -> dict:
    """rpc/core/mempool.go:215 CheckTx: run the app's CheckTx without
    adding the tx to the mempool."""
    res = await env.node.app_conns.mempool.check_tx(_tx_bytes(tx))
    return {"code": res.code, "data": res.data.hex(), "log": res.log,
            "gas_wanted": res.gas_wanted}


# ------------------------------------------------------------------ abci

async def abci_info(env: Environment) -> dict:
    resp = await env.node.app_conns.query.info()
    return {"response": {"data": resp.data, "version": resp.version,
                         "app_version": resp.app_version,
                         "last_block_height": resp.last_block_height,
                         "last_block_app_hash":
                         resp.last_block_app_hash.hex()}}


async def abci_query(env: Environment, path="", data=None, height=0,
                     prove=False) -> dict:
    raw = _tx_bytes(data) if data else b""
    resp = await env.node.app_conns.query.query(path, raw, int(height),
                                                bool(prove))
    return {"response": {"code": resp.code, "log": resp.log,
                         "key": resp.key.hex(), "value": resp.value.hex(),
                         "height": resp.height,
                         "proof_ops": [{"type": op["type"],
                                        "key": op["key"].hex(),
                                        "data": op["data"].hex()}
                                       for op in resp.proof_ops]}}


# -------------------------------------------------------------- evidence

async def broadcast_evidence(env: Environment, evidence=None) -> dict:
    ev_obj = from_jsonable(evidence)
    try:
        env.node.evidence_pool.add_evidence(ev_obj)
    except EvidenceError as e:
        raise RPCError(-32603, f"invalid evidence: {e}")
    return {"hash": ev_obj.hash().hex()}


# --------------------------------------------------------------- pruning

async def retain_heights(env: Environment) -> dict:
    """ADR-101 pruning-service introspection."""
    pruner = env.node.pruner
    if pruner is None:
        raise RPCError(-32603, "pruner not running")
    app, dc = pruner.retain_heights()
    return {"app_retain_height": app, "data_companion_retain_height": dc,
            "effective": pruner.effective_retain_height(),
            "store_base": env.block_store.base()}


async def set_companion_retain_height(env: Environment, height=0) -> dict:
    """ADR-101 data-companion SetBlockRetainHeight."""
    pruner = env.node.pruner
    if pruner is None:
        raise RPCError(-32603, "pruner not running")
    h = int(height)
    if h < 0:
        raise RPCError(-32602, "height must be >= 0")
    pruner.set_companion_retain_height(h)
    return {"data_companion_retain_height": h}


# --------------------------------------------------------------- indexer

def _check_order_by(order_by) -> str:
    if order_by not in ("", "asc", "desc"):
        raise RPCError(-32602, f"order_by must be asc|desc, "
                       f"got {order_by!r}")
    return order_by or "asc"


def _tx_proof_provider(env: Environment):
    """Per-request provider of tx inclusion proofs under the block's
    data_hash (rpc/core/tx.go:40 — Data.Txs proof at the tx's index).
    Caches the (root, proofs) tree per height so a search page touching
    one block hashes its tx tree once.  Returns None for pruned blocks
    (the reference skips the proof when the block is nil).  A block's
    txs sit well below the kernel route's 2,048 leaves."""
    trees: dict[int, tuple] = {}

    def prove(res: dict) -> dict | None:
        h = res["height"]
        if h not in trees:
            blk = env.block_store.load_block(h)
            trees[h] = (None if blk is None else
                        merkle.proofs_from_byte_slices(
                            [_txh(t) for t in blk.data.txs]))
        tree = trees[h]
        if tree is None:
            return None
        root, proofs = tree
        pf = proofs[res["index"]]
        return {"root_hash": root.hex(), "data": res["tx"],
                "proof": {"total": pf.total, "index": pf.index,
                          "leaf_hash": pf.leaf_hash.hex(),
                          "aunts": [a.hex() for a in pf.aunts]}}

    return prove


async def tx(env: Environment, hash=None, prove=False) -> dict:
    indexer = getattr(env.node, "tx_indexer", None)
    if indexer is None:
        raise RPCError(-32603, "transaction indexing is disabled")
    want = bytes.fromhex(hash) if isinstance(hash, str) else hash
    res = indexer.get(want)
    if res is None:
        raise RPCError(-32603, f"tx {want.hex()} not found")
    if prove:
        pf = _tx_proof_provider(env)(res)
        if pf is not None:
            res = dict(res, proof=pf)
    return res


async def tx_search(env: Environment, query="", page=1,
                    per_page=30, prove=False, order_by="") -> dict:
    indexer = getattr(env.node, "tx_indexer", None)
    if indexer is None:
        raise RPCError(-32603, "transaction indexing is disabled")
    try:
        out = indexer.search(query, int(page), int(per_page),
                             order_by=_check_order_by(order_by))
    except QuerySyntaxError as e:
        raise RPCError(-32602, f"bad query: {e}") from e
    if prove:
        prover = _tx_proof_provider(env)
        out["txs"] = [dict(r, proof=pf) if (pf := prover(r)) is not None
                      else r for r in out["txs"]]
    return out


async def block_search(env: Environment, query="", page=1,
                       per_page=30, order_by="") -> dict:
    indexer = getattr(env.node, "block_indexer", None)
    if indexer is None:
        raise RPCError(-32603, "block indexing is disabled")
    try:
        return indexer.search(query, int(page), int(per_page),
                              order_by=_check_order_by(order_by))
    except QuerySyntaxError as e:
        raise RPCError(-32602, f"bad query: {e}") from e


# --------------------------------------------------- flight recorder

async def dump_trace(env: Environment, limit=1000, sub=None,
                     height=None) -> dict:
    """Dump the node-wide flight recorder (``libs/tracing`` ring buffer)
    as JSON: the newest ``limit`` completed spans/events, in completion
    order.  Sort records by ``start_ns`` to reconstruct a timeline; a
    committed height shows its consensus step spans with the ABCI calls,
    WAL fsyncs and verify micro-batches that ran inside them.
    ``sub=consensus`` keeps one subsystem; ``height=H`` keeps records
    stamped with that height.  Empty (with ``enabled: false``) unless
    ``[instrumentation] tracing`` is on."""
    lim = int(limit)
    if lim < 0:
        raise RPCError(-32602, "limit must be >= 0")
    st = tracing.stats()
    # a full ring projects to megabytes of dicts: off the event loop
    records = await asyncio.to_thread(
        tracing.dump, lim, str(sub) if sub is not None else None,
        int(height) if height is not None else None)
    return {
        "enabled": st["enabled"],
        "ring_size": st["ring_size"],
        "buffered": st["buffered"],
        "records": records,
    }


async def consensus_timeline(env: Environment, height=0, n=8,
                             node=None) -> dict:
    """Per-height commit-latency waterfalls folded from the flight
    recorder (``libs/timeline``): ordered phases (propose -> gossip ->
    prevote -> precommit -> commit), emitter marks, and residual
    buckets (gossip_wait/verify/app/wal/idle) that sum exactly to the
    measured commit latency.  ``height=H`` selects one height,
    otherwise the newest ``n`` per node; ``node=`` filters an in-proc
    ensemble's shared ring.  Requires ``[instrumentation] tracing``."""
    from ..libs import timeline

    h = int(height)
    k = int(n)
    if h < 0 or k < 0:
        raise RPCError(-32602, "height and n must be >= 0")
    st = tracing.stats()
    waterfalls = await asyncio.to_thread(
        timeline.fold, tracing.snapshot(),
        node=str(node) if node is not None else None,
        height=h or None, limit=k)
    return {
        "enabled": st["enabled"],
        "buffered": st["buffered"],
        "phases": list(timeline.PHASES),
        "buckets": list(timeline.BUCKETS),
        "waterfalls": waterfalls,
    }


async def dump_incidents(env: Environment, limit=50, name=None) -> dict:
    """List the liveness watchdog's black-box incident bundles (newest
    first, metadata only — filenames carry timestamp + reasons, bodies
    can run megabytes of trace ring).  Pass ``name=<listing name>`` to
    fetch one parsed bundle inline.  Always answers, even with the
    watchdog disabled or no home dir: ``enabled: false`` + an empty
    list, so operator tooling can probe unconditionally."""
    from ..node.watchdog import list_incidents, load_incident

    node = env.node
    wd = getattr(node, "liveness_watchdog", None)
    incident_fn = getattr(node, "incident_dir", None)
    incident_dir = incident_fn() if callable(incident_fn) else None
    out = {
        "enabled": wd is not None,
        "incident_dir": incident_dir or "",
        "trips": wd.trips if wd is not None else 0,
        "incidents": (list_incidents(incident_dir, int(limit))
                      if incident_dir else []),
    }
    if name is not None:
        if not incident_dir:
            raise RPCError(-32603, "no incident directory on this node")
        # a bundle body can run megabytes of trace ring: read + parse
        # in a worker thread — this route bypasses the admission gate
        # (diagnostics must answer during overload), so it especially
        # must not stall the event loop
        bundle = await asyncio.to_thread(
            load_incident, incident_dir, str(name))
        if bundle is None:
            raise RPCError(-32603, f"no incident bundle {name!r}")
        out["bundle"] = bundle
    return out


# ---------------------------------------------------- unsafe (dev-only)

async def dial_seeds(env: Environment, seeds=None) -> dict:
    """rpc/core/net.go:46 UnsafeDialSeeds."""
    for addr in seeds or []:
        try:
            await env.node.switch.dial_peer(addr)
        except Exception as e:          # best-effort, like the reference
            tmlog.logger("rpc").error("dial_seeds", addr=addr, err=str(e))
    return {"log": "Dialing seeds in progress. See /net_info for details"}


async def dial_peers(env: Environment, peers=None,
                     persistent=False) -> dict:
    """rpc/core/net.go:59 UnsafeDialPeers."""
    for addr in peers or []:
        try:
            await env.node.switch.dial_peer(addr, persistent=bool(persistent))
        except Exception as e:
            tmlog.logger("rpc").error("dial_peers", addr=addr, err=str(e))
    return {"log": "Dialing peers in progress. See /net_info for details"}


async def unsafe_flush_mempool(env: Environment) -> dict:
    """rpc/core/dev.go:9 UnsafeFlushMempool."""
    await env.node.mempool.flush()
    return {}


ROUTES = {
    "health": health,
    "status": status,
    "net_info": net_info,
    "genesis": genesis,
    "block": block,
    "block_by_hash": block_by_hash,
    "header": header,
    "commit": commit,
    "blockchain": blockchain,
    "block_results": block_results,
    "validators": validators,
    "consensus_params": consensus_params,
    "consensus_state": consensus_state,
    "dump_consensus_state": dump_consensus_state,
    "unconfirmed_txs": unconfirmed_txs,
    "num_unconfirmed_txs": num_unconfirmed_txs,
    "broadcast_tx_async": broadcast_tx_async,
    "broadcast_tx_sync": broadcast_tx_sync,
    "broadcast_tx_commit": broadcast_tx_commit,
    "abci_info": abci_info,
    "abci_query": abci_query,
    "broadcast_evidence": broadcast_evidence,
    "retain_heights": retain_heights,
    "set_companion_retain_height": set_companion_retain_height,
    "tx": tx,
    "tx_search": tx_search,
    "block_search": block_search,
    "header_by_hash": header_by_hash,
    "genesis_chunked": genesis_chunked,
    "check_tx": check_tx,
    "dump_trace": dump_trace,
    "dump_incidents": dump_incidents,
    "consensus_timeline": consensus_timeline,
    "light_block": light_block,
    "light_blocks": light_blocks,
    "light_proofs": light_proofs,
    "light_verify": light_verify,
}

# registered only when config rpc.unsafe is set (rpc/core/routes.go:57-62)
UNSAFE_ROUTES = {
    "dial_seeds": dial_seeds,
    "dial_peers": dial_peers,
    "unsafe_flush_mempool": unsafe_flush_mempool,
}
