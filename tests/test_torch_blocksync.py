"""Blocksync of the port against the JAX package's: the five reactor
messages byte for byte, the pool's rules (peer picking, timeout, redo,
caught up), the seven window-accumulator cases of
``tests/test_blocksync.py`` run on both packages, the patient device
wait, and the slice as a whole: two port reactors over a loopback
switch catch up a chain the JAX package's executor made, clean and with
a lying peer, and end with the stores and state of the JAX source node
and of a JAX reactor pair on the same chain."""

import asyncio
import copy
import threading
from types import SimpleNamespace

import pytest
import torch

from cometbft_tpu.abci.application import Application as JApp
from cometbft_tpu.abci.client import LocalClient as JLocal
from cometbft_tpu.blocksync import pool as jpool_mod
from cometbft_tpu.blocksync import reactor as jreactor_mod
from cometbft_tpu.crypto.keys import Ed25519PrivKey as JPriv
from cometbft_tpu.mempool.mempool import NopMempool as JNopMempool
from cometbft_tpu.sm.execution import BlockExecutor as JExecutor
from cometbft_tpu.storage.blockstore import BlockStore as JBlockStore
from cometbft_tpu.storage.db import MemDB as JMemDB
from cometbft_tpu.storage.statestore import State as JState
from cometbft_tpu.storage.statestore import StateStore as JStateStore
from cometbft_tpu.types import canonical as JCanon
from cometbft_tpu.types import codec as JC
from cometbft_tpu.types.block_id import BlockID as JBlockID
from cometbft_tpu.types.block_id import PartSetHeader as JPSH
from cometbft_tpu.types.commit import Commit as JCommit
from cometbft_tpu.types.commit import CommitSig as JCommitSig
from cometbft_tpu.types.validator_set import Validator as JValidator
from cometbft_tpu.types.validator_set import ValidatorSet as JValidatorSet
from cometbft_tpu_torch import convert
from cometbft_tpu_torch.abci.application import Application as TApp
from cometbft_tpu_torch.abci.client import LocalClient as TLocal
from cometbft_tpu_torch.blocksync import pool as tpool_mod
from cometbft_tpu_torch.blocksync import reactor as treactor_mod
from cometbft_tpu_torch.crypto import batch as tbatch
from cometbft_tpu_torch.crypto import plan as tplan
from cometbft_tpu_torch.crypto.keys import Ed25519PrivKey as TPriv
from cometbft_tpu_torch.crypto.keys import Ed25519PubKey
from cometbft_tpu_torch.mempool.mempool import NopMempool as TNopMempool
from cometbft_tpu_torch.sm.execution import BlockExecutor as TExecutor
from cometbft_tpu_torch.storage.blockstore import BlockStore as TBlockStore
from cometbft_tpu_torch.storage.db import MemDB as TMemDB
from cometbft_tpu_torch.storage.statestore import State as TState
from cometbft_tpu_torch.storage.statestore import StateStore as TStateStore
from cometbft_tpu_torch.types import canonical as TCanon
from cometbft_tpu_torch.types import validation as tvalidation
from cometbft_tpu_torch.types.block_id import BlockID as TBlockID
from cometbft_tpu_torch.types.block_id import PartSetHeader as TPSH
from cometbft_tpu_torch.types.commit import Commit as TCommit
from cometbft_tpu_torch.types.commit import CommitSig as TCommitSig
from cometbft_tpu_torch.types.genesis import GenesisDoc, GenesisValidator
from cometbft_tpu_torch.types.params import default_consensus_params
from cometbft_tpu_torch.types.validator_set import Validator as TValidator
from cometbft_tpu_torch.types.validator_set import \
    ValidatorSet as TValidatorSet

from test_blocksync import _Blk, _FakePool
from chip_smoke import LoopSwitch
from torch_blocksync_fixtures import jax_chain, run

torch.set_num_threads(1)

pytestmark = pytest.mark.timeout(150)

CHAIN_ID = "test-chain"          # the accumulator cases' chain id
PRECOMMIT = 2
BAD_AT = 6                       # the lying peer's block: its last commit
                                 # (for BAD_AT - 1) has a flipped signature

J = SimpleNamespace(
    name="jax", Priv=JPriv, VS=JValidatorSet, V=JValidator, Commit=JCommit,
    CS=JCommitSig, BID=JBlockID, PSH=JPSH, canon=JCanon, mod=jreactor_mod,
    pool=jpool_mod, kw={"backend": "cpu"})
T = SimpleNamespace(
    name="torch", Priv=TPriv, VS=TValidatorSet, V=TValidator, Commit=TCommit,
    CS=TCommitSig, BID=TBlockID, PSH=TPSH, canon=TCanon, mod=treactor_mod,
    pool=tpool_mod, kw={"device": "cpu"})


# ----------------------------------------------------------- messages

def test_reactor_messages_match_jax():
    chain = jax_chain(heights=3)
    blk = JC.pack(chain.blocks[1])
    ext = JC.pack(chain.ext_commits[0])
    for tag, fields in (("sreq", {}), ("sres", {"h": 97, "b": 1}),
                        ("sres", {"h": 0, "b": 0}), ("breq", {"h": 40}),
                        ("bres", {"h": 2, "blk": blk, "ext": None}),
                        ("bres", {"h": 2, "blk": blk, "ext": ext}),
                        ("nores", {"h": 2**40})):
        raw = jreactor_mod._pack(tag, **dict(fields))
        assert treactor_mod._pack(tag, **dict(fields)) == raw
    assert treactor_mod.BLOCKSYNC_CHANNEL == jreactor_mod.BLOCKSYNC_CHANNEL
    assert treactor_mod.BATCH_WINDOW == jreactor_mod.BATCH_WINDOW == 32
    ch = treactor_mod.BlocksyncReactor(None, None, None).get_channels()
    assert [(c.channel_id, c.priority, c.send_queue_capacity, c.name)
            for c in ch] == [(0x40, 5, 1000, "blocksync")]


def test_window_blocks_is_the_configured_window():
    for base in (1, 2, 32, 256):
        assert tplan.window_blocks(base, 1000) == base
    tplan.set_devices(["cpu"] * 4)
    try:
        assert tplan.window_blocks(32, 1000) == 32
    finally:
        tplan.set_devices(None)


# ---------------------------------------------------------------- pool

async def _pool_scenario(mod):
    """One script run against a pool module; returns its log."""
    log, sent = [], []
    pool = mod.BlockPool(1, lambda p, h: sent.append((p, h)),
                         lambda p, r, e: log.append(("error", p, r, e)))
    pool.set_peer_range("a", 1, 6)
    pool.set_peer_range("b", 3, 4)
    log.append(("caught", pool.is_caught_up(), pool.max_peer_height))
    pool.start()
    await asyncio.sleep(0.2)
    log.append(("sent", sorted(sent)))
    by_h = {h: p for p, h in sent}
    blk = lambda h: SimpleNamespace(header=SimpleNamespace(height=h))  # noqa
    other = {"a": "b", "b": "a"}
    log.append(("wrong peer", pool.add_block(other[by_h[2]], blk(2))))
    log.append(("unknown height", pool.add_block("a", blk(40))))
    for h in (1, 2, 3):
        log.append(("add", h, pool.add_block(by_h[h], blk(h), "ext")))
    log.append(("again", pool.add_block(by_h[1], blk(1))))
    log.append(("window", [b.header.height for b, _ in
                           pool.peek_window(10)]))
    pool.pop_request()
    log.append(("height", pool.height, len(pool.requesters)))
    # the server of height 3 lied: it goes, with every block it served
    bad = pool.redo_request(3)
    log.append(("redo", bad, sorted(pool.peers), pool.max_peer_height))
    await asyncio.sleep(0.2)
    log.append(("resent", sorted(sent[len(by_h):])))
    # the last peer times out on its pending requests
    await asyncio.sleep(0.3)
    log.append(("timeout", sorted(pool.peers), pool.is_caught_up()))
    pool.set_peer_range("c", 1, 2)
    log.append(("caught", pool.is_caught_up(), pool.max_peer_height))
    pool.remove_peer("c")
    await pool.stop()
    log.append(("stopped", len(pool.requesters)))
    return log


def test_pool_rules_match_jax(monkeypatch):
    for mod in (jpool_mod, tpool_mod):
        monkeypatch.setattr(mod, "REQUEST_TIMEOUT", 0.35)
    logs = [run(_pool_scenario(mod)) for mod in (jpool_mod, tpool_mod)]
    assert logs[1] == logs[0]
    log = dict((e[0], e[1:]) for e in logs[1] if e[0] in
               ("sent", "window", "redo", "timeout", "stopped"))
    # six heights, each to the least-loaded peer that has it: b has
    # only 3..4 and takes both while a holds 1 and 2
    assert log["sent"][0] == [("a", 1), ("a", 2), ("a", 5), ("a", 6),
                              ("b", 3), ("b", 4)]
    assert log["window"] == ([1, 2, 3],)
    assert log["redo"][1] == ["a"] or log["redo"][1] == ["b"]
    assert ("error",) + log["redo"][:1] + ("bad block at 3", "bad_block") \
        in logs[1]
    assert any(e[0] == "error" and e[-1] == "block_timeout"
               for e in logs[1])
    assert log["stopped"] == (0,)


# ----------------------------------------------------- accumulator cases

def _vals(P, n=4, prefix=b"bsv"):
    privs = [P.Priv.from_secret(prefix + b"%d" % i) for i in range(n)]
    vals = P.VS([P.V(p.pub_key(), 10) for p in privs])
    return vals, {p.pub_key().address(): p for p in privs}


def _bid(P, h):
    return P.BID(bytes([h]) * 32, P.PSH(1, bytes([h ^ 0xFF]) * 32))


def _commit(P, vals, by_addr, height, bid, bad=False):
    sigs = []
    for i, v in enumerate(vals.validators):
        ts = 1_700_000_000_000_000_000 + i
        sig = by_addr[v.address].sign(P.canon.canonical_vote_sign_bytes(
            CHAIN_ID, PRECOMMIT, height, 0, bid, ts))
        if bad and i == 0:
            sig = sig[:20] + bytes([sig[20] ^ 1]) + sig[21:]
        sigs.append(P.CS(2, v.address, ts, sig))
    return P.Commit(height, 0, bid, sigs)


def _chain(P, vals, by_addr, first_h, last_h, *, bad_commit_for=(),
           wrong_bid_for=()):
    blocks, vh = [], vals.hash()
    for h in range(first_h, last_h + 1):
        lc = None
        if h > first_h:
            prev = h - 1
            bid = _bid(P, prev + 2) if prev in wrong_bid_for \
                else _bid(P, prev)
            lc = _commit(P, vals, by_addr, prev, bid,
                         bad=prev in bad_commit_for)
        blocks.append(_Blk(h, vh, lc))
    return blocks


class _Parts:
    """The part-set stub of ``tests/test_blocksync.py`` with package P's
    PartSetHeader, so the packed block ID matches the one signed."""

    def __init__(self, P, blk):
        self._hdr = P.PSH(1, bytes([blk.header.height ^ 0xFF]) * 32)

    def header(self):
        return self._hdr


def _mk_reactor(P, monkeypatch, vals, pool, verify_window,
                valset_after=None):
    monkeypatch.setattr(P.mod, "codec", SimpleNamespace(pack=lambda b: b))
    monkeypatch.setattr(
        P.mod, "PartSet",
        SimpleNamespace(from_data=lambda b, **kw: _Parts(P, b)))
    monkeypatch.setattr(P.mod, "validate_block", lambda *a, **k: None)
    state = SimpleNamespace(
        chain_id=CHAIN_ID, validators=vals,
        consensus_params=SimpleNamespace(feature=SimpleNamespace(
            vote_extensions_enabled=lambda h: False)))
    applied = []

    async def apply_block(st, fid, blk, verified=False):
        applied.append(blk.header.height)
        if valset_after and blk.header.height in valset_after:
            return SimpleNamespace(
                chain_id=st.chain_id,
                validators=valset_after[blk.header.height],
                consensus_params=st.consensus_params)
        return st

    block_exec = SimpleNamespace(
        apply_block=apply_block,
        evidence_pool=SimpleNamespace(check_evidence=lambda ev: None))
    block_store = SimpleNamespace(
        save_block=lambda *a: None,
        save_block_with_extended_commit=lambda *a: None,
        height=lambda: pool.height - 1, base=lambda: 0)
    r = P.mod.BlocksyncReactor(block_exec, block_store, state,
                               verify_window=verify_window, **P.kw)
    r.pool = pool
    reports = []
    r.switch = SimpleNamespace(
        report_peer=lambda pid, ev, detail=None, disconnect=False:
        reports.append((pid, ev)), peers={})
    pool.on_peer_error = r._on_pool_peer_error
    return r, applied, reports


def _case_full_chain(P, mp):
    vals, by = _vals(P)
    pool = _FakePool(1, _chain(P, vals, by, 1, 9))
    r, applied, _ = _mk_reactor(P, mp, vals, pool, 3)
    run(asyncio.wait_for(r._apply_routine(), 30))
    assert applied == list(range(1, 9)) and r.synced.is_set()
    return applied


def _case_partial_flush(P, mp):
    vals, by = _vals(P)
    pool = _FakePool(1, _chain(P, vals, by, 1, 3))
    r, applied, _ = _mk_reactor(P, mp, vals, pool, 32)
    run(asyncio.wait_for(r._apply_routine(), 30))
    assert applied == [1, 2]
    return applied


def _case_valset_change(P, mp):
    vals_a, by_a = _vals(P)
    vals_b, by_b = _vals(P, prefix=b"bsw")
    chain_a = _chain(P, vals_a, by_a, 1, 4)
    chain_b = _chain(P, vals_b, by_b, 4, 7)[1:]
    for b in chain_b:
        b.header.validators_hash = vals_b.hash()
    chain_b[0].last_commit = _commit(P, vals_a, by_a, 4, _bid(P, 4))
    pool = _FakePool(1, chain_a + chain_b)
    r, applied, _ = _mk_reactor(P, mp, vals_a, pool, 16,
                                valset_after={4: vals_b})
    run(asyncio.wait_for(r._apply_routine(), 30))
    assert applied == [1, 2, 3, 4, 5, 6]
    return applied


def _case_statesync_anchor(P, mp):
    vals, by = _vals(P)
    pool = _FakePool(101, _chain(P, vals, by, 101, 106))
    r, applied, _ = _mk_reactor(P, mp, vals, pool, 4)
    run(asyncio.wait_for(r._apply_routine(), 30))
    assert applied == list(range(101, 106))
    return applied


def _case_bad_commit(P, mp):
    vals, by = _vals(P)
    pool = _FakePool(1, _chain(P, vals, by, 1, 7, bad_commit_for={4}),
                     good_blocks=_chain(P, vals, by, 1, 7))
    r, applied, reports = _mk_reactor(P, mp, vals, pool, 8)
    run(asyncio.wait_for(r._apply_routine(), 30))
    assert applied == [1, 2, 3, 4, 5, 6]
    assert pool.redone[:2] == [4, 5]
    assert ("peer-of-4", "bad_block") in reports
    return applied, pool.redone, reports


def _case_basics_failure(P, mp):
    vals, by = _vals(P)
    pool = _FakePool(1, _chain(P, vals, by, 1, 6, wrong_bid_for={3}),
                     good_blocks=_chain(P, vals, by, 1, 6))
    r, applied, reports = _mk_reactor(P, mp, vals, pool, 8)
    run(asyncio.wait_for(r._apply_routine(), 30))
    assert applied == [1, 2, 3, 4, 5]
    assert pool.redone[:2] == [3, 4]
    assert ("peer-of-3", "bad_block") in reports
    return applied, pool.redone, reports


def _case_double_buffer(P, mp):
    vals, by = _vals(P)
    pool = _FakePool(1, _chain(P, vals, by, 1, 12))
    r, _, _ = _mk_reactor(P, mp, vals, pool, 4)

    async def main():
        a = r._stage_window(0)
        b = r._stage_window(a.n_blocks)
        pa, ea = await a.task
        pb, eb = await b.task
        return ((a.first_height, a.n_blocks), (b.first_height, b.n_blocks),
                ea, eb, [p[0].header.height for p in pa],
                [p[0].header.height for p in pb])

    out = run(main())
    assert out == ((1, 4), (5, 4), None, None, [1, 2, 3, 4], [5, 6, 7, 8])
    return out


@pytest.mark.parametrize("case", [
    _case_full_chain, _case_partial_flush, _case_valset_change,
    _case_statesync_anchor, _case_bad_commit, _case_basics_failure,
    _case_double_buffer], ids=lambda f: f.__name__[6:])
def test_accumulator_matches_jax(monkeypatch, case):
    """Each case of ``tests/test_blocksync.py``'s accumulator, on the
    port with ``device="cpu"`` and on the JAX package: the same blocks
    apply, the same heights are fetched again and the same peers are
    reported."""
    assert case(T, monkeypatch) == case(J, monkeypatch)


# -------------------------------------------------------- patient wait

def _items(n_items=3):
    vals, by = _vals(T)
    return vals, [(_bid(T, h), h, _commit(T, vals, by, h, _bid(T, h)))
                  for h in range(1, n_items + 1)]


def test_patient_dispatch_runs_on_the_device_owner_thread(monkeypatch):
    vals, items = _items()
    seen = []
    inner = tvalidation._lane_verdicts

    def spy(*a, **k):
        seen.append(threading.current_thread().name)
        return inner(*a, **k)

    monkeypatch.setattr(tvalidation, "_lane_verdicts", spy)
    n = tvalidation.verify_commits_light_batched(CHAIN_ID, vals, items,
                                                 device="cpu", patient=True)
    assert n == 9 and len(seen) == 1
    assert seen[0].startswith(tbatch.DEVICE_THREAD_NAME)
    tvalidation.verify_commits_light_batched(CHAIN_ID, vals, items,
                                             device="cpu")
    assert seen[1] == threading.current_thread().name
    # windows from several threads queue on the one owner thread
    outs = []
    threads = [threading.Thread(target=lambda: outs.append(
        tvalidation.verify_commits_light_batched(
            CHAIN_ID, vals, items, device="cpu", patient=True)))
        for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not any(t.is_alive() for t in threads) and outs == [9] * 4
    assert len({s for s in seen[2:]}) == 1
    assert seen[2].startswith(tbatch.DEVICE_THREAD_NAME)


@pytest.mark.parametrize("route", ["dense", "loop"])
def test_patient_device_error_surfaces_in_the_caller(monkeypatch, route):
    """A device call that raises is raised to the caller; nothing
    verifies on the host instead."""
    vals, items = _items()
    calls = []

    def boom(*a, **k):
        calls.append(threading.current_thread().name)
        raise RuntimeError("device lost")

    if route == "dense":
        monkeypatch.setattr(tvalidation, "_lane_verdicts", boom)
    else:
        # a set without the dense view takes the lane loop
        monkeypatch.setattr(type(vals), "dense", lambda self: None)
        monkeypatch.setattr(tbatch.BatchVerifier, "verify", boom)
    before = dict(tbatch.DISPATCHES)
    with pytest.raises(RuntimeError, match="device lost"):
        tvalidation.verify_commits_light_batched(CHAIN_ID, vals, items,
                                                 device="cpu", patient=True)
    assert len(calls) == 1
    assert calls[0].startswith(tbatch.DEVICE_THREAD_NAME)
    assert dict(tbatch.DISPATCHES) == before


# ------------------------------------------------------ the whole slice

def _port_genesis(doc):
    p = default_consensus_params()
    p.feature.vote_extensions_enable_height = \
        doc.consensus_params.feature.vote_extensions_enable_height
    return GenesisDoc(
        doc.chain_id, genesis_time_ns=doc.genesis_time_ns,
        consensus_params=p,
        validators=[GenesisValidator(Ed25519PubKey(v.pub_key.bytes()),
                                     v.power) for v in doc.validators])


@pytest.fixture(scope="module")
def chain():
    return jax_chain()


def _liar_db(chain):
    """The source's block store with block BAD_AT's last commit carrying
    one flipped signature (it vouches for BAD_AT - 1)."""
    blk = copy.deepcopy(chain.blocks[BAD_AT - 1])
    s = blk.last_commit.signatures[2].signature
    blk.last_commit.signatures[2].signature = s[:9] + bytes(
        [s[9] ^ 0x10]) + s[10:]
    db = dict(chain.block_dbs[-1])
    db[b"B/" + BAD_AT.to_bytes(8, "big")] = JC.pack(blk)
    return db


def _node(P, chain):
    """A fresh syncing node of package P: empty stores, genesis state."""
    if P is T:
        bdb, sdb = TMemDB(), TMemDB()
        bs, ss = TBlockStore(bdb), TStateStore(sdb)
        state = TState.from_genesis(_port_genesis(chain.doc))
        ex = TExecutor(ss, bs, TLocal(TApp()), TNopMempool(), device="cpu")
    else:
        bdb, sdb = JMemDB(), JMemDB()
        bs, ss = JBlockStore(bdb), JStateStore(sdb)
        state = JState.from_genesis(chain.doc)
        ex = JExecutor(ss, bs, JLocal(JApp()), JNopMempool(), backend="cpu")
    ss.save(state)
    return ex, bs, ss, state


def _server(P, chain, db_items, name):
    if P is T:
        db = TMemDB()
        db._data.update(db_items)
        state = convert.state_from_bytes(chain.state_dbs[-1][b"S/state"])
        store = TBlockStore(db)
    else:
        db = JMemDB()
        db._data.update(db_items)
        state = chain.states[-1]
        store = JBlockStore(db)
    return P.mod.BlocksyncReactor(None, store, state, name=name, **P.kw)


def _catch_up(P, chain, liar):
    """A syncing node of package P catches up from one server (the liar
    first when ``liar``; the honest server is connected when the switch
    drops it).  Returns (block db, state db, state height, reports,
    heights applied in order)."""
    async def main():
        ex, bs, ss, state = _node(P, chain)
        applied = []
        inner = ex.apply_block

        async def apply_block(st, bid, block, **kw):
            applied.append(block.header.height)
            return await inner(st, bid, block, **kw)

        ex.apply_block = apply_block
        sync = P.mod.BlocksyncReactor(ex, bs, state, fast_sync=True,
                                      no_peers_grace=30.0, **P.kw)
        sw = LoopSwitch(sync)
        honest = _server(P, chain, chain.block_dbs[-1], "honest")
        await sync.start()
        if liar:
            sw.on_drop = lambda pid: sw.connect(honest, "honest")
            sw.connect(_server(P, chain, _liar_db(chain), "liar"), "liar")
        else:
            sw.connect(honest, "honest")
        await asyncio.wait_for(sync.synced.wait(), 120)
        await sync.stop()
        return (dict(bs.db._data), dict(ss.db._data),
                sync.state.last_block_height, sw.reports, applied)

    return run(main())


@pytest.mark.parametrize("liar", [False, True], ids=["clean", "lying_peer"])
def test_catch_up_matches_jax(chain, liar):
    port = _catch_up(T, chain, liar)
    jax = _catch_up(J, chain, liar)
    bdb, sdb, height, reports, applied = port
    last = len(chain.blocks) - 1           # the tip is left to consensus
    assert height == last
    assert bdb == chain.block_dbs[last - 1]
    assert sdb == chain.state_dbs[last - 1]
    assert (bdb, sdb, height) == jax[:3]
    assert sorted(set(applied)) == list(range(1, last + 1))
    if liar:
        assert reports == jax[3] == [("liar", "bad_block")]
        # the proven prefix applied before the bad height was refetched
        assert applied == list(range(1, last + 1))
        assert applied.index(BAD_AT - 1) == BAD_AT - 2
    else:
        assert reports == jax[3] == []
    assert applied == jax[4]
