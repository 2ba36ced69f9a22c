"""The port's app handshake (``cometbft_tpu_torch/consensus/replay.py``
``Handshaker`` over ``proxy/multi_app_conn.py``) against the JAX
package's, on the CPU.  A kvstore chain of 4 validators is made by the
JAX package's ``BlockExecutor`` (txs from numpy seeds, commits signed
as in ``tests/torch_blocksync_fixtures.py``); its stores, carried into
the port byte for byte, are handshaken by both packages with the same
app height:

- a fresh chain (InitChain at height 0);
- an app behind the stores (the stored blocks replayed into it);
- a crash between SaveBlock and ApplyBlock (the stored block applied);
- an app ahead of the state (the same error in both).

The app hash, the app's height and every state-store record must be
equal.  The port's commit checks run on ``"cpu"`` (the plain
versions), never the host oracle."""

import numpy as np
import pytest
import torch

from cometbft_tpu.abci.kvstore import KVStoreApplication as JKV
from cometbft_tpu.consensus.replay import HandshakeError as JHandshakeError
from cometbft_tpu.consensus.replay import Handshaker as JHandshaker
from cometbft_tpu.mempool.mempool import NopMempool as JNop
from cometbft_tpu.proxy.multi_app_conn import AppConns as JAppConns
from cometbft_tpu.proxy.multi_app_conn import \
    local_client_creator as j_creator
from cometbft_tpu.sm.execution import BlockExecutor as JExecutor
from cometbft_tpu.storage.blockstore import BlockStore as JBlockStore
from cometbft_tpu.storage.db import MemDB as JMemDB
from cometbft_tpu.storage.statestore import State as JState
from cometbft_tpu.storage.statestore import StateStore as JStateStore
from cometbft_tpu.types.block_id import BlockID as JBlockID
from cometbft_tpu.types.commit import ExtendedCommit as JExtCommit
from cometbft_tpu_torch.abci.kvstore import KVStoreApplication
from cometbft_tpu_torch.consensus.replay import HandshakeError, Handshaker
from cometbft_tpu_torch.crypto import _ed25519_py as ref
from cometbft_tpu_torch.crypto.keys import Ed25519PubKey
from cometbft_tpu_torch.mempool.mempool import NopMempool
from cometbft_tpu_torch.proxy import AppConns, local_client_creator
from cometbft_tpu_torch.sm.execution import BlockExecutor
from cometbft_tpu_torch.storage.blockstore import BlockStore
from cometbft_tpu_torch.storage.db import MemDB
from cometbft_tpu_torch.storage.statestore import State, StateStore
from cometbft_tpu_torch.types.genesis import GenesisDoc, GenesisValidator
from cometbft_tpu_torch.types.params import default_consensus_params

from torch_blocksync_fixtures import (genesis, privs, run,
                                      sign_ext_commit)

torch.set_num_threads(1)

pytestmark = pytest.mark.timeout(150)

HEIGHTS = 6


class _TxMempool(JNop):
    """A JAX mempool stand-in whose reap hands the proposer the txs of
    the height being built."""

    def __init__(self, txs_by_height):
        self.txs_by_height = txs_by_height
        self.height = 0

    def reap_max_bytes_max_gas(self, max_bytes, max_gas):
        return list(self.txs_by_height.get(self.height, []))


@pytest.fixture(scope="module")
def kv_chain():
    rng = np.random.default_rng(12)
    txs = {h: [b"k%d-%d=%s" % (h, i, rng.integers(0, 256, 8,
                                                   dtype=np.uint8)
                               .tobytes().hex().encode())
               for i in range(int(rng.integers(1, 4)))]
           for h in range(1, HEIGHTS + 1)}
    keys = privs()
    by_addr = {k.pub_key().address(): k for k in keys}
    doc = genesis(keys, ext_height=0)

    async def build():
        bdb, sdb = JMemDB(), JMemDB()
        bs, ss = JBlockStore(bdb), JStateStore(sdb)
        conns = JAppConns(j_creator(JKV()))
        await conns.start()
        mp = _TxMempool(txs)
        ex = JExecutor(ss, bs, conns.consensus, mp, backend="cpu")
        state = await JHandshaker(ss, bs, doc).handshake(
            JState.from_genesis(doc), conns, ex)
        snaps = [(dict(bdb._data), dict(sdb._data))]
        last_ext = JExtCommit(0, 0, JBlockID(), [])
        for h in range(1, HEIGHTS + 1):
            mp.height = h
            block, parts = await ex.create_proposal_block(
                h, state, last_ext, state.validators.get_proposer().address,
                10**18 + h * 10**9)
            bid = JBlockID(block.hash(), parts.header())
            ext = sign_ext_commit(state, bid, h, by_addr, False)
            bs.save_block(block, parts, ext.to_commit())
            state = await ex.apply_block(state, bid, block)
            snaps.append((dict(bdb._data), dict(sdb._data)))
            last_ext = ext
        return doc, snaps, state.app_hash

    return run(build())


@pytest.fixture(autouse=True)
def no_host_verify(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("host oracle called on the handshake path")

    monkeypatch.setattr(ref, "verify_zip215", refuse)


def _port_genesis(doc):
    p = default_consensus_params()
    p.feature.vote_extensions_enable_height = \
        doc.consensus_params.feature.vote_extensions_enable_height
    return GenesisDoc(
        doc.chain_id, genesis_time_ns=doc.genesis_time_ns,
        consensus_params=p,
        validators=[GenesisValidator(Ed25519PubKey(v.pub_key.bytes()),
                                     v.power) for v in doc.validators])


async def _replay_app(app, pkg, blocks, upto):
    """Bring a kvstore app to height ``upto`` by finalizing the stored
    blocks, as a persistent app would have."""
    from cometbft_tpu.abci import types as JA
    from cometbft_tpu_torch.abci import types as TA

    A = TA if pkg == "port" else JA
    for h in range(1, upto + 1):
        b = blocks.load_block(h)
        await app.finalize_block(A.FinalizeBlockRequest(
            txs=list(b.data.txs), height=h, time_ns=b.header.time_ns,
            hash=b.hash(), proposer_address=b.header.proposer_address,
            decided_last_commit=b.last_commit))
        await app.commit()


async def _handshake(pkg, doc, snap, app_height):
    """One package's handshake over the stores ``snap`` with a kvstore
    app at ``app_height``: (outcome, app info, state-store records)."""
    bdata, sdata = snap
    if pkg == "port":
        bdb, sdb = MemDB(), MemDB()
        bdb._data.update(bdata)
        sdb._data.update(sdata)
        bs, ss = BlockStore(bdb), StateStore(sdb)
        gdoc = _port_genesis(doc)
        app = KVStoreApplication(device="cpu")
        conns = AppConns(local_client_creator(app))
        mk = (lambda: BlockExecutor(ss, bs, conns.consensus, NopMempool(),
                                    device="cpu"))
        hs, st0, err = Handshaker(ss, bs, gdoc), State, HandshakeError
    else:
        bdb, sdb = JMemDB(), JMemDB()
        bdb._data.update(bdata)
        sdb._data.update(sdata)
        bs, ss = JBlockStore(bdb), JStateStore(sdb)
        gdoc = doc
        app = JKV()
        conns = JAppConns(j_creator(app))
        mk = (lambda: JExecutor(ss, bs, conns.consensus, JNop(),
                                backend="cpu"))
        hs, st0, err = JHandshaker(ss, bs, gdoc), JState, JHandshakeError
    await conns.start()
    await _replay_app(conns.consensus, pkg, bs, app_height)
    state = ss.load() or st0.from_genesis(gdoc)
    try:
        out = await hs.handshake(state, conns, mk())
        outcome = ("ok", out.last_block_height, out.app_hash)
    except err as e:
        outcome = ("error", str(e))
    info = await conns.query.info()
    return outcome, (info.last_block_height, info.last_block_app_hash), \
        dict(sdb._data)


def _both(doc, snap, app_height):
    return (run(_handshake("port", doc, snap, app_height)),
            run(_handshake("jax", doc, snap, app_height)))


def test_fresh_chain_init_chain(kv_chain):
    doc, snaps, _ = kv_chain
    t, j = _both(doc, ({}, {}), 0)
    assert t == j
    assert t[0][0] == "ok" and t[0][1] == 0


@pytest.mark.parametrize("app_height", [0, 2, HEIGHTS])
def test_app_behind_replays_stored_blocks(kv_chain, app_height):
    doc, snaps, tip_hash = kv_chain
    t, j = _both(doc, snaps[HEIGHTS], app_height)
    assert t == j
    assert t[0] == ("ok", HEIGHTS, tip_hash)
    assert t[1] == (HEIGHTS, tip_hash)


@pytest.mark.parametrize("app_height", [0, 3])
def test_block_saved_not_applied(kv_chain, app_height):
    """Block store at H, state store at H - 1: the handshake applies the
    stored block through the executor (its last commit checked on the
    device)."""
    doc, snaps, tip_hash = kv_chain
    snap = (snaps[HEIGHTS][0], snaps[HEIGHTS - 1][1])
    t, j = _both(doc, snap, app_height)
    assert t == j
    assert t[0] == ("ok", HEIGHTS, tip_hash)


def test_app_ahead_of_state_refused(kv_chain):
    doc, snaps, _ = kv_chain
    snap = (snaps[HEIGHTS][0], snaps[2][1])
    t, j = _both(doc, snap, HEIGHTS)
    assert t[0] == j[0] and t[0][0] == "error"


@pytest.mark.parametrize("retain", [(3, 0), (5, 2), (0, 4)])
def test_pruner_prunes_like_jax(kv_chain, retain):
    """The same stores and retain heights (app, companion) leave the two
    packages' block and state stores with equal records."""
    from cometbft_tpu.sm.pruner import Pruner as JPruner
    from cometbft_tpu_torch.sm.pruner import Pruner

    doc, snaps, _ = kv_chain
    bdata, sdata = snaps[HEIGHTS]
    out = []
    for P, DB, BS, SS in ((Pruner, MemDB, BlockStore, StateStore),
                          (JPruner, JMemDB, JBlockStore, JStateStore)):
        bdb, sdb = DB(), DB()
        bdb._data.update(bdata)
        sdb._data.update(sdata)
        pr = P(SS(sdb), BS(bdb), name="p")
        pr.set_app_retain_height(retain[0])
        pr.set_companion_retain_height(retain[1])
        pruned = pr.prune_once()
        out.append((pruned, pr.retain_heights(),
                    pr.effective_retain_height(), dict(bdb._data),
                    dict(sdb._data)))
    assert out[0] == out[1]


def test_config_defaults_match_jax():
    """Every field of the port's config sections has the JAX package's
    default; ``device`` stands for ``signature_backend``, and
    ``p2p.pong_timeout`` (the port's own key) is upstream's 45 s where
    the JAX package holds a fixed 5 s."""
    import dataclasses

    from cometbft_tpu import config as jcfg
    from cometbft_tpu.p2p import conn as jconn
    from cometbft_tpu_torch import config as tcfg

    port, jax = tcfg.Config(), jcfg.Config()
    for sec in dataclasses.fields(port):
        ours, theirs = getattr(port, sec.name), getattr(jax, sec.name)
        for f in dataclasses.fields(ours):
            if f.name == "device":
                assert ours.device == "cuda"
                assert theirs.signature_backend == "auto"
                continue
            if (sec.name, f.name) == ("p2p", "pong_timeout"):
                assert ours.pong_timeout == 45.0
                assert jconn.DEFAULT_PONG_TIMEOUT == 5.0
                continue
            assert getattr(ours, f.name) == getattr(theirs, f.name), \
                (sec.name, f.name)


def test_app_conns_match_jax():
    """Four logical connections over one in-process app: the same calls
    give the same answers in both packages, each call observed in
    ``abci_call_seconds`` under its connection."""
    from cometbft_tpu.abci import types as JA
    from cometbft_tpu.libs import metrics as jm
    from cometbft_tpu_torch.abci import types as TA
    from cometbft_tpu_torch.libs import metrics as tm

    async def calls(conns_cls, creator, app, A):
        conns = conns_cls(creator(app), node="ac")
        await conns.start()
        assert len({id(c) for c in (conns.consensus, conns.mempool,
                                    conns.query, conns.snapshot)}) == 4
        out = [await conns.mempool.check_tx(b"a=1"),
               await conns.consensus.finalize_block(A.FinalizeBlockRequest(
                   txs=[b"a=1", b"b=2"], height=1, time_ns=5, hash=b"h",
                   proposer_address=b"p" * 20)),
               await conns.consensus.commit(),
               await conns.query.info(),
               await conns.query.query("/store", b"a")]
        await conns.stop()
        return [(type(o).__name__, repr(getattr(o, "__dict__", o)))
                for o in out]

    t = run(calls(AppConns, local_client_creator,
                  KVStoreApplication(device="cpu"), TA))
    j = run(calls(JAppConns, j_creator, JKV(), JA))
    assert t == j
    h = tm.histogram("abci_call_seconds")
    assert h.count(conn="mempool", method="check_tx") >= 1
    assert jm.histogram("abci_call_seconds").count(
        conn="mempool", method="check_tx") >= 1
