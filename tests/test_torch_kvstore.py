"""The port's kvstore application (``cometbft_tpu_torch/abci/kvstore.py``)
and the merkle helpers it uses (``kv_leaf``, ``ValueOp``,
``hash_from_byte_slices_fast``) against the JAX package's, on the CPU:
the same transactions (keys and values from numpy seeds, validator
updates, malformed txs) give equal responses, equal app hashes after
every block, equal proven queries (ProofOp bytes), equal snapshot
chunks, and each package restores the other's snapshot."""

import asyncio
import base64
import dataclasses
import json

import numpy as np
import pytest

from cometbft_tpu.abci import types as JA
from cometbft_tpu.abci.kvstore import KVStoreApplication as JApp
from cometbft_tpu.crypto import merkle as JM
from cometbft_tpu_torch.abci import types as TA
from cometbft_tpu_torch.abci.kvstore import KVStoreApplication as TApp
from cometbft_tpu_torch.crypto import merkle as TM

pytestmark = pytest.mark.timeout(120)


def _norm(x):
    """A response as plain data, type names dropped (the packages'
    dataclasses have the same fields in the same order)."""
    if dataclasses.is_dataclass(x):
        return {f.name: _norm(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, (list, tuple)):
        return [_norm(v) for v in x]
    if isinstance(x, dict):
        return {k: _norm(v) for k, v in x.items()}
    return x


def _txs(rng, n, n_keys):
    out = []
    for _ in range(n):
        r = rng.random()
        if r < 0.08:
            out.append(b"no-equals-sign")
        elif r < 0.14:
            pk = rng.integers(0, 256, 32, np.uint8).tobytes()
            out.append(b"val:" + base64.b64encode(pk) + b"!%d"
                       % int(rng.integers(0, 20)))
        elif r < 0.16:
            out.append(b"val:not-base64!!3")
        else:
            k = b"key%d" % int(rng.integers(0, n_keys))
            v = rng.integers(0, 256, int(rng.integers(0, 40)),
                             np.uint8).tobytes().replace(b"=", b"+")
            out.append(k + b"=" + v)
    return out


def _run(coro):
    return asyncio.run(coro)


async def _drive(app, A, blocks, init):
    """Every response of a run over ``blocks`` (lists of txs)."""
    out = [_norm(await app.init_chain(A.InitChainRequest(**init)))]
    for h, txs in enumerate(blocks, start=1):
        out.append([_norm(await app.check_tx(tx)) for tx in txs])
        out.append(await app.process_proposal(A.ProcessProposalRequest(
            txs=txs, height=h, time_ns=h, hash=b"\x00" * 32,
            proposer_address=b"\x01" * 20, misbehavior=[])))
        out.append(_norm(await app.finalize_block(A.FinalizeBlockRequest(
            txs=txs, height=h, time_ns=h, hash=b"\x00" * 32,
            proposer_address=b"\x01" * 20, decided_last_commit=None,
            misbehavior=[], syncing_to_height=h))))
        out.append(_norm(await app.commit()))
        out.append(app.app_hash)
        out.append(_norm(await app.extend_vote(h, 0, b"\x00" * 32)))
        for ext in (b"ext" + h.to_bytes(8, "big"), b"bad"):
            out.append(_norm(await app.verify_vote_extension(
                h, 0, b"\x01" * 20, b"\x00" * 32, ext)))
    out.append(_norm(await app.info()))
    return out


@pytest.mark.parametrize("seed,n_blocks,n_txs,n_keys", [
    (1, 3, 5, 10), (2, 4, 40, 200), (3, 2, 120, 500)])
def test_same_txs_same_responses_and_app_hashes(seed, n_blocks, n_txs,
                                                n_keys):
    rng = np.random.default_rng(seed)
    blocks = [_txs(rng, n_txs, n_keys) for _ in range(n_blocks)]
    pk = rng.integers(0, 256, 32, np.uint8).tobytes()
    init = dict(chain_id="kv", initial_height=1, time_ns=0,
                app_state_bytes=json.dumps({"g%d" % i: "v%d" % i
                                            for i in range(5)}).encode())
    tapp, japp = TApp(device="cpu"), JApp()
    t = _run(_drive(tapp, TA, blocks, dict(init, validators=[
        TA.ValidatorUpdate("ed25519", pk, 10)])))
    j = _run(_drive(japp, JA, blocks, dict(init, validators=[
        JA.ValidatorUpdate("ed25519", pk, 10)])))
    assert t == j
    assert tapp.state == japp.state and tapp.validators == japp.validators
    # proven queries: equal ProofOps, verified by both packages' ValueOp
    keys = sorted(tapp.state)[:6] + [b"absent"]
    for k in keys:
        tq = _run(tapp.query("/store", k, 0, True))
        jq = _run(japp.query("/store", k, 0, True))
        assert _norm(tq) == _norm(jq)
        if tq.proof_ops:
            (op,) = tq.proof_ops
            top = TM.ValueOp.decode(TM.ProofOp(op["type"], op["key"],
                                               op["data"]))
            assert top.run([tapp.state[k]]) == [tapp.app_hash]
            jop = JM.ValueOp.decode(JM.ProofOp(op["type"], op["key"],
                                               op["data"]))
            assert jop.run([tapp.state[k]]) == [tapp.app_hash]
            with pytest.raises(TM.ProofOpError):
                top.run([tapp.state[k] + b"x"])


def test_snapshots_equal_and_restore_across_packages():
    rng = np.random.default_rng(4)
    blocks = [_txs(rng, 60, 300) for _ in range(3)]
    init = dict(chain_id="kv", initial_height=1, time_ns=0, validators=[],
                app_state_bytes=b"{}")
    tapp, japp = TApp(device="cpu"), JApp()
    _run(_drive(tapp, TA, blocks, init))
    _run(_drive(japp, JA, blocks, init))
    ts, js = _run(tapp.list_snapshots()), _run(japp.list_snapshots())
    assert _norm(ts) == _norm(js)
    snap = ts[-1]
    chunks = [_run(tapp.load_snapshot_chunk(snap.height, 1, i))
              for i in range(snap.chunks)]
    assert chunks == [_run(japp.load_snapshot_chunk(snap.height, 1, i))
                      for i in range(snap.chunks)]
    # the JAX package's chunks restore a fresh port app, and back
    for dst, A, src_chunks, sn in (
            (TApp(device="cpu"), TA, chunks, TA.Snapshot(**_norm(snap))),
            (JApp(), JA, chunks, JA.Snapshot(**_norm(snap)))):
        assert _run(dst.offer_snapshot(sn, b"")) == A.OFFER_SNAPSHOT_ACCEPT
        for i in reversed(range(len(src_chunks))):
            assert _run(dst.apply_snapshot_chunk(i, src_chunks[i], "p")) \
                == A.APPLY_CHUNK_ACCEPT
        assert dst.app_hash == tapp.app_hash and dst.state == tapp.state
    bad = TApp(device="cpu")
    _run(bad.offer_snapshot(TA.Snapshot(**_norm(snap)), b""))
    res = [_run(bad.apply_snapshot_chunk(i, b"\x00" * len(c), "p"))
           for i, c in enumerate(chunks)]
    assert res[-1] == TA.APPLY_CHUNK_RETRY
    assert _run(TApp(device="cpu").offer_snapshot(
        TA.Snapshot(height=1, format=2, chunks=1, hash=b""), b"")) == \
        TA.OFFER_SNAPSHOT_REJECT_FORMAT


@pytest.mark.parametrize("n", [0, 1, 7, 63, 64, 65, 300, 2047])
def test_kv_leaf_and_fast_root_match_jax(n):
    rng = np.random.default_rng(n)
    values = [rng.integers(0, 256, int(rng.integers(0, 50)),
                           np.uint8).tobytes() for _ in range(n)]
    items = [TM.kv_leaf(b"k%d" % i, v) for i, v in enumerate(values)]
    assert items == [JM.kv_leaf(b"k%d" % i, v) for i, v in enumerate(values)]
    assert TM.hash_from_byte_slices_fast(items, device="cpu") == \
        JM.hash_from_byte_slices_fast(items)
    if n:
        _, tps = TM.proofs_from_byte_slices(items, device="cpu")
        _, jps = JM.proofs_from_byte_slices(items)
        i = n // 2
        top = TM.ValueOp(b"k", tps[i]).proof_op()
        jop = JM.ValueOp(b"k", jps[i]).proof_op()
        assert (top.type, top.key, top.data) == (jop.type, jop.key, jop.data)
