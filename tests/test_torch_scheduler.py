"""The port's verification scheduler and verified-signature cache
(``cometbft_tpu_torch/crypto/scheduler.py``) against the JAX package's
(``cometbft_tpu/crypto/scheduler.py``), on the CPU: the port's scheduler
runs on ``device="cpu"`` (the kernels' plain versions), the JAX package's
on ``backend="cpu"``.  Keys and messages come from numpy seeds; verdicts,
cache contents, dedup and flush counts must agree, case by case, with
``tests/test_vote_scheduler.py``'s semantic cases.

Cases of that file not mirrored, because the port differs on purpose:

- ``test_snap_lane_cap_buckets``: the lane cap is the configured size,
  unsnapped (the JAX package snaps it to a TPU compile bucket; the
  port's kernels take any lane count): ``test_lane_cap_is_not_snapped``;
- the direct-verify fallbacks (a batch of one, a ``verify_sync`` miss,
  the dispatch-failure recovery, the deadline): the JAX package verifies
  on the host there, the port runs a one-lane device check, counted in
  ``stats()["single_checks"]``; a recovery that fails too reaches the
  caller (``test_persistent_dispatch_error_reaches_the_caller``);
- with no scheduler registered, ``verify_cached`` and ``verify_uncached``
  raise instead of verifying on the host
  (``test_no_card_and_no_scheduler_raise``)."""

import asyncio

import numpy as np
import pytest
import torch

from cometbft_tpu.crypto import scheduler as jsched
from cometbft_tpu.crypto.keys import Ed25519PrivKey as JPriv
from cometbft_tpu.libs import failures as JF
from cometbft_tpu_torch.crypto import _ed25519_py as ref
from cometbft_tpu_torch.crypto import scheduler as vsched
from cometbft_tpu_torch.crypto.keys import Ed25519PrivKey as TPriv
from cometbft_tpu_torch.crypto.scheduler import (VerificationScheduler,
                                                 VerifiedSigCache, cache_key)
from cometbft_tpu_torch.libs import failures as F
from cometbft_tpu_torch.types.block_id import BlockID, PartSetHeader
from cometbft_tpu_torch.types.validation import (ErrInvalidSignature,
                                                 VerifyCommit,
                                                 VerifyCommitLightAllSignatures)
from cometbft_tpu_torch.types.validator_set import Validator, ValidatorSet
from cometbft_tpu_torch.types.vote import PRECOMMIT_TYPE, PREVOTE_TYPE, Vote
from cometbft_tpu_torch.types.vote_set import (ConflictingVoteError, VoteSet,
                                               VoteSetError)

torch.set_num_threads(1)

CHAIN = "sched-test"
pytestmark = pytest.mark.timeout(120)


@pytest.fixture(autouse=True)
def _no_global_scheduler():
    vsched.set_scheduler(None)
    jsched.set_scheduler(None)
    yield
    vsched.set_scheduler(None)
    jsched.set_scheduler(None)
    F.reset()
    JF.reset()


def _keys(n, seed):
    rng = np.random.default_rng(seed)
    seeds = [rng.integers(0, 256, 32, np.uint8).tobytes() for _ in range(n)]
    return [TPriv(s) for s in seeds], rng


def _signed(n=4, msg_len=64, seed=1):
    """(port items, JAX items): the same (pub, msg, sig) triples as each
    package's key objects."""
    privs, rng = _keys(n, seed)
    tp, jp = [], []
    for p in privs:
        msg = rng.integers(0, 256, msg_len, np.uint8).tobytes()
        sig = p.sign(msg)
        tp.append((p.pub_key(), msg, sig))
        jp.append((JPriv(p.bytes()).pub_key(), msg, sig))
    return tp, jp


def _run(coro):
    return asyncio.run(coro)


def _flushes(sched, reason):
    return sched._m[6].value(reason=reason)


async def _jax_verdicts(items, **kw):
    s = jsched.VerificationScheduler(backend="cpu", **kw)
    await s.start()
    try:
        return await asyncio.gather(*(s.verify(p, m, g) for p, m, g in items))
    finally:
        await s.stop()


# ------------------------------------------------------------- unit: cache

def test_cache_lru_bound_and_positive_only():
    keys = [cache_key(bytes([i]) * 32, b"m%d" % i, b"s" * 64)
            for i in range(5)]
    for c in (VerifiedSigCache(max_size=3), jsched.VerifiedSigCache(3)):
        for k in keys:
            c.seed(k)
        assert len(c) == 3
        assert not c.hit(keys[0]) and not c.hit(keys[1])
        assert c.hit(keys[2]) and c.hit(keys[3]) and c.hit(keys[4])
        c.hit(keys[2])
        c.seed(keys[0])
        c.seed(keys[1])
        assert c.hit(keys[2])
        assert not c.hit(keys[3])
    assert keys[0] == jsched.cache_key(bytes([0]) * 32, b"m0", b"s" * 64)


def test_cache_size_zero_disables():
    c = VerifiedSigCache(max_size=0)
    k = cache_key(b"p" * 32, b"m", b"s" * 64)
    c.seed(k)
    assert not c.hit(k)


def test_lane_cap_is_not_snapped():
    for n in (256, 300, 4, 17, 100000):
        assert VerificationScheduler(device="cpu", max_lanes=n).max_lanes == n
    assert jsched.snap_lane_cap(300) == 256      # the JAX package snaps
    assert VerificationScheduler(device="cpu", max_lanes=0).max_lanes == 1


def test_verify_timeout_default_floors_at_one_second():
    for kw in ({"max_wait_ms": 2.0}, {"max_wait_ms": 500.0},
               {"max_wait_ms": 1.0, "verify_timeout_s": 0.3}):
        assert VerificationScheduler(device="cpu", **kw).verify_timeout_s \
            == jsched.VerificationScheduler(backend="cpu",
                                            **kw).verify_timeout_s


def test_no_card_and_no_scheduler_raise():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            VerificationScheduler()              # device None: CUDA
    (pub, msg, sig), = _signed(1)[0]
    with pytest.raises(RuntimeError, match="no verification scheduler"):
        vsched.verify_cached(pub, msg, sig)
    with pytest.raises(RuntimeError, match="no verification scheduler"):
        vsched.verify_uncached(pub, msg, sig)
    assert not vsched.cache_active() and not vsched.dense_cache_active()
    assert not vsched.cache_lookup(pub.bytes(), msg, sig)
    vsched.cache_seed(pub.bytes(), msg, sig)     # no scheduler: a no-op


# --------------------------------------------------------- flush ordering

def test_window_flush_fires_without_filling_lanes():
    tp, jp = _signed(3)

    async def main():
        s = VerificationScheduler(device="cpu", max_wait_ms=20,
                                  max_lanes=256)
        await s.start()
        try:
            w0, z0 = _flushes(s, "window"), _flushes(s, "size")
            oks = await asyncio.gather(*(s.verify(*it) for it in tp))
            assert oks == [True, True, True]
            assert _flushes(s, "window") - w0 >= 1
            assert _flushes(s, "size") - z0 == 0
            st = s.stats()
            assert st["batches"] == 1 and st["batch_lanes"] == 3
            assert st["single_checks"] == {}     # one 3-lane batch
        finally:
            await s.stop()
        return oks

    assert _run(main()) == _run(_jax_verdicts(jp, max_wait_ms=20))


def test_size_flush_preempts_window():
    tp, _ = _signed(16)

    async def main():
        s = VerificationScheduler(device="cpu", max_wait_ms=30_000,
                                  max_lanes=16)
        await s.start()
        try:
            occ = s._m[0]
            c0, sum0 = occ.count(), occ.sum()
            z0 = _flushes(s, "size")
            oks = await asyncio.wait_for(asyncio.gather(
                *(s.verify(*it) for it in tp)), timeout=60)
            assert all(oks)
            assert _flushes(s, "size") - z0 == 1
            assert occ.count() - c0 == 1 and occ.sum() - sum0 == 16
        finally:
            await s.stop()

    _run(main())


# ------------------------------------------------- demux and cache safety

def test_mixed_batch_matches_jax_per_item_verdicts():
    tp, jp = _signed(24, seed=7)
    rng = np.random.default_rng(42)
    corrupted = sorted(int(i) for i in rng.choice(24, 6, replace=False))
    for i in corrupted:
        for items in (tp, jp):
            pub, msg, sig = items[i]
            items[i] = (pub, msg, bytes([sig[0] ^ 0x5A]) + sig[1:])
    expect = [ref.verify_zip215(p.bytes(), m, g) for p, m, g in tp]
    assert [i for i, ok in enumerate(expect) if not ok] == corrupted

    async def main():
        s = VerificationScheduler(device="cpu", max_wait_ms=5,
                                  max_lanes=256)
        await s.start()
        try:
            got = await asyncio.gather(*(s.verify(*it) for it in tp))
            assert len(s.cache) == 24 - len(corrupted)
            for i in corrupted:
                pub, msg, sig = tp[i]
                assert not s.cache.hit(cache_key(pub.bytes(), msg, sig))
                assert not await s.verify(pub, msg, sig)
            return got
        finally:
            await s.stop()

    got = _run(main())
    assert got == expect == _run(_jax_verdicts(jp, max_wait_ms=5))


def test_duplicate_suppression_counts():
    (item,), (jitem,) = _signed(1)

    async def main(s, it):
        await s.start()
        try:
            oks = await asyncio.gather(*(s.verify(*it) for _ in range(9)))
            st = s.stats()
            assert await s.verify(*it)
            return oks, st, s.stats()
        finally:
            await s.stop()

    t = _run(main(VerificationScheduler(device="cpu", max_wait_ms=5), item))
    j = _run(main(jsched.VerificationScheduler(backend="cpu",
                                               max_wait_ms=5), jitem))
    for oks, st, after in (t, j):
        assert oks == [True] * 9
        assert st["dedup_inflight"] == 8 and st["lanes_ok"] == 1
        assert after["cache_hits"] - st["cache_hits"] == 1
    assert t[1]["single_checks"] == {}           # one 1-lane batch


def test_submit_nowait_callbacks_and_cache_hit_sync():
    (item,), _ = _signed(1)

    async def main():
        s = VerificationScheduler(device="cpu", max_wait_ms=5)
        await s.start()
        try:
            got: list = []
            fut = asyncio.get_running_loop().create_future()
            s.submit_nowait(*item, on_done=lambda ok: (
                got.append(ok), fut.set_result(None)))
            await asyncio.wait_for(fut, 30)
            assert got == [True]
            s.submit_nowait(*item, on_done=got.append)
            assert got == [True, True]
            # a callback that raises does not poison the demux
            bad = (item[0], item[1], b"\x01" * 64)
            fut2 = asyncio.get_running_loop().create_future()

            def boom(ok):
                fut2.set_result(ok)
                raise RuntimeError("callback fault")

            s.submit_nowait(*bad, on_done=boom)
            assert await asyncio.wait_for(fut2, 30) is False
        finally:
            await s.stop()

    _run(main())


def test_clean_stop_resolves_inflight_requests():
    tp, _ = _signed(5)

    async def main():
        s = VerificationScheduler(device="cpu", max_wait_ms=60_000)
        await s.start()
        tasks = [asyncio.create_task(s.verify(*it)) for it in tp]
        await asyncio.sleep(0.05)
        assert not any(t.done() for t in tasks)
        st0 = _flushes(s, "stop")
        await asyncio.wait_for(s.stop(), timeout=60)
        oks = await asyncio.wait_for(asyncio.gather(*tasks), timeout=30)
        assert oks == [True] * 5
        assert _flushes(s, "stop") - st0 == 1
        assert not s._pending and not s._inflight
        # stopped: a miss is one lane checked alone, on the device
        p2, _ = _signed(1, seed=3)
        assert await s.verify(*p2[0])
        assert s.stats()["single_checks"] == {"direct": 1}

    _run(main())


def test_dispatch_failure_resolves_every_batchmate_with_real_verdicts():
    """The ``sched.dispatch.raise`` site: the failed batch is verified
    again item by item, one lane a device call, and every future and
    callback gets its real verdict, as in the JAX package."""
    tp, jp = _signed(4)
    bad_t = (tp[2][0], tp[2][1], b"\x00" * 64)
    bad_j = (jp[2][0], jp[2][1], b"\x00" * 64)

    async def main(s, items, bad, fail):
        fail.configure(enabled=True, seed=1,
                       faults=["sched.dispatch.raise:at=1"])
        try:
            await s.start()
            cb = {}
            s.submit_nowait(*bad, on_done=lambda ok: cb.setdefault("bad",
                                                                   ok))
            oks = await asyncio.wait_for(asyncio.gather(
                *[s.verify(*it) for it in items]), timeout=60)
            sites = [e["site"] for e in fail.events()]
            extra = _signed(1, seed=9)
            nxt = await s.verify(*(extra[0] if fail is F else extra[1])[0])
            st = s.stats()
            await s.stop()
            return oks, cb, sites, nxt, st
        finally:
            fail.reset()

    # the plain versions take about 0.4 s a lane here: a deadline past
    # the recovery's five lanes keeps the overdue path out of this case
    t = _run(main(VerificationScheduler(device="cpu", max_wait_ms=1.0,
                                        verify_timeout_s=60), tp, bad_t, F))
    j = _run(main(jsched.VerificationScheduler(backend="cpu",
                                               max_wait_ms=1.0), jp, bad_j,
                  JF))
    assert t[:4] == j[:4]
    assert t[0] == [True] * 4 and t[1] == {"bad": False}
    assert t[2] == ["sched.dispatch.raise"] and t[3] is True
    assert t[4]["single_checks"] == {"recover": 5}


def test_persistent_dispatch_error_reaches_the_caller(monkeypatch):
    """Where the batch and its item-by-item recovery both fail, an
    awaiting caller whose lane also fails alone gets the exception, and
    a callback gets False (nothing cached, so the consensus handler
    verifies the vote again and meets the error itself)."""
    (item,), _ = _signed(1)

    def broken(self, items):
        raise RuntimeError("device lost")

    async def main():
        s = VerificationScheduler(device="cpu", max_wait_ms=1.0,
                                  verify_timeout_s=60)
        await s.start()
        monkeypatch.setattr(VerificationScheduler, "_check_lanes", broken)
        try:
            cb = {}
            s.submit_nowait(*item, on_done=lambda ok: cb.setdefault("v",
                                                                    ok))
            with pytest.raises(RuntimeError, match="device lost"):
                await asyncio.wait_for(s.verify(*item), timeout=30)
            assert cb == {"v": False}
            assert len(s.cache) == 0
            with pytest.raises(RuntimeError, match="device lost"):
                s.verify_sync(*item)
        finally:
            monkeypatch.undo()
            await s.stop()

    _run(main())


def test_verify_deadline_falls_back_to_a_device_lane():
    """A wedged flush path trips the bounded wait; the caller checks its
    lane alone on the device, off the device-owner queue, and seeds the
    cache, as the JAX package's deadline fallback does on the host."""
    (item,), _ = _signed(1)

    async def main():
        s = VerificationScheduler(device="cpu", max_wait_ms=1.0,
                                  verify_timeout_s=0.3)
        await s.start()
        s._flush = lambda reason: None
        t0 = asyncio.get_event_loop().time()
        ok = await asyncio.wait_for(s.verify(*item), timeout=30)
        dt = asyncio.get_event_loop().time() - t0
        assert ok and dt >= 0.25
        assert s.cache.hit(cache_key(item[0].bytes(), *item[1:]))
        assert s.stats()["single_checks"] == {"overdue": 1}
        del s._flush
        await s.stop()

    _run(main())


# ------------------------------------------------------ VoteSet integration

def _valset(n, seed=5):
    privs, _ = _keys(n, seed)
    vals = ValidatorSet([Validator(p.pub_key(), 10) for p in privs])
    by_addr = {p.pub_key().address(): p for p in privs}
    return vals, by_addr


def _vote(vals, by_addr, i, bid, typ=PREVOTE_TYPE, height=3):
    v = vals.get_by_index(i)
    vote = Vote(type=typ, height=height, round=0, block_id=bid,
                timestamp_ns=5_000 + i, validator_address=v.address,
                validator_index=i)
    vote.signature = by_addr[v.address].sign(vote.sign_bytes(CHAIN))
    return vote


def test_vote_set_rides_scheduler_cache():
    async def main():
        s = await vsched.acquire_scheduler(device="cpu", max_wait_ms=2,
                                           max_lanes=64)
        try:
            vals, by_addr = _valset(4)
            bid = BlockID(b"\x07" * 32, PartSetHeader(1, b"\x08" * 32))
            votes = [_vote(vals, by_addr, i, bid) for i in range(4)]
            await asyncio.gather(*(
                s.verify(vals.get_by_index(v.validator_index).pub_key,
                         v.sign_bytes(CHAIN), v.signature) for v in votes))
            hits0 = s._m[3].value(source="votes")
            vs = VoteSet(CHAIN, 3, 0, PREVOTE_TYPE, vals)
            for v in votes:
                assert vs.add_vote(v)
            assert s._m[3].value(source="votes") - hits0 == 4
            assert vs.has_two_thirds_majority()
            assert s.stats()["single_checks"] == {}
        finally:
            await vsched.release_scheduler()

    _run(main())


def test_conflicting_vote_never_trusts_cache():
    async def main():
        s = await vsched.acquire_scheduler(device="cpu", max_wait_ms=2,
                                           max_lanes=64)
        try:
            vals, by_addr = _valset(4)
            bid_a = BlockID(b"\x01" * 32, PartSetHeader(1, b"\x02" * 32))
            bid_b = BlockID(b"\x03" * 32, PartSetHeader(1, b"\x04" * 32))
            vs = VoteSet(CHAIN, 3, 0, PREVOTE_TYPE, vals)
            assert vs.add_vote(_vote(vals, by_addr, 0, bid_a))
            bad = _vote(vals, by_addr, 0, bid_b)
            bad.signature = bytes([bad.signature[0] ^ 0xFF]) \
                + bad.signature[1:]
            pub = vals.get_by_index(0).pub_key
            s.cache.seed(cache_key(pub.bytes(), bad.sign_bytes(CHAIN),
                                   bad.signature))
            with pytest.raises(VoteSetError):
                vs.add_vote(bad)
            good = _vote(vals, by_addr, 0, bid_b)
            with pytest.raises(ConflictingVoteError):
                vs.add_vote(good)
            # the first vote by sync miss, both conflicting ones uncached
            assert s.stats()["single_checks"] == {"sync": 1, "uncached": 2}
        finally:
            await vsched.release_scheduler()

    _run(main())


# -------------------------------------------------- VerifyCommit integration

def _commit(vals, by_addr, bid, height):
    vs = VoteSet(CHAIN, height, 0, PRECOMMIT_TYPE, vals)
    votes = [_vote(vals, by_addr, i, bid, typ=PRECOMMIT_TYPE, height=height)
             for i in range(vals.size())]
    return vs, votes


def test_verify_commit_consults_and_seeds_cache():
    async def main():
        s = await vsched.acquire_scheduler(device="cpu", max_wait_ms=2,
                                           max_lanes=64)
        try:
            vals, by_addr = _valset(4)
            bid = BlockID(b"\x05" * 32, PartSetHeader(1, b"\x06" * 32))
            vs, votes = _commit(vals, by_addr, bid, 7)
            await asyncio.gather(*(
                s.verify(vals.get_by_index(v.validator_index).pub_key,
                         v.sign_bytes(CHAIN), v.signature) for v in votes))
            for v in votes:
                vs.add_vote(v)
            commit = vs.make_commit()
            hits0 = s._m[3].value(source="commit")
            miss0 = s._m[4].value(source="commit")
            VerifyCommit(CHAIN, vals, bid, 7, commit, device="cpu")
            assert s._m[3].value(source="commit") - hits0 == 4
            assert s._m[4].value(source="commit") - miss0 == 0
        finally:
            await vsched.release_scheduler()

    _run(main())


def test_verify_commit_seeds_then_second_pass_free():
    vals, by_addr = _valset(4)
    bid = BlockID(b"\x09" * 32, PartSetHeader(1, b"\x0a" * 32))
    _, votes = _commit(vals, by_addr, bid, 9)

    async def main():
        s = await vsched.acquire_scheduler(device="cpu", max_wait_ms=2,
                                           max_lanes=64)
        try:
            vs = VoteSet(CHAIN, 9, 0, PRECOMMIT_TYPE, vals)
            for v in votes:
                vs.add_vote(v)
            commit = vs.make_commit()
            s.cache.clear()          # a commit this node never saw
            miss0 = s._m[4].value(source="commit")
            VerifyCommit(CHAIN, vals, bid, 9, commit, device="cpu")
            assert s._m[4].value(source="commit") - miss0 == 0
            assert len(s.cache) == 0
            v0 = votes[0]
            assert await s.verify(vals.get_by_index(0).pub_key,
                                  v0.sign_bytes(CHAIN), v0.signature)
            VerifyCommit(CHAIN, vals, bid, 9, commit, device="cpu")
            assert len(s.cache) == 4
            hits0 = s._m[3].value(source="commit")
            VerifyCommit(CHAIN, vals, bid, 9, commit, device="cpu")
            assert s._m[3].value(source="commit") - hits0 == 4
        finally:
            await vsched.release_scheduler()

    _run(main())


def test_evidence_variant_bypasses_poisoned_cache():
    async def main():
        s = await vsched.acquire_scheduler(device="cpu", max_wait_ms=2,
                                           max_lanes=64)
        try:
            vals, by_addr = _valset(4)
            bid = BlockID(b"\x0b" * 32, PartSetHeader(1, b"\x0c" * 32))
            vs, votes = _commit(vals, by_addr, bid, 11)
            for v in votes:
                vs.add_vote(v)
            commit = vs.make_commit()
            cs0 = commit.signatures[0]
            cs0.signature = bytes([cs0.signature[0] ^ 0x80]) \
                + cs0.signature[1:]
            s.cache.seed(cache_key(
                vals.get_by_index(0).pub_key.bytes(),
                commit.vote_sign_bytes(CHAIN, 0), cs0.signature))
            with pytest.raises(ErrInvalidSignature):
                VerifyCommitLightAllSignatures(CHAIN, vals, bid, 11,
                                               commit, device="cpu")
            # the cache-trusting VerifyCommit takes the poisoned entry
            VerifyCommit(CHAIN, vals, bid, 11, commit, device="cpu")
        finally:
            await vsched.release_scheduler()

    _run(main())


# ----------------------------------------------------------- feed_vote path

def test_feed_vote_prefetch_enqueues_after_verdict():
    from cometbft_tpu_torch.consensus.state import ConsensusState

    async def main():
        s = await vsched.acquire_scheduler(device="cpu", max_wait_ms=2,
                                           max_lanes=64)
        try:
            vals, by_addr = _valset(4)
            bid = BlockID(b"\x0d" * 32, PartSetHeader(1, b"\x0e" * 32))
            vote = _vote(vals, by_addr, 1, bid, height=1)
            cs = ConsensusState.__new__(ConsensusState)
            cs.queue = asyncio.Queue()
            cs.rs = type("RS", (), {})()
            cs.rs.height = 1
            cs.rs.validators = vals
            cs.rs.last_validators = None
            cs.state = type("S", (), {"chain_id": CHAIN})()
            cs.feed_vote(vote, "peer1")
            kind, payload, peer = await asyncio.wait_for(cs.queue.get(), 30)
            assert (kind, peer) == ("vote", "peer1") and payload is vote
            assert cs.queue.empty()
            pub = vals.get_by_index(1).pub_key
            assert s.cache.hit(cache_key(pub.bytes(), vote.sign_bytes(CHAIN),
                                         vote.signature))
            assert s.stats()["batches"] == 1
            own = _vote(vals, by_addr, 2, bid, height=1)
            cs.feed_vote(own, "")
            _, payload2, peer2 = cs.queue.get_nowait()
            assert payload2 is own and peer2 == ""
        finally:
            await vsched.release_scheduler()

    _run(main())


def test_acquire_release_refcount():
    async def main():
        s1 = await vsched.acquire_scheduler(device="cpu")
        s2 = await vsched.acquire_scheduler(device="cpu")
        assert s1 is s2 and vsched.get_scheduler() is s1
        await vsched.release_scheduler()
        assert vsched.get_scheduler() is s1 and s1.is_running
        await vsched.release_scheduler()
        assert vsched.get_scheduler() is None and not s1.is_running

    _run(main())


def test_scheduler_from_a_dead_loop_is_replaced():
    s1 = _run(vsched.acquire_scheduler(device="cpu"))

    async def main():
        s2 = await vsched.acquire_scheduler(device="cpu")
        assert s2 is not s1 and not s1.is_running
        await vsched.release_scheduler()

    _run(main())
    assert vsched.get_scheduler() is None


def test_sync_check_waits_behind_a_queued_flush(monkeypatch):
    """A ``verify_sync`` miss on the event loop queues on the device-owner
    thread behind a micro-batch already there; the batch needs nothing
    from the loop, so both verdicts arrive (no deadlock)."""
    import threading
    import time

    from cometbft_tpu_torch.crypto import batch as cbatch

    tp, _ = _signed(2, seed=11)
    orig = VerificationScheduler._verify_batch
    ran = []

    def slow_batch(self, batch):
        ran.append(("batch", threading.current_thread().name))
        time.sleep(0.3)
        return orig(self, batch)

    monkeypatch.setattr(VerificationScheduler, "_verify_batch", slow_batch)

    async def main():
        s = VerificationScheduler(device="cpu", max_wait_ms=0.0,
                                  verify_timeout_s=60)
        await s.start()
        try:
            task = asyncio.create_task(s.verify(*tp[0]))
            await asyncio.sleep(0.05)          # the flush is on the thread
            assert ran and ran[0][1].startswith(cbatch.DEVICE_THREAD_NAME)
            assert s.verify_sync(*tp[1]) is True
            assert await asyncio.wait_for(task, 30) is True
            assert s.stats()["single_checks"] == {"sync": 1}
            # on the device-owner thread itself, device_call runs inline
            assert cbatch.device_call(
                lambda: cbatch.device_call(lambda: 7)) == 7
        finally:
            await s.stop()

    _run(main())


def test_verify_sync_all_checks_misses_in_one_call():
    """A precommit and its extension stand or fall together: the cache
    misses of ``verify_sync_all`` go to the device in one call (counted
    once under ``sync``), each passing lane seeds the cache, and one
    bad lane fails the whole (its good partner still seeded)."""
    tp, _ = _signed(3, seed=21)

    async def main():
        s = VerificationScheduler(device="cpu", max_wait_ms=0.0,
                                  verify_timeout_s=60)
        await s.start()
        try:
            assert s.verify_sync(*tp[0]) is True          # seeds tp[0]
            assert s.verify_sync_all([tp[0], tp[1]]) is True
            assert s.stats()["single_checks"] == {"sync": 2}
            assert s.verify_sync_all([tp[0], tp[1]]) is True   # all hits
            assert s.stats()["single_checks"] == {"sync": 2}
            pub, msg, sig = tp[2]
            bad = (pub, msg, bytes([sig[0] ^ 1]) + sig[1:])
            assert s.verify_sync_all([tp[2], bad]) is False
            st = s.stats()
            assert st["single_checks"] == {"sync": 3}
            assert s.cache.hit(vsched.cache_key(pub.bytes(), msg, sig))
        finally:
            await s.stop()

    _run(main())
