"""The port's snapshot fabric (``cometbft_tpu_torch/statesync``) against
the JAX package's, on the CPU: the cases of
``tests/test_statesync_fabric.py`` (not its ``sim/`` fleet scenarios),
each run through both packages on the same inputs and compared exactly:
manifest roots and verdicts, the blob pool and chunk spool, the syncer's
tallies, bans and applied chunks, the fatal-IO spool rule, the state
provider's retries, the ``[statesync]`` bounds, the serving LRU and
admission gate, and the reactor's messages byte for byte (the port packs
with ``types/_msgpack.py``)."""

import asyncio
import errno
import hashlib
from types import SimpleNamespace

import msgpack
import pytest

import cometbft_tpu.abci.client as j_client
import cometbft_tpu.abci.kvstore as j_kv
import cometbft_tpu.abci.types as j_abci
import cometbft_tpu.config as j_config
import cometbft_tpu.libs.failures as j_failures
import cometbft_tpu.p2p.node_info as j_node_info
import cometbft_tpu.p2p.peer as j_peer
import cometbft_tpu.statesync.cache as j_cache
import cometbft_tpu.statesync.manifest as j_manifest
import cometbft_tpu.statesync.reactor as j_reactor
import cometbft_tpu.statesync.stateprovider as j_sp
import cometbft_tpu.statesync.syncer as j_syncer
import cometbft_tpu_torch.abci.client as t_client
import cometbft_tpu_torch.abci.kvstore as t_kv
import cometbft_tpu_torch.abci.types as t_abci
import cometbft_tpu_torch.config as t_config
import cometbft_tpu_torch.libs.failures as t_failures
import cometbft_tpu_torch.p2p.node_info as t_node_info
import cometbft_tpu_torch.p2p.peer as t_peer
import cometbft_tpu_torch.statesync.cache as t_cache
import cometbft_tpu_torch.statesync.manifest as t_manifest
import cometbft_tpu_torch.statesync.reactor as t_reactor
import cometbft_tpu_torch.statesync.stateprovider as t_sp
import cometbft_tpu_torch.statesync.syncer as t_syncer

pytestmark = pytest.mark.timeout(150)

JAX = SimpleNamespace(name="jax", client=j_client, kv=j_kv, abci=j_abci,
                      config=j_config, failures=j_failures,
                      node_info=j_node_info, peer=j_peer, cache=j_cache,
                      manifest=j_manifest, reactor=j_reactor, sp=j_sp,
                      syncer=j_syncer)
PORT = SimpleNamespace(name="port", client=t_client, kv=t_kv, abci=t_abci,
                       config=t_config, failures=t_failures,
                       node_info=t_node_info, peer=t_peer, cache=t_cache,
                       manifest=t_manifest, reactor=t_reactor, sp=t_sp,
                       syncer=t_syncer)
SH = b"\xcd" * 32


def run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


def both(scenario):
    """The scenario's observations on each package; they must be equal."""
    j, t = scenario(JAX), scenario(PORT)
    assert t == j
    return t


# ----------------------------------------------------------- manifest


def test_manifest_root_binds_snapshot_and_order():
    def scenario(P):
        m = P.manifest
        hs = [m.hash_chunk(b"c%d" % i) for i in range(4)]
        root = m.manifest_root(SH, hs)
        return (root, m.manifest_root(b"\xce" * 32, hs),
                m.manifest_root(SH, list(reversed(hs))),
                [m.valid_hash_list(sh, h, n, r) for sh, h, n, r in (
                    (SH, hs, 4, root), (SH, hs, 5, root),
                    (SH, hs[:3], 4, root), (b"\xce" * 32, hs, 4, root),
                    (SH, hs, 4, b"\x00" * 32),
                    (SH, hs[:3] + [b"short"], 4, root),
                    (SH, hs[:3] + ["str"], 4, root))])

    root, other_snap, reordered, verdicts = both(scenario)
    assert root not in (other_snap, reordered)
    assert verdicts == [True] + [False] * 6


def test_chunk_manifest_verifies_chunks():
    def scenario(P):
        chunks = [b"alpha", b"beta", b"gamma"]
        mf = P.manifest.ChunkManifest.from_chunks(SH, chunks)
        return (len(mf), mf.root, mf.hashes,
                [mf.verify_chunk(i, c + x) for i, c in enumerate(chunks)
                 for x in (b"", b"!")],
                mf.verify_chunk(-1, b"alpha"), mf.verify_chunk(3, b"alpha"))

    n, _, _, verdicts, neg, past = both(scenario)
    assert n == 3 and verdicts == [True, False] * 3 and not neg and not past


# -------------------------------------------------- blob pool / spool


@pytest.mark.parametrize("case", ["dedup", "retention", "zero_budget"])
def test_blob_pool(case):
    def scenario(P):
        obs = []
        if case == "dedup":
            pool = P.syncer._BlobPool(in_memory=True, retain_bytes=1 << 20)
            h = hashlib.sha256(b"DATA").digest()
            obs += [pool.put(h, b"DATA"), pool.put(h, b"DATA"),
                    pool.dedup_hits, pool.get(h)]
            pool.release(h)
            obs.append(pool.get(h))
            pool.release(h)
            obs += [pool.acquire(h), pool.dedup_hits]
        elif case == "retention":
            pool = P.syncer._BlobPool(in_memory=True, retain_bytes=250)
            hs = []
            for i in range(4):
                data = bytes([i]) * 100
                h = hashlib.sha256(data).digest()
                pool.put(h, data)
                hs.append(h)
            for h in hs:
                pool.release(h)
            obs += [pool.acquire(h) for h in hs]
        else:
            pool = P.syncer._BlobPool(in_memory=True, retain_bytes=0)
            h = hashlib.sha256(b"X").digest()
            pool.put(h, b"X")
            pool.release(h)
            obs.append(pool.acquire(h))
        pool.close()
        return obs

    obs = both(scenario)
    want = {"dedup": [True, True, 1, b"DATA", b"DATA", True, 1],
            "retention": [False, False, True, True],
            "zero_budget": [False]}[case]
    assert obs == want


def test_chunk_store_adopts_and_guards_senders():
    def scenario(P):
        pool = P.syncer._BlobPool(in_memory=True, retain_bytes=1 << 20)
        h = hashlib.sha256(b"CHUNK-0").digest()
        first = P.syncer._ChunkStore(pool=pool)
        first[0] = (b"CHUNK-0", "peerA")
        first.close()
        second = P.syncer._ChunkStore(pool=pool)
        obs = [second.adopt(0, h), second[0], second.adopt(0, h),
               second.adopt(1, b"\x00" * 32)]
        second.close()
        pool.close()
        store = P.syncer._ChunkStore(in_memory=True)
        store[0] = (b"evil-bytes", "evil")
        obs += [store.pop_if_sender(0, "good"), 0 in store]
        store[0] = (b"good-bytes", "good")
        obs += [store.pop_if_sender(0, "evil"), store[0],
                store.pop_if_sender(0, "good"), 0 in store]
        store.close()
        return obs

    assert both(scenario) == [True, (b"CHUNK-0", ""), False, False,
                              False, True, False, (b"good-bytes", "good"),
                              True, False]


def test_chunk_store_spools_to_disk(tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))

    def scenario(P):
        import tempfile
        tempfile.tempdir = None
        store = P.syncer._ChunkStore()
        store[3] = (b"x" * 1000, "peer")
        spool = store._dir
        on_disk = sorted(p.name for p in
                         __import__("pathlib").Path(spool).iterdir())
        obs = [spool.startswith(str(tmp_path)), on_disk, store[3]]
        store.close()
        return obs + [__import__("os").path.exists(spool)]

    try:
        obs = both(scenario)
    finally:
        import tempfile
        tempfile.tempdir = None
    assert obs[0] and obs[2] == (b"x" * 1000, "peer") and not obs[3]


# ------------------------------------------ add_chunk + manifest gate


def _syncer_with_manifest(P, chunks):
    sy = P.syncer.Syncer(app_conns=None, state_provider=None,
                         in_memory_spool=True)
    snap = SimpleNamespace(height=7, format=1, chunks=len(chunks), hash=SH)
    sy._current = P.syncer._PendingSnapshot(snap)
    sy._manifest = [P.manifest.hash_chunk(c) for c in chunks]
    return sy


def _close(sy):
    sy._chunks.close()
    sy._pool.close()


def test_add_chunk_spools_only_verified_bytes():
    def scenario(P):
        sy = _syncer_with_manifest(P, [b"C0", b"C1"])
        sy.add_chunk("evil", 7, 1, 0, b"CORRUPT", SH)
        obs = [0 in sy._chunks, sorted(sy._banned), sorted(sy._refetch)]
        sy.add_chunk("good", 7, 1, 0, b"C0", SH)
        obs.append(sy._chunks[0])
        sy.add_chunk("evil", 7, 1, 1, b"C1", SH)
        obs += [1 in sy._chunks, dict(sy.tallies)]
        _close(sy)
        return obs

    obs = both(scenario)
    assert obs[:5] == [False, ["evil"], [0], (b"C0", "good"), False]
    assert obs[5]["chunk_hash_mismatches"] == 1
    assert obs[5]["chunks_verified"] == 1


def test_add_chunk_drops_stale_and_malicious_responses():
    def scenario(P):
        sy = _syncer_with_manifest(P, [b"C0"])
        for h, f, sh in ((8, 1, SH), (7, 2, SH), (7, 1, b"\xee" * 32)):
            sy.add_chunk("p", h, f, 0, b"C0", sh)
        for idx in (-1, 1, 10**9, "0", None, True, 0.0, b"\x00"):
            sy.add_chunk("p", 7, 1, idx, b"C0", SH)
        obs = [sorted(sy._chunks._senders), dict(sy.tallies)]
        _close(sy)
        return obs

    obs = both(scenario)
    assert obs[0] == [] and obs[1]["chunks_verified"] == 0


# ---------------------------------------------------- restores (stubs)


def _stub_conns(P, applied, app_hash=b"\xab" * 32, height=5, respond=None):
    A = P.abci

    class SnapConn:
        async def offer_snapshot(self, snapshot, app_hash_):
            return A.OFFER_SNAPSHOT_ACCEPT

        async def apply_snapshot_chunk(self, index, chunk, sender):
            applied.append((index, chunk, sender))
            return respond(index, chunk, sender) if respond else \
                A.APPLY_CHUNK_ACCEPT

    class QueryConn:
        async def info(self):
            return A.InfoResponse(last_block_height=height,
                                  last_block_app_hash=app_hash)

    return SimpleNamespace(snapshot=SnapConn(), query=QueryConn())


class _Provider:
    async def app_hash(self, h):
        return b"\xab" * 32

    async def state(self, h):
        return "S"

    async def commit(self, h):
        return "C"


class _StubReactor:
    """Serves chunks (through ``data(peer, index)``) and manifests from
    the test, delivering asynchronously as the network would."""

    def __init__(self, box, chunks, hashes=None, data=None, lies=None):
        self.box, self.chunks, self.hashes = box, chunks, hashes
        self.data = data or (lambda peer, i: chunks[i])
        self.lies = lies or {}
        self.manifest_reqs, self.chunk_reqs = [], []
        self.switch = None

    def request_manifest(self, peer, height, format_, sh):
        self.manifest_reqs.append(peer)
        self.box[0].add_manifest(peer, height, format_, sh,
                                 list(self.lies.get(peer, self.hashes)))
        return True

    def request_chunk(self, peer, height, format_, index, sh):
        self.chunk_reqs.append((peer, index))
        data = self.data(peer, index)

        async def deliver():
            self.box[0].add_chunk(peer, height, format_, index, data, sh)

        asyncio.get_event_loop().create_task(deliver())
        return True

    def broadcast_snapshot_request(self):
        pass


def _restore(P, peers, chunks, *, roots=True, data=None, lies=None,
             respond=None, timeout=10.0):
    """One ``Syncer._restore`` of a 5-height snapshot of ``chunks``
    offered by ``peers``; returns the syncer's observations."""
    m = P.manifest
    hashes = [m.hash_chunk(c) for c in chunks]
    root = m.manifest_root(SH, hashes)
    applied = []

    async def main():
        box = [None]
        reactor = _StubReactor(box, chunks, hashes, data, lies)
        sy = P.syncer.Syncer(_stub_conns(P, applied, respond=respond),
                             _Provider(), reactor=reactor,
                             in_memory_spool=True, chunk_timeout=timeout)
        box[0] = sy
        snap = P.abci.Snapshot(height=5, format=1, chunks=len(chunks),
                               hash=SH, metadata=b"")
        for p in peers:
            sy.add_snapshot(p, snap, manifest_root=root if roots else None)
        try:
            out = await sy._restore(sy._snapshots[(5, 1, SH)])
        except P.syncer.StatesyncError as e:
            out = ("error", type(e).__name__, str(e))
        sy._pool.close()
        return dict(out=out, applied=applied, banned=sorted(sy._banned),
                    tallies=dict(sy.tallies),
                    manifest_reqs=reactor.manifest_reqs,
                    chunk_reqs=sorted(reactor.chunk_reqs))

    return run(main())


def test_restore_recovers_from_corrupt_chunks_without_reset():
    chunks = [b"CHUNK-%d" % i for i in range(4)]

    def data(peer, i):
        return chunks[i] if peer == "good" else chunks[i][:-1] + b"!"

    obs = both(lambda P: _restore(P, ["evil", "good"], chunks, data=data))
    assert obs["out"] == ("S", "C")
    assert [a[0] for a in obs["applied"]] == [0, 1, 2, 3]
    assert all(a[2] == "good" for a in obs["applied"])
    assert obs["banned"] == ["evil"]
    assert obs["tallies"]["chunk_hash_mismatches"] >= 1
    assert obs["tallies"]["chunks_verified"] == 4
    assert obs["tallies"]["restore_resets"] == 0


def test_restore_rejects_lying_manifest_server():
    chunks = [b"A", b"B"]
    lies = {"liar": [j_manifest.hash_chunk(b"X"),
                     j_manifest.hash_chunk(b"Y")]}
    obs = both(lambda P: _restore(P, ["liar", "hon1", "hon2"], chunks,
                                  lies=lies))
    assert obs["out"] == ("S", "C") and obs["banned"] == ["liar"]
    assert len(obs["manifest_reqs"]) >= 2


def test_syncer_honors_reject_senders_and_refetch():
    """The app names a bad sender: it is banned and its chunk fetched
    again from the other peer (legacy offers, no manifest)."""
    chunks = [b"GOOD0", b"GOOD1", b"GOOD2"]

    def data(peer, i):
        return b"EVIL" if peer == "evil" else chunks[i]

    def scenario(P):
        A = P.abci

        def respond(index, chunk, sender):
            if chunk.startswith(b"EVIL"):
                return A.ApplySnapshotChunkResponse(
                    result=A.APPLY_CHUNK_ACCEPT, refetch_chunks=[index],
                    reject_senders=[sender])
            return A.ApplySnapshotChunkResponse(result=A.APPLY_CHUNK_ACCEPT)

        return _restore(P, ["evil", "good"], chunks, roots=False,
                        data=data, respond=respond)

    obs = both(scenario)
    assert obs["out"] == ("S", "C") and obs["banned"] == ["evil"]
    final = {}
    for i, chunk, sender in obs["applied"]:
        final[i] = chunk
    assert final == dict(enumerate(chunks))


def test_syncer_offer_reject_format_and_sender():
    def scenario(P):
        A = P.abci
        offers = []

        class SnapConn:
            async def offer_snapshot(self, snapshot, app_hash):
                offers.append((snapshot.height, snapshot.format))
                if snapshot.format == 2:
                    return A.OFFER_SNAPSHOT_REJECT_FORMAT
                if snapshot.height == 9:
                    return A.OFFER_SNAPSHOT_REJECT_SENDER
                return A.OFFER_SNAPSHOT_REJECT

        async def main():
            conns = SimpleNamespace(snapshot=SnapConn(), query=None)
            sy = P.syncer.Syncer(conns, _Provider(), reactor=None,
                                 in_memory_spool=True)

            def offer():
                for h, f, peer in ((9, 1, "a"), (8, 2, "b"), (7, 2, "c"),
                                   (6, 1, "d")):
                    sy.add_snapshot(peer, A.Snapshot(
                        height=h, format=f, chunks=1, hash=bytes([h]) * 32))

            offer()
            tried = set()
            rejected = set()
            errors = []
            while True:
                best = sy._best_snapshot(tried, rejected)
                if best is None:
                    break
                tried.add((best.snapshot.height, best.snapshot.format,
                           best.snapshot.hash))
                try:
                    await sy._restore(best)
                except P.syncer._RejectFormat:
                    rejected.add(best.snapshot.format)
                    errors.append("format")
                except P.syncer._RejectSender:
                    for p in list(best.peers):
                        sy._note_sender_banned(p)
                        sy.remove_peer(p)
                    errors.append("sender")
                except P.syncer.StatesyncError as e:
                    errors.append(str(e))
            sy._pool.close()
            return offers, errors, sorted(sy._banned), dict(sy.tallies)

        return run(main())

    offers, errors, banned, tallies = both(scenario)
    assert offers == [(9, 1), (8, 2), (6, 1)]    # (7, 2): format rejected
    assert errors[:2] == ["sender", "format"] and banned == ["a"]


def test_concurrent_chunk_fetch_spreads_over_peers():
    """Outstanding requests are capped per peer and rotate over every
    serving peer."""
    chunks = [b"K%02d" % i for i in range(12)]
    obs = both(lambda P: _restore(P, ["p0", "p1", "p2"], chunks))
    assert obs["out"] == ("S", "C")
    by_peer = {}
    for peer, _ in obs["chunk_reqs"]:
        by_peer[peer] = by_peer.get(peer, 0) + 1
    assert sorted(by_peer) == ["p0", "p1", "p2"]
    assert obs["tallies"]["chunks_verified"] == 12


# ---------------------------------------------- fatal-IO spool


def test_is_fatal_io_error_classification():
    def scenario(P):
        return [P.syncer._is_fatal_io_error(OSError(e, "x")) for e in (
            errno.EIO, errno.ENOSPC, errno.EROFS, errno.EDQUOT, errno.ENXIO,
            errno.ENOENT, errno.EAGAIN, errno.EINTR)] + [
            P.syncer._is_fatal_io_error(OSError("no errno"))]

    assert both(scenario) == [True] * 5 + [False] * 4


def test_spool_enospc_fails_sync_with_fatal_error():
    def scenario(P):
        F = P.failures
        F.reset()
        F.configure(enabled=True, seed=7,
                    faults=["statesync.spool.enospc:every=1"])
        try:
            sy = P.syncer.Syncer(app_conns=None, state_provider=None,
                                 in_memory_spool=True)
            snap = SimpleNamespace(height=7, format=1, chunks=2, hash=SH)
            pending = P.syncer._PendingSnapshot(snap)
            pending.peers.append("p")
            sy._current = pending
            sy.add_chunk("p", 7, 1, 0, b"data", SH)
            obs = [type(sy._fatal).__name__, str(sy._fatal),
                   0 in sy._chunks]

            async def main():
                try:
                    await sy._fetch_and_apply(pending)
                except P.syncer.StatesyncFatalError as e:
                    return type(e).__name__

            obs.append(run(main()))
            sy._spool_failed(1, OSError(errno.ENOENT, "transient"))
            obs.append(str(sy._fatal) == obs[1])
            _close(sy)
            return obs
        finally:
            F.reset()

    obs = both(scenario)
    assert obs[0] == "StatesyncFatalError" and "ENOSPC" in obs[1]
    assert obs[2:] == [False, "StatesyncFatalError", True]


def test_spool_nonfatal_oserror_does_not_kill_sync():
    def scenario(P):
        sy = P.syncer.Syncer(app_conns=None, state_provider=None,
                             in_memory_spool=True)
        sy._spool_failed(0, OSError(errno.ENOENT, "transient"))
        obs = sy._fatal
        _close(sy)
        return obs

    assert both(scenario) is None


# ------------------------------------------- provider retries


def test_stateprovider_retries_transient_failures():
    class FlakyLight:
        def __init__(self, fail, exc):
            self.calls, self.fail, self.exc = 0, fail, exc

        async def verify_light_block_at_height(self, height):
            self.calls += 1
            if self.calls <= self.fail:
                raise self.exc
            return SimpleNamespace(
                header=SimpleNamespace(app_hash=b"\xab" * 32),
                commit="COMMIT")

    def scenario(P):
        async def main():
            obs = []
            for fail, exc, retries, call in (
                    (2, TimeoutError("slow"), 2, "app_hash"),
                    (99, ConnectionError("refused"), 1, "commit"),
                    (99, ValueError("bad header"), 3, "commit")):
                light = FlakyLight(fail, exc)
                sp = P.sp.StateProvider(light, None, retries=retries,
                                        backoff_s=0.0)
                try:
                    obs.append(await getattr(sp, call)(4))
                except Exception as e:
                    obs.append(type(e).__name__)
                obs.append(light.calls)
            return obs

        return run(main())

    assert both(scenario) == [b"\xab" * 32, 3, "ConnectionError", 2,
                              "ValueError", 1]


# ------------------------------------------------ config knobs


@pytest.mark.parametrize("field_,value", [
    ("chunk_timeout_s", 0.0), ("chunk_timeout_s", -1.0),
    ("max_inflight_per_peer", 0), ("max_inflight_per_peer", 65),
    ("discovery_time_s", 0.0), ("discovery_rounds", 0),
    ("discovery_rounds", 101), ("chunk_retries", -1),
    ("spool_retain_bytes", -1), ("chunk_cache_bytes", -1),
    ("serve_concurrency", 0), ("serve_queue", -1)])
def test_statesync_config_validation_bounds(field_, value):
    def scenario(P):
        P.config.Config().validate()
        cfg = P.config.Config()
        setattr(cfg.statesync, field_, value)
        try:
            cfg.validate()
        except P.config.ConfigError as e:
            return str(e)
        return None

    assert both(scenario) is not None


def test_statesync_config_defaults_match():
    import dataclasses

    assert dataclasses.asdict(t_config.StateSyncConfig()) == \
        dataclasses.asdict(j_config.StateSyncConfig())


# -------------------------------------------- serving side (LRU/gate)


def test_chunk_lru_byte_budget():
    def scenario(P):
        lru = P.cache.ChunkLRU(max_size=10, max_bytes=250)
        for i in range(3):
            lru.put(("h", 1, i), bytes([i]) * 100)
        obs = [lru.get(("h", 1, 0)), lru.get(("h", 1, 1)), lru.bytes]
        lru.put(("h", 1, 3), b"z" * 100)
        obs += [lru.get(("h", 1, 1)), lru.get(("h", 1, 2))]
        lru2 = P.cache.ChunkLRU(max_size=10, max_bytes=10)
        obs.append(lru2.put("k", b"x" * 100))
        return obs + [len(lru2)]

    assert both(scenario) == [None, b"\x01" * 100, 200, b"\x01" * 100,
                              None, 0, 1]


def test_admission_gate_sheds_over_queue_budget():
    def scenario(P):
        async def main():
            gate = P.cache.AdmissionGate(concurrency=1, max_queued=1)
            release, entered = asyncio.Event(), asyncio.Event()

            async def hold():
                async with gate:
                    entered.set()
                    await release.wait()

            holder = asyncio.get_event_loop().create_task(hold())
            await entered.wait()
            obs = [gate.try_queue()]

            async def wait_in_queue():
                async with gate:
                    pass

            waiter = asyncio.get_event_loop().create_task(wait_in_queue())
            await asyncio.sleep(0)
            obs += [gate.try_queue(), gate.shed]
            release.set()
            await asyncio.gather(holder, waiter)
            return obs + [gate.try_queue()]

        return run(main())

    assert both(scenario) == [True, False, 1, True]


def _serving(P, txs, name="t.ss"):
    async def setup():
        client = P.client.LocalClient(P.kv.KVStoreApplication())
        await client.finalize_block(P.abci.FinalizeBlockRequest(
            txs=txs, height=1, time_ns=0))
        await client.commit()
        return client

    client = run(setup())
    reactor = P.reactor.StatesyncReactor(SimpleNamespace(snapshot=client),
                                         name=name)
    sent = []
    peer = SimpleNamespace(id="p1", send=lambda chan, msg: sent.append(
        (chan, bytes(msg))) or True)
    return client, reactor, peer, sent


def test_reactor_offers_root_and_serves_manifest():
    """The reactor's offers, manifest and chunk messages are the JAX
    package's bytes."""
    def scenario(P):
        client, reactor, peer, sent = _serving(
            P, [b"k%02d=" % i + b"v" * 50000 for i in range(4)])

        async def main():
            snap = (await client.list_snapshots())[-1]
            await reactor._serve_snapshots(peer)
            await reactor._serve_manifest(
                peer, {"h": snap.height, "f": snap.format, "sh": snap.hash})
            for _ in range(2):
                await reactor._serve_chunk(
                    peer, {"h": snap.height, "f": snap.format, "i": 0})
            reactor.switch = SimpleNamespace(
                peers={"p1": peer}, broadcast=lambda ch, m: sent.append(
                    (ch, bytes(m))))
            reactor.request_chunk("p1", snap.height, snap.format, 3,
                                  snap.hash)
            reactor.request_manifest("p1", snap.height, snap.format,
                                     snap.hash)
            reactor.broadcast_snapshot_request()
            return snap, len(reactor._cache)

        snap, cached = run(main())
        return sent, (snap.height, snap.format, snap.chunks, snap.hash), \
            cached, [(d.channel_id, d.priority, d.send_queue_capacity)
                     for d in reactor.get_channels()]

    sent, snap, cached, channels = both(scenario)
    assert channels == [(0x60, 5, 10), (0x61, 3, 20)]
    msgs = [(ch, msgpack.unpackb(m, raw=False)) for ch, m in sent]
    offer = next(d for _, d in msgs if d["@"] == "sres" and d["h"] == 1)
    mres = next(d for _, d in msgs if d["@"] == "mres")
    assert snap[2] >= 2 and cached >= 1
    assert j_manifest.valid_hash_list(snap[3], mres["hs"], snap[2],
                                      offer["mr"])
    served = [d for _, d in msgs if d["@"] == "cres"]
    assert len(served) == 2 and served[0]["chunk"] == served[1]["chunk"]
    assert [d["@"] for _, d in msgs[-3:]] == ["creq", "mreq", "sreq"]


def test_reactor_receive_feeds_the_syncer_from_jax_bytes():
    """The port reactor decodes the JAX reactor's messages into the same
    syncer calls."""
    calls = []

    class Rec:
        def add_snapshot(self, peer, snap, manifest_root=None):
            calls.append(("snap", peer, snap.height, snap.format,
                          snap.chunks, snap.hash, snap.metadata,
                          manifest_root))

        def add_manifest(self, peer, h, f, sh, hs):
            calls.append(("mf", peer, h, f, sh, hs))

        def add_chunk(self, peer, h, f, i, chunk, sh):
            calls.append(("chunk", peer, h, f, i, chunk, sh))

    peer = SimpleNamespace(id="px")
    msgs = [(0x60, j_reactor._pack("sres", h=4, f=1, c=3, hash=SH,
                                   m=b"meta", mr=b"\x01" * 32)),
            (0x60, j_reactor._pack("mres", h=4, f=1, sh=SH,
                                   hs=[b"\x02" * 32])),
            (0x61, j_reactor._pack("cres", h=4, f=1, i=2, chunk=b"abc",
                                   sh=SH))]
    for P in (JAX, PORT):
        r = P.reactor.StatesyncReactor(None, syncer=Rec())
        for ch, m in msgs:
            r.receive(ch, peer, m)
        assert t_reactor._pack("sres", h=4, f=1, c=3, hash=SH, m=b"meta",
                               mr=b"\x01" * 32) == msgs[0][1]
    assert calls[:3] == calls[3:]


def test_serve_corrupt_chaos_site_flips_served_bytes_not_cache():
    def scenario(P):
        client, reactor, peer, sent = _serving(
            P, [b"k=" + b"v" * 1000], name="byz.ss")
        F = P.failures

        async def main():
            snap = (await client.list_snapshots())[-1]
            honest = await client.load_snapshot_chunk(snap.height,
                                                      snap.format, 0)
            F.reset()
            F.configure(enabled=True, seed=3, faults=[
                "statesync.serve.corrupt:node=byz.ss:every=1"])
            try:
                await reactor._serve_chunk(
                    peer, {"h": snap.height, "f": snap.format, "i": 0})
            finally:
                F.reset()
            cached = reactor._cache.get((snap.height, snap.format, 0))
            return honest, cached

        honest, cached = run(main())
        return honest, cached, sent

    honest, cached, sent = both(scenario)
    served = msgpack.unpackb(sent[-1][1], raw=False)["chunk"]
    diff = [a ^ b for a, b in zip(served, honest) if a != b]
    assert cached == honest and len(diff) == 1 and \
        bin(diff[0]).count("1") == 1


def test_peer_send_filters_unadvertised_channels():
    def scenario(P):
        sent = []
        mconn = SimpleNamespace(send=lambda chan, msg: sent.append(chan)
                                or True)
        info = P.node_info.NodeInfo(
            node_id="n1", listen_addr="mem://x", network="net",
            channels=bytes([0x60, 0x61]), moniker="x")
        peer = P.peer.Peer(info, mconn, outbound=True)
        obs = [peer.has_channel(0x60), peer.has_channel(0x20),
               peer.send(0x60, b"m"), peer.send(0x20, b"m")]
        info2 = P.node_info.NodeInfo(node_id="n2", listen_addr="mem://y",
                                     network="net", channels=b"",
                                     moniker="y")
        obs.append(P.peer.Peer(info2, mconn, outbound=True).send(0x20,
                                                                  b"m"))
        return obs + [sent]

    assert both(scenario) == [True, False, True, False, True, [0x60, 0x20]]
