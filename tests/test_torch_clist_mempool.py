"""The port's CList mempool and tx cache
(``cometbft_tpu_torch/mempool/clist_mempool.py``, ``cache.py``) against
the JAX package's, on the CPU.  Each case runs one script against both
packages (each over its own scripted app, or its own kvstore app behind
a ``LocalClient``) and records what it sees: admissions and their errors
(class, code, log), the pool's contents in arrival order, sizes and
bytes, shard occupancy, reaps under byte and gas caps, the keys reported
removed, and the txs-available edges.  The records must be equal.  The
scripted cases mirror ``tests/test_mempool.py``; transactions of the
kvstore cases come from numpy seeds.  Not mirrored:
``test_coalescer_size_flush_snaps_to_lane_bucket``, since the port's
burst cap is the configured size (``test_coalescer_cap_is_not_snapped``).
"""

import asyncio

import numpy as np
import pytest

from cometbft_tpu.abci import types as JA
from cometbft_tpu.abci.client import LocalClient as JLocal
from cometbft_tpu.abci.kvstore import KVStoreApplication as JKV
from cometbft_tpu.mempool import cache as JCache
from cometbft_tpu.mempool import clist_mempool as JM
from cometbft_tpu_torch.abci import types as TA
from cometbft_tpu_torch.abci.client import LocalClient as TLocal
from cometbft_tpu_torch.abci.kvstore import KVStoreApplication as TKV
from cometbft_tpu_torch.mempool import cache as TCache
from cometbft_tpu_torch.mempool import clist_mempool as TM

pytestmark = pytest.mark.timeout(120)

PKGS = {"port": (TM, TA), "jax": (JM, JA)}


def run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


class ScriptedApp:
    """CheckTx verdicts by prefix (as ``tests/test_mempool.py``'s): b"bad"
    rejects, b"drop" passes admission and fails the recheck."""

    def __init__(self, A):
        self.A = A
        self.calls = 0
        self.inflight = 0
        self.max_inflight = 0

    async def check_tx(self, tx: bytes, recheck: bool = False):
        self.calls += 1
        self.inflight += 1
        self.max_inflight = max(self.max_inflight, self.inflight)
        await asyncio.sleep(0)
        self.inflight -= 1
        if recheck and tx.startswith(b"drop"):
            return self.A.CheckTxResponse(code=1, log="stale")
        if tx.startswith(b"bad"):
            return self.A.CheckTxResponse(code=7, log="scripted reject")
        return self.A.CheckTxResponse(code=0, gas_wanted=1)


async def _admit(mp, tx, trace):
    try:
        await mp.check_tx(tx)
        trace.append(("ok", tx))
    except Exception as e:
        trace.append(("err", type(e).__name__, getattr(e, "code", None),
                      getattr(e, "log", str(e))))


def _observe(mp, trace):
    trace.append(("contents", mp.contents(), mp.size(), mp.size_bytes(),
                  mp.stats()["shards"], [k for k, _ in mp.items()],
                  mp.height))


def _both(script, **kw):
    """Run ``script(mp, app, trace)`` on both packages; return the
    traces and apps."""
    out = {}
    for name, (M, A) in PKGS.items():
        app = ScriptedApp(A)
        mp = M.CListMempool(app, **kw)
        trace: list = []
        run(script(mp, app, trace))
        out[name] = (trace, app)
    assert out["port"][0] == out["jax"][0]
    return out


def test_shard_routing_spreads_and_accounts():
    async def script(mp, app, trace):
        await asyncio.gather(*(_admit(mp, b"tx-%d" % i, trace)
                               for i in range(64)))
        _observe(mp, trace)

    out = _both(script, shards=4, coalesce_ms=0)
    assert len([n for n in out["port"][0][-1][4] if n]) > 1


@pytest.mark.parametrize("concurrent", [False, True])
def test_merged_reap_preserves_arrival_fifo(concurrent):
    txs = [b"fifo-%03d" % i for i in range(100)]

    async def script(mp, app, trace):
        if concurrent:
            await asyncio.gather(*(_admit(mp, t, trace) for t in txs))
        else:
            for t in txs:
                await _admit(mp, t, trace)
        trace.append(mp.reap_max_txs(1000))
        trace.append(mp.reap_max_bytes_max_gas(-1, -1))
        for cap in (0, 7, 8, 300, 801):
            trace.append(mp.reap_max_bytes_max_gas(cap, -1))
            trace.append(mp.reap_max_bytes_max_gas(-1, cap))
        _observe(mp, trace)

    out = _both(script, shards=8 if not concurrent else 4,
                coalesce_ms=0.5 if concurrent else 0, coalesce_max=16)
    assert out["port"][0][-1][1] == txs


def test_coalesced_checktx_demuxes_mixed_verdicts():
    txs = [b"ok-%d" % i for i in range(6)] + [b"bad-%d" % i
                                              for i in range(6)]

    async def script(mp, app, trace):
        await asyncio.gather(*(_admit(mp, t, trace) for t in txs))
        _observe(mp, trace)
        trace.append(app.max_inflight >= 12)

    out = _both(script, shards=1, coalesce_ms=5.0, coalesce_max=64)
    assert out["port"][0][-1] is True


def test_coalescer_cap_is_not_snapped():
    mp = TM.CListMempool(ScriptedApp(TA), shards=1, coalesce_max=100)
    assert mp._shards[0].checker.max_lanes == 100
    assert mp._recheck_chunk == 400
    jmp = JM.CListMempool(ScriptedApp(JA), shards=1, coalesce_max=100)
    assert jmp._shards[0].checker.max_lanes == 64     # a TPU bucket


@pytest.mark.parametrize("recheck", [True, False])
def test_batched_recheck_drops_stale_survivors(recheck):
    keep = [b"keep-%d" % i for i in range(10)]
    drop = [b"drop-%d" % i for i in range(10)]

    async def script(mp, app, trace):
        for t in keep + drop + [b"block-tx"]:
            await _admit(mp, t, trace)
        removed: list = []
        mp.on_txs_removed = removed.extend
        async with mp.lock():
            await mp.update(2, [b"block-tx"], [])
        _observe(mp, trace)
        trace.append(sorted(removed))
        # committed txs stay cached: re-admission is silently ignored
        await _admit(mp, b"block-tx", trace)
        _observe(mp, trace)

    _both(script, shards=4, coalesce_ms=0, recheck=recheck)


def test_byte_cap_admission_and_running_total():
    async def script(mp, app, trace):
        for tx in (b"x" * 60, b"y" * 60, b"z" * 30):
            await _admit(mp, tx, trace)
        _observe(mp, trace)
        async with mp.lock():
            await mp.update(2, [b"x" * 60], [])
        await _admit(mp, b"w" * 60, trace)
        await _admit(mp, b"v" * 2000, trace)        # over max_tx_bytes
        _observe(mp, trace)
        await mp.flush()
        _observe(mp, trace)
        await _admit(mp, b"z" * 30, trace)          # cache reset by flush
        _observe(mp, trace)

    _both(script, shards=2, coalesce_ms=0, max_txs=1000, max_txs_bytes=100,
          max_tx_bytes=1000)


def test_count_cap_and_invalid_cache_policy():
    async def script(mp, app, trace):
        for tx in (b"a1", b"bad1", b"a2", b"bad1", b"a3", b"a4"):
            await _admit(mp, tx, trace)
        _observe(mp, trace)
        trace.append(len(mp.cache))

    for keep in (False, True):
        _both(script, shards=2, coalesce_ms=0, max_txs=3,
              keep_invalid_txs_in_cache=keep)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_kvstore_admission_reap_and_update(seed):
    """A kvstore app behind a LocalClient: random admissions (some
    malformed, some repeated), reaps under random caps, blocks committed
    through ``update`` with the app's results, and the txs-available edge
    once a height."""
    rng = np.random.default_rng(seed)
    rounds = []
    for _ in range(4):
        txs = []
        for _ in range(int(rng.integers(5, 40))):
            r = rng.random()
            if r < 0.1:
                txs.append(b"malformed%d" % int(rng.integers(0, 5)))
            else:
                txs.append(b"k%d=v%d" % (int(rng.integers(0, 60)),
                                         int(rng.integers(0, 9))))
        caps = [(int(rng.integers(-1, 400)), int(rng.integers(-1, 30)))
                for _ in range(3)]
        rounds.append((txs, caps))
    traces = {}
    for name, (M, A) in PKGS.items():
        app = (TKV(device="cpu") if name == "port" else JKV())
        mp = M.CListMempool((TLocal if name == "port" else JLocal)(app),
                            shards=3, coalesce_ms=0.2, coalesce_max=8,
                            max_txs=120, cache_size=50)
        trace: list = []
        edges: list = []
        mp.on_txs_available = lambda: edges.append(mp.height)

        async def script():
            await app.init_chain(A.InitChainRequest(
                chain_id="mp", initial_height=1, time_ns=0, validators=[],
                app_state_bytes=b"{}"))
            for h, (txs, caps) in enumerate(rounds, start=1):
                await asyncio.gather(*(_admit(mp, t, trace) for t in txs))
                for mb, mg in caps:
                    trace.append(mp.reap_max_bytes_max_gas(mb, mg))
                block = mp.reap_max_bytes_max_gas(300, -1)
                resp = await app.finalize_block(A.FinalizeBlockRequest(
                    txs=block, height=h, time_ns=h, hash=b"\x00" * 32,
                    proposer_address=b"\x01" * 20,
                    decided_last_commit=None, misbehavior=[],
                    syncing_to_height=h))
                async with mp.lock():
                    await app.commit()
                    await mp.update(h, block, resp.tx_results)
                _observe(mp, trace)
                trace.append((app.app_hash, list(edges),
                              mp.txs_available().is_set()))

        run(script())
        traces[name] = trace
    assert traces["port"] == traces["jax"]


def test_lru_tx_cache_matches_jax():
    rng = np.random.default_rng(7)
    t, j = TCache.LRUTxCache(8), JCache.LRUTxCache(8)
    for _ in range(300):
        key = b"k%d" % int(rng.integers(0, 20))
        op = int(rng.integers(0, 3))
        if op == 0:
            assert t.push(key) == j.push(key)
        elif op == 1:
            assert t.has(key) == j.has(key)
        else:
            t.remove(key)
            j.remove(key)
        assert list(t._map) == list(j._map) and len(t) == len(j)
    t.reset()
    assert len(t) == 0
