"""The port's load generator and report (``cometbft_tpu_torch/
loadtime.py``) against the JAX package's: load txs made with a fixed
send time are the same bytes and parse alike, ``report`` over a fake
RPC client of a made-up chain gives the same statistics, and
``generate`` over a fake client sends txs that parse back."""

import asyncio

import numpy as np
import pytest

import cometbft_tpu.loadtime as j_lt
import cometbft_tpu_torch.loadtime as t_lt


@pytest.mark.parametrize("run_id,seq,size", [
    ("abc", 0, 256), ("abc", 7, 8), ("r-1", 123456, 64),
    ("", 1, 0), ("zz", 2**40, 300)])
def test_load_tx_bytes_and_parse_alike(run_id, seq, size):
    now = 1_700_000_000_123_456_789
    tx = t_lt.make_load_tx(run_id, seq, size, now_ns=now)
    assert tx == j_lt.make_load_tx(run_id, seq, size, now_ns=now)
    assert len(tx) >= size
    assert t_lt.parse_load_tx(tx) == j_lt.parse_load_tx(tx) == \
        (run_id, seq, now)


@pytest.mark.parametrize("tx", [
    b"", b"load:", b"load:x", b"load:x:1", b"load:x:y=00:", b"k=v",
    b"load:x:1=zz:", b"load:\xff:1=10:", b"load:a:b:3=ff:pad"])
def test_parse_odd_txs_alike(tx):
    assert t_lt.parse_load_tx(tx) == j_lt.parse_load_tx(tx)


class FakeClient:
    """``status`` and ``block`` of a made-up chain, as the RPC serves
    them: txs as ``{"~b": hex}`` (some as bare hex), header times in
    ns."""

    def __init__(self, blocks):
        self.blocks = blocks            # height -> (ts, [tx bytes])
        self.sent = []

    async def call(self, method, **params):
        if method == "status":
            return {"sync_info": {"latest_block_height": max(self.blocks)}}
        if method == "block":
            ts, txs = self.blocks[params["height"]]
            return {"block": {"hdr": {"ts": ts}, "data": {"txs": [
                {"~b": t.hex()} if i % 2 else t.hex()
                for i, t in enumerate(txs)]}}}
        if method.startswith("broadcast_tx"):
            self.sent.append(bytes.fromhex(params["tx"]))
            return {"code": 0}
        raise KeyError(method)


def _chain(seed):
    rng = np.random.default_rng(seed)
    blocks, seq = {}, 0
    for h in range(1, 13):
        ts = 10**9 * h + int(rng.integers(0, 10**8))
        txs = [b"k%d=v" % h]
        for _ in range(int(rng.integers(0, 5))):
            rid = "run" if rng.random() < 0.8 else "other"
            sent = ts - int(rng.integers(0, 3 * 10**9))
            txs.append(t_lt.make_load_tx(rid, seq, 64, now_ns=sent))
            seq += 1
        blocks[h] = (ts, txs)
    return blocks


@pytest.mark.parametrize("seed,run_id,min_height", [
    (1, None, 1), (2, "run", 1), (3, "other", 4), (4, "none", 1),
    (5, None, 10)])
def test_report_alike(seed, run_id, min_height):
    blocks = _chain(seed)
    outs = [asyncio.run(L.report(FakeClient(blocks), run_id=run_id,
                                 min_height=min_height))
            for L in (j_lt, t_lt)]
    assert outs[0] == outs[1]


def test_generate_sends_parseable_load():
    cli = FakeClient({1: (0, [])})
    out = asyncio.run(t_lt.generate(cli, rate=200.0, duration_s=0.2,
                                    tx_size=48, run_id="gen"))
    assert out["run_id"] == "gen" and out["errors"] == 0
    assert out["sent"] == len(cli.sent) > 0
    parsed = [t_lt.parse_load_tx(t) for t in cli.sent]
    assert [p[:2] for p in parsed] == [("gen", i) for i in range(len(parsed))]
    assert all(len(t) == 48 for t in cli.sent)
    assert set(out) == set(asyncio.run(j_lt.generate(
        FakeClient({1: (0, [])}), rate=200.0, duration_s=0.05,
        tx_size=48, run_id="gen")))
