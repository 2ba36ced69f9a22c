"""Load generation and latency reporting (counterpart of
``cometbft_tpu/loadtime.py``; reference: ``test/loadtime/``): a tx
generator that embeds send timestamps, and a report tool that recovers
per-tx latency from committed chain data, both over an RPC client
(``rpc/client.py:HTTPClient``).

Load txs are kvstore-compatible ``k=v`` pairs::

    load:<run-id>:<seq>=<send_time_ns_hex>:<padding>

The report scans committed blocks over RPC and, for every load tx,
computes ``block_time - send_time`` (the reference's
``loadtime/report`` does exactly this from the tx payload timestamp
and the block header time), then prints distribution statistics.
"""

from __future__ import annotations

import asyncio
import time

PREFIX = b"load:"


def make_load_tx(run_id: str, seq: int, size: int = 256,
                 now_ns: int | None = None) -> bytes:
    t = time.time_ns() if now_ns is None else now_ns
    key = b"%s%s:%d" % (PREFIX, run_id.encode(), seq)
    body = key + b"=" + format(t, "x").encode() + b":"
    pad = max(0, size - len(body))
    return body + b"x" * pad


def parse_load_tx(tx: bytes) -> tuple[str, int, int] | None:
    """-> (run_id, seq, send_time_ns) or None for non-load txs."""
    if not tx.startswith(PREFIX) or b"=" not in tx:
        return None
    key, val = tx.split(b"=", 1)
    try:
        run_id, seq = key[len(PREFIX):].rsplit(b":", 1)
        t_hex = val.split(b":", 1)[0]
        return run_id.decode(), int(seq), int(t_hex, 16)
    except (ValueError, UnicodeDecodeError):
        return None


async def generate(client, rate: float, duration_s: float,
                   tx_size: int = 256, run_id: str | None = None,
                   broadcast: str = "broadcast_tx_async",
                   connections: int = 1, batch: int = 1) -> dict:
    """Drive ``rate`` tx/s at a node for ``duration_s`` through the RPC
    client (loadtime's generator loop, minus the UUID machinery).

    ``connections`` runs that many concurrent sender loops splitting the
    rate (loadtime's `-c` flag): one serial HTTP round-trip per tx caps
    a single loop at ~600 tx/s, which under-drives a saturation
    measurement.  ``batch`` > 1 sends that many txs per JSON-RPC batch
    request (one HTTP round-trip), for saturation drives where even the
    fan-out can't keep up."""
    run_id = run_id or format(int(time.time()) & 0xFFFFFF, "x")
    counters = {"sent": 0, "errors": 0}
    seq = iter(range(1 << 62))
    n = max(1, int(connections))
    # one keep-alive connection per worker (HTTPClient serializes its own
    # connection); worker 0 reuses the caller's client
    clients = [client]
    owned: list = []                # only close clients WE created
    if n > 1 and hasattr(client, "host") and hasattr(client, "port"):
        owned = [client.clone()
                 for _ in range(n - 1)]
        clients += owned
    else:
        clients *= n

    b = max(1, int(batch))

    async def worker(cli, worker_rate: float):
        interval = b / worker_rate
        t_end = time.monotonic() + duration_s
        next_at = time.monotonic()
        while time.monotonic() < t_end:
            txs = [make_load_tx(run_id, next(seq), tx_size)
                   for _ in range(b)]
            try:
                if b == 1:
                    await cli.call(broadcast, tx=txs[0].hex())
                    counters["sent"] += 1
                else:
                    outs = await cli.call_batch(
                        [(broadcast, {"tx": t.hex()}) for t in txs])
                    bad = sum(1 for o in outs if isinstance(o, Exception))
                    counters["sent"] += len(txs) - bad
                    counters["errors"] += bad
            except Exception:
                counters["errors"] += b
            next_at += interval
            delay = next_at - time.monotonic()
            if delay > 0:
                await asyncio.sleep(delay)

    try:
        await asyncio.gather(*(worker(c, rate / n) for c in clients[:n]))
    finally:
        for c in owned:
            try:
                await c.close()
            except Exception:
                pass
    return {"run_id": run_id, "sent": counters["sent"],
            "errors": counters["errors"], "rate": rate,
            "duration_s": duration_s, "connections": n}


async def report(client, run_id: str | None = None,
                 min_height: int = 1) -> dict:
    """Scan the chain via RPC and compute the latency distribution of
    committed load txs (loadtime/report's ``Report`` statistics)."""
    st = await client.call("status")
    tip = st["sync_info"]["latest_block_height"]
    tx_send: list[tuple[int, int]] = []      # (height, send_ts_ns)
    first_h = last_h = None
    block_time: dict[int, int] = {}
    for h in range(max(1, min_height), tip + 1):
        blk = await client.call("block", height=h)
        hdr = blk["block"]["hdr"]
        block_time[h] = hdr["ts"]
        for tx_hex in blk["block"]["data"]["txs"]:
            tx = bytes.fromhex(tx_hex["~b"]) if isinstance(tx_hex, dict) \
                else bytes.fromhex(tx_hex)
            parsed = parse_load_tx(tx)
            if parsed is None:
                continue
            rid, _seq, t_send = parsed
            if run_id is not None and rid != run_id:
                continue
            tx_send.append((h, t_send))
            first_h = h if first_h is None else first_h
            last_h = h
    if not tx_send:
        return {"txs": 0}
    # Latency target: when PBTS is off, block h's own header time is the
    # MEDIAN PRECOMMIT TIME OF HEIGHT h-1 (BFT time, sm/validation.py
    # median_time) — about one interval before h was even proposed, so
    # "header.ts - send" goes negative for promptly-included txs (the
    # reference's loadtime/report subtracts its own block time too, but
    # it measures PBTS chains where that IS the proposal time).  The next
    # block's timestamp is height h's commit-time proxy under both time
    # schemes, so latency = ts(h+1) - send; the tip block falls back to
    # its own ts (txs there are a tail fraction once the run drains).
    latencies_ns = [
        (block_time.get(h + 1, block_time[h]) - t_send)
        for h, t_send in tx_send]
    lat_s = sorted(x / 1e9 for x in latencies_ns)

    def pct(p):
        return lat_s[min(len(lat_s) - 1, int(p * len(lat_s)))]

    # Throughput window: first SEND to last COMMIT (the commit-time
    # proxy of the last tx-bearing block).  A block-timestamp span
    # (ts(last_h) - ts(first_h)) would measure burst rate, not sustained
    # throughput — when a starved node commits the whole run in two
    # giant blocks, that span is one block interval and the "throughput"
    # inflates ~50x.  Sends and header times come from different clocks
    # (sender wall clock vs BFT median time): cross-host clock skew adds
    # directly to the mixed window and can even zero it, so the window
    # of record is the MAX of the mixed span and two same-clock spans
    # (send-clock span; header-time span anchored one block before the
    # first tx block) — skew can only shrink a max, not inflate the
    # number — and all three spans ship in the artifact for
    # cross-machine comparison (ADVICE r4).
    send_min_ns = min(t for _, t in tx_send)
    send_max_ns = max(t for _, t in tx_send)
    end_ns = block_time.get(last_h + 1, block_time[last_h])
    mixed_s = (end_ns - send_min_ns) / 1e9
    send_span_s = (send_max_ns - send_min_ns) / 1e9
    header_start_ns = block_time.get(first_h - 1, block_time[first_h])
    header_span_s = (end_ns - header_start_ns) / 1e9
    window_s = max(mixed_s, send_span_s, header_span_s)
    return {
        "txs": len(lat_s),
        "blocks": (last_h - first_h + 1) if first_h else 0,
        "min_s": round(lat_s[0], 4),
        "p50_s": round(pct(0.50), 4),
        "p90_s": round(pct(0.90), 4),
        "p99_s": round(pct(0.99), 4),
        "max_s": round(lat_s[-1], 4),
        "avg_s": round(sum(lat_s) / len(lat_s), 4),
        "throughput_tx_s": round(len(lat_s) / window_s, 2)
        if window_s > 0 else None,
        "window_s": round(window_s, 3),
        "window_mixed_s": round(mixed_s, 3),
        "window_send_clock_s": round(send_span_s, 3),
        "window_header_clock_s": round(header_span_s, 3),
    }
