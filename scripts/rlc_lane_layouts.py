#!/usr/bin/env python3
"""Time the RLC lane stage's two layouts across lane counts on one card:
the measurement behind ``cometbft_tpu_torch/ops/rlc.py:QUAD_LANES_BELOW``.

    python3 scripts/rlc_lane_layouts.py [--out PATH] [--reps N]

Signs the votes of a 256-validator commit with the port's own signer
(keys from ``chip_smoke.py``'s fixed seed), tiles them over 10,000 lanes
against a 10,000-row validator table, and runs K6a
(``verify_batch_rlc_gather``) over the first ``LAYOUT_LANES`` lanes at
each of ``chip_smoke.LANE_LAYOUTS`` lanes a block of the lane stage: the
stage's device ms (``torch.profiler``) and the verdict's ms (CUDA events,
``--reps`` calls), beside the layout ``ops/rlc.py:lane_block`` picks.
Every verdict must accept.  Needs one card; prints the card's name and
power limit, then one JSON object, and writes it to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
LAYOUT_LANES = (150, 1000, 2500, 4000, 6000, 8000, 10_000)
KEYS = 256


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="write the JSON object here too")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from cometbft_tpu_torch.crypto import batch
    from cometbft_tpu_torch.ops import ed25519 as ed
    from cometbft_tpu_torch.ops import rlc

    dev = torch.device("cuda")
    card = cs._run(["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"])
    print(card)
    vals, commit = cs.Fixtures(KEYS).commit(KEYS)
    pubs, sigs, msgs, lens = cs.lane_arrays(vals, commit)
    n = max(LAYOUT_LANES)
    lane = np.arange(n) % KEYS
    pub_t = torch.from_numpy(pubs[lane].copy()).to(dev)
    tab, ok = ed.prepare_pubkey_tables(pub_t)
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    rb, sb, blocks, active = batch._padded_lane_args(
        pubs[lane], sigs[lane, :32], sigs[lane, 32:], msgs[lane], lens[lane],
        dev)
    z = torch.from_numpy(rlc.host_rlc_coeffs(n)).to(dev)

    rows = {}
    for b in LAYOUT_LANES:
        a = (tab, ok, idx[:b], rb[:b], sb[:b], blocks[:b], active[:b], z[:b])
        row = {"chosen": rlc.lane_block(b)}
        for lpb in cs.LANE_LAYOUTS:
            with cs.lane_layout(lpb):
                if not bool(rlc.verify_batch_rlc_gather(*a)):
                    raise AssertionError(f"{lpb} lanes a block at {b} lanes "
                                         "rejected a valid batch")
                row[lpb] = {
                    "lane_ms": cs.rlc_stage_ms(
                        lambda: rlc.verify_batch_rlc_gather(*a),
                        args.reps)["lane"],
                    "ms": cs.time_cuda(
                        lambda: rlc.verify_batch_rlc_gather(*a), args.reps,
                        warm=1)}
        rows[b] = row
        print(f"B={b}: " + ", ".join(
            f"{k} a block: lane stage {row[k]['lane_ms']} ms device, verdict "
            f"{row[k]['ms']:.4f} ms" for k in cs.LANE_LAYOUTS)
            + f"; chosen {row['chosen']}  [{card}]")
    out = {"card": card, "reps": args.reps, "layouts": rows}
    text = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
