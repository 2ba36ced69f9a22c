#!/usr/bin/env python3
"""Time the G1 fold (K9, ``aggregate_g1_masked``), the validator-table
kernel (K5a, ``ed25519_tables``) and the RLC verdict (K6a,
``ed25519_rlc_gather``) of one checkout of the port on the card, and
hold the first two exactly against their plain versions.

    python3 scripts/fold_table_times.py [--root DIR] [--out PATH]

``--root`` names the checkout whose ``cometbft_tpu_torch`` is imported
(default: this one), so that two checkouts, such as a commit and its
parent unpacked with ``git archive``, can be timed in turn on one card
in one run (parent, change, change, parent).  Each checkout builds
its own kernels into its own ``build/``.  The inputs are seeded random
data, not signed keys (field elements below p as affine rows, random
32-byte encodings as keys and signature halves): the kernels do the
same work whatever the values, so the times hold for real inputs; the
RLC verdict over them is a reject, which is not checked.  Sizes: the
fold at ``FOLD_ROWS`` rows (every 50th absent at 10,000, the BLS main
path's mask; half at random at 200, an absentee fold's size), the
tables at ``TABLE_ROWS`` validators, the verdict at ``RLC_LANES`` lanes
(two SHA-512 blocks a lane).  ms: CUDA events over ``REPS`` calls;
device ms: ``torch.profiler``, two traces of ``REPS`` calls, the larger
kept.  Prints one JSON line and writes it to ``--out``.  Needs a card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
REPS = 20
FOLD_ROWS = (200, 10_000)
TABLE_ROWS = (150, 10_000)
RLC_LANES = (150, 10_000)


def _smoke():
    """This checkout's ``chip_smoke.py`` (its timing helpers), by path:
    another root on ``sys.path`` may hold its own."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("fold_table_times: no CUDA card", file=sys.stderr)
        return 2
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    from cometbft_tpu_torch.ops import blsg1 as G
    from cometbft_tpu_torch.ops import ed25519 as ed
    from cometbft_tpu_torch.ops import rlc

    sm = _smoke()
    dev = torch.device("cuda:0")
    rng = np.random.default_rng(7)
    out = {"root": str(root), "card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), "mismatches": {}}

    def timed(fn, prefix):
        ms = sm.time_cuda(fn, REPS)
        return {"ms": ms, "device_ms": sm.device_ms_of(fn, prefix, REPS)[0]}

    for r in FOLD_ROWS:
        limbs = np.stack([G.limbs_from_int(
            int.from_bytes(rng.bytes(48), "little") % G.P_INT)
            for _ in range(2 * r)]).reshape(r, 2, G.NLIMB)
        words = G.words_from_limbs(torch.from_numpy(limbs)).to(dev)
        sel = (np.arange(r) % 50 != 0) if r == 10_000 else rng.random(r) < .5
        mask = torch.from_numpy(sel.astype(np.int32)).to(dev)
        out["mismatches"][f"fold R={r}"] = int(not torch.equal(
            G.g1_masked_sum(words, mask), G._masked_sum_plain(words, mask)))
        out[f"fold R={r}"] = timed(lambda: G.g1_masked_sum(words, mask),
                                   "g1_")
    tabs = {}
    for n in TABLE_ROWS:
        pub = torch.from_numpy(np.frombuffer(rng.bytes(32 * n), np.uint8)
                               .reshape(n, 32).copy()).to(dev)
        tab_k, ok_k = ed.prepare_pubkey_tables(pub)
        tab_p, ok_p = ed._prepare_plain(pub)
        out["mismatches"][f"tables N={n}"] = int(
            (ed.tables_canonical(tab_k) != ed.tables_canonical(tab_p))
            .flatten(1).any(1).sum()) + int((ok_k != ok_p).sum())
        out[f"tables N={n}"] = timed(lambda: ed.prepare_pubkey_tables(pub),
                                     "ed25519_tables")
        tabs[n] = (tab_k, ok_k)
    for b in RLC_LANES:
        tab, ok = tabs[b]

        def lanes(k):
            return torch.from_numpy(np.frombuffer(rng.bytes(k * b), np.uint8)
                                    .reshape(b, k).copy()).to(dev)

        idx = torch.arange(b, dtype=torch.int32, device=dev)
        rb, sb = lanes(32), lanes(32)
        blocks = lanes(256).view(torch.int32).reshape(b, 2, 32)
        active = torch.full((b,), 2, dtype=torch.int32, device=dev)
        z = torch.from_numpy(rlc.host_rlc_coeffs(
            b, rng_bytes=rng.bytes(16 * b))).to(dev)
        out[f"rlc B={b}"] = timed(lambda: rlc.verify_batch_rlc_gather(
            tab, ok, idx, rb, sb, blocks, active, z), "rlc_")
    line = json.dumps(out)
    print(line)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return 1 if any(out["mismatches"].values()) else 0


if __name__ == "__main__":
    sys.exit(main())
