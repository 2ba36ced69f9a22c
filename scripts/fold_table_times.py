#!/usr/bin/env python3
"""Time the G1 fold (K9, ``aggregate_g1_masked``), the validator-table
kernel (K5a, ``ed25519_tables``), the RLC verdict (K6a,
``ed25519_rlc_gather``) and K7's sums with their SHA-512, and the merkle
tree with its leaves, of one checkout of the port on the card, as the
main path calls them, and hold the fold, the tables and the tree exactly
against their plain versions.

    python3 scripts/fold_table_times.py [--root DIR] [--out PATH]

``--root`` names the checkout whose ``cometbft_tpu_torch`` is imported
(default: this one), so that two checkouts, such as a commit and its
parent unpacked with ``git archive``, can be timed in turn on one card
in one run (parent, change, change, parent).  Each checkout builds
its own kernels into its own ``build/``.  A checkout whose RLC wrappers
launch ``sha512_scalar`` before the verdict is timed with it, since its
main path runs both; a checkout without
``ops/sha256.py:merkle_tree_leaves`` times its leaf call and its tree
call one after the other in one loop, and each alone.  The inputs are
seeded random data, not signed keys (field elements below p as affine
rows, random 32-byte encodings as keys and signature halves, random
SHA-512 blocks, every one active): the kernels do the same work
whatever the values, so the times hold for real inputs; the RLC verdict
over them is a reject, which is not checked.  Sizes: the fold at
``FOLD_ROWS`` rows (every 50th absent at 10,000, the BLS main path's
mask; half at random at 200, an absentee fold's size), the tables at
``TABLE_ROWS`` validators, the verdict at ``RLC_LANES`` lanes (two
SHA-512 blocks a lane; at the largest also with every active count 0,
so that its lane stage hashes nothing: what the hash costs the stage),
K7's sums over ``SUMS_SHARDS`` shards of the largest on one card in one
call, trees of ``TREE_LEAVES`` one-block leaves.  ms: CUDA events over
``REPS`` calls; device ms: ``torch.profiler``, two traces of ``REPS``
calls, the larger kept, summed over the call's kernels (and the RLC
lane stage, ``rlc_lane_kernel``, alone).  Prints one JSON line and
writes it to ``--out``.  Needs a card.
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
SUMS_SHARDS = 4
TREE_LEAVES = (2048, 10_000)


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
    from cometbft_tpu_torch.crypto import merkle
    from cometbft_tpu_torch.ops import _build
    from cometbft_tpu_torch.ops import blsg1 as G
    from cometbft_tpu_torch.ops import ed25519 as ed
    from cometbft_tpu_torch.ops import rlc
    from cometbft_tpu_torch.ops import sha256 as S

    sm = _smoke()
    dev = torch.device("cuda:0")
    rng = np.random.default_rng(7)
    fused_tree = hasattr(S, "merkle_tree_leaves")
    out = {"root": str(root), "card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), "fused_tree": fused_tree,
        "mismatches": {}}

    def device(fn, prefixes):
        """Device ms per call of the kernels named ``prefixes...``: two
        traces, the larger kept."""
        best = None
        for _ in range(2):
            k = sm.profile_call(fn, REPS, top=None)["kernels_ms"]
            v = sum(ms for name, ms in k.items()
                    if name.removeprefix("void ").startswith(prefixes))
            best = v if best is None else max(best, v)
        return best

    def timed(fn, prefixes, **extra):
        return {"ms": sm.time_cuda(fn, REPS),
                "device_ms": device(fn, prefixes),
                **{k: device(fn, p) for k, p in extra.items()}}

    def rand(b, k):
        return torch.from_numpy(np.frombuffer(rng.bytes(k * b), np.uint8)
                                .reshape(b, k).copy()).to(dev)

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
                                   ("g1_",))
    tabs = {}
    for n in TABLE_ROWS:
        pub = rand(n, 32)
        tab_k, ok_k = ed.prepare_pubkey_tables(pub)
        tab_p, ok_p = ed._prepare_plain(pub)
        out["mismatches"][f"tables N={n}"] = int(
            (ed.tables_canonical(tab_k) != ed.tables_canonical(tab_p))
            .flatten(1).any(1).sum()) + int((ok_k != ok_p).sum())
        out[f"tables N={n}"] = timed(lambda: ed.prepare_pubkey_tables(pub),
                                     ("ed25519_tables",))
        tabs[n] = (tab_k, ok_k)

    rlc_kernels = ("rlc_", "sha512_scalar")
    lane = {"lane_device_ms": ("rlc_lane_kernel",)}
    for b in RLC_LANES:
        tab, ok = tabs[b]
        idx = torch.arange(b, dtype=torch.int32, device=dev)
        rb, sb = rand(b, 32), rand(b, 32)
        blocks = rand(b, 256).view(torch.int32).reshape(b, 2, 32)
        active = torch.full((b,), 2, dtype=torch.int32, device=dev)
        z = torch.from_numpy(rlc.host_rlc_coeffs(
            b, rng_bytes=rng.bytes(16 * b))).to(dev)
        out[f"rlc B={b}"] = timed(lambda: rlc.verify_batch_rlc_gather(
            tab, ok, idx, rb, sb, blocks, active, z), rlc_kernels, **lane)
    idle = torch.zeros_like(active)
    out[f"rlc B={b}, active 0"] = timed(lambda: rlc.verify_batch_rlc_gather(
        tab, ok, idx, rb, sb, blocks, idle, z), rlc_kernels, **lane)
    buf = rlc.rlc_sums_buffers(SUMS_SHARDS, dev)
    step = -(-b // SUMS_SHARDS)
    offs = [min(b, d * step) for d in range(SUMS_SHARDS + 1)]
    out[f"sums {SUMS_SHARDS} shards of one card, B={b}"] = timed(
        lambda: rlc._rlc_sums_card(tab, ok, idx, rb, sb, blocks, active, z,
                                   offs, list(range(SUMS_SHARDS)), buf),
        rlc_kernels, **lane)

    tree_kernels = ("sha256_leaves", "merkle_")
    for n in TREE_LEAVES:
        items = [rng.bytes(int(k)) for k in rng.integers(36, 47, size=n)]
        blocks, active = merkle._leaf_blocks(items)
        bt = torch.from_numpy(blocks.view(np.int32)).to(dev)
        at = torch.from_numpy(active).to(dev)
        levels = torch.empty((S.tree_rows(n), 8), dtype=torch.int32,
                             device=dev)
        if fused_tree:
            got = S.merkle_tree_leaves(bt, at, levels)
            out["mismatches"][f"tree n={n}"] = int(
                (got.cpu() != S.merkle_tree_leaves(bt.cpu(), at.cpu()))
                .any(1).sum())
            out[f"tree n={n}"] = timed(
                lambda: S.merkle_tree_leaves(bt, at, levels), tree_kernels)
            continue

        def tree():
            S.sha256_leaf_words(bt, at, out=levels[:n])
            S.merkle_tree(levels, n)

        out[f"tree n={n}"] = timed(tree, tree_kernels)
        out[f"leaves alone n={n}"] = timed(
            lambda: S.sha256_leaf_words(bt, at, out=levels[:n]),
            tree_kernels)
        out[f"tree alone n={n}"] = timed(lambda: S.merkle_tree(levels, n),
                                         tree_kernels)
    out["ptxas"] = {k: v for k, v in sm.ptxas_usage(
        _build.build_log()).items() if k.startswith(
            ("rlc_lane_kernel", "merkle_", "ed25519_tables", "g1_"))}
    line = json.dumps(out)
    print(line)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return 1 if any(out["mismatches"].values()) else 0


if __name__ == "__main__":
    sys.exit(main())
