#!/usr/bin/env python3
"""Where an in-process consensus network spends its host time.

Builds ``cometbft_tpu_torch.testing.make_inproc_network`` with ``--vals``
validators at power 10 on ``--device`` (the node's default propose,
prevote and precommit timeouts and a 100 ms commit timeout, as
``chip_smoke.py`` phase 12 (b) runs it), waits for height 1, then runs
heights 2 to ``--heights`` under ``cProfile`` and prints each height's
wall (when the last node committed it), the verification scheduler's
one-lane checks, and the ``--top`` functions by own time and by
cumulative time.  ``cProfile`` adds cost to every Python call, so the
walls here read higher than the smoke's; the shares show where the
Python goes.

Run from the repository root on a machine with a CUDA card:

    python3 scripts/consensus_host_profile.py --vals 150 --heights 3

``--device cpu`` runs the kernels' plain versions (about 0.4 s a
one-lane check: keep ``--vals`` small there).
"""

from __future__ import annotations

import argparse
import asyncio
import cProfile
import io
import os
import pstats
import subprocess
import sys
import time


def _card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.TimeoutExpired):
        return "no card"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--vals", type=int, default=150)
    ap.add_argument("--heights", type=int, default=3)
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)

    import torch

    if args.device != "cpu" and not torch.cuda.is_available():
        print("consensus_host_profile: no CUDA card; pass --device cpu",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from cometbft_tpu_torch.config import MS, ConsensusConfig
    from cometbft_tpu_torch.crypto import scheduler as vsched
    from cometbft_tpu_torch.testing import make_inproc_network

    print(_card())
    loop = asyncio.new_event_loop()
    run = loop.run_until_complete
    net = run(make_inproc_network(
        args.vals, chain_id="profile-chain", device=args.device,
        config=ConsensusConfig(timeout_commit=100 * MS)))
    sched = vsched.get_scheduler()
    walls = {}
    prof = cProfile.Profile()
    try:
        t0 = time.perf_counter()
        run(net.start())
        run(net.wait_for_height(1, timeout=600))
        walls[1] = time.perf_counter() - t0
        before = dict(sched.stats()["single_checks"])
        prof.enable()
        for h in range(2, args.heights + 1):
            run(net.wait_for_height(h, timeout=600))
            walls[h] = time.perf_counter() - t0
        prof.disable()
        after = dict(sched.stats()["single_checks"])
    finally:
        run(net.stop())
        loop.close()
    print(f"{args.vals} validators on {args.device}: height 1 at "
          f"{walls[1]:.2f} s; then " + ", ".join(
              f"{walls[h] - walls[h - 1]:.2f}"
              for h in range(2, args.heights + 1))
          + " s a height (under cProfile)")
    print(f"one-lane checks in heights 2-{args.heights}: "
          f"{ {k: after.get(k, 0) - before.get(k, 0) for k in after} }")
    for key in ("tottime", "cumulative"):
        out = io.StringIO()
        pstats.Stats(prof, stream=out).sort_stats(key).print_stats(args.top)
        print(f"--- top {args.top} by {key}")
        print("\n".join(line for line in out.getvalue().splitlines()
                        if line.strip() and "function calls" not in line
                        and "Ordered by" not in line
                        and "List reduced" not in line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
