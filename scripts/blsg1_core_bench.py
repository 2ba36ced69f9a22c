#!/usr/bin/env python3
"""Cycles of the G1 fold's primitives on one CUDA card.

    python3 scripts/blsg1_core_bench.py [--out PATH]

Builds ``scripts/blsg1_core_bench.cu`` against the shipped
``csrc/blsg1.cu`` (the kernels' flags) and times, with ``clock64``
inside the kernel, dependent chains of the Montgomery product
(``fp_mul``), the modular addition (``fp_add``) and the product by 12
(``fp_mul12``, four additions) on one warp and on 132 blocks of 384
threads (12 warps an SM), and levels of the fold's six-thread addition
(``g1_add_shared``) on one block of 384 threads with all 64 additions
of a level at work, with one, and on 132 such blocks: cycles per call
or per level, and each level's phases (round 1, its store, round 2, its
store, the combination; ``blsg1.cu:G1_STAMP``) on the one block; and a
candidate product with PTX carry chains (``fp_mul_cc``), its results
held against ``fp_mul`` word for word.  Prints one JSON object, with
the card's name and power limit, and writes it to ``--out``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SRC = Path(__file__).resolve().with_suffix(".cu")
# (name, which, additions a level, blocks, threads)
CASES = (("fp_mul", 0, 0, 1, 32), ("fp_mul", 0, 0, 132, 384),
         ("fp_mul_cc", 4, 0, 1, 32), ("fp_mul_cc", 4, 0, 132, 384),
         ("fp_add", 1, 0, 1, 32), ("fp_add", 1, 0, 132, 384),
         ("fp_mul12", 2, 0, 1, 32),
         ("level, 64 additions", 3, 64, 1, 384),
         ("level, 1 addition", 3, 1, 1, 384),
         ("level, 64 additions", 3, 64, 132, 384))
PHASES = ("round 1", "store 1", "round 2", "store 2", "combine")
CHAIN = 100


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from cometbft_tpu_torch.ops import _build

    work = Path(tempfile.mkdtemp(prefix="blsg1_core_bench_"))
    (work / "blsg1_consts.h").write_text(_build.blsg1_consts_header())
    lib_path = work / "libbench.so"
    subprocess.run([_build._nvcc(), *_build.FLAGS, "-I", str(_build.CSRC),
                    "-I", str(work), "-o", str(lib_path), str(SRC)],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.bench_launch.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2
    result = {"card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), "cycles": {}}
    for name, which, groups, blocks, threads in CASES:
        out = torch.zeros(blocks * threads * 12, dtype=torch.int32,
                          device="cuda")
        for n in (10, CHAIN):
            cyc = torch.zeros(2 * blocks + 5, dtype=torch.int64,
                              device="cuda")
            err = lib.bench_launch(which, n, groups, blocks, threads,
                                   out.data_ptr(), cyc.data_ptr())
            if err:
                raise RuntimeError(f"{name}: CUDA error {err}")
        result["cycles"][f"{name} {blocks}x{threads}"] = \
            cyc[:blocks].double().mean().item() / CHAIN
        if int(cyc[blocks:2 * blocks].sum()):
            result.setdefault("mismatched_words", {})[name] = \
                int(cyc[blocks:2 * blocks].sum())
        if which == 3 and blocks == 1:
            result["cycles"].update({
                f"{name}: {p}": int(cyc[2 * blocks + j]) / CHAIN
                for j, p in enumerate(PHASES)})
    text = json.dumps(result, indent=1)
    print(text)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
