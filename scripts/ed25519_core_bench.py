#!/usr/bin/env python3
"""Cycles of the Ed25519 device core's primitives on one CUDA card.

    python3 scripts/ed25519_core_bench.py [--out PATH]

Builds ``scripts/ed25519_core_bench.cu`` against the shipped
``csrc/ed25519.cuh`` (the kernels' flags) and times, with ``clock64``
inside the kernel, dependent chains of ``fe_mul``, ``fe_sq``, a quad
gather (``fe_gather4``, plus one addition), the quad doubling and
addition (``geq_dbl``, ``geq_add``) and the one-thread doubling
(``ge_dbl``): cycles per call on one warp (one block of 32 threads) and
on 528 blocks of 128 threads (16 warps an SM).  Prints one JSON object,
with the card's name and power limit, and writes it to ``--out``.
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
PRIMITIVES = ("fe_mul", "fe_sq", "gather4", "geq_dbl", "geq_add", "ge_dbl")
SHAPES = ((1, 32), (528, 128))
CHAIN = 200


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

    work = Path(tempfile.mkdtemp(prefix="ed25519_core_bench_"))
    (work / "ed25519_consts.h").write_text(_build.consts_header())
    lib_path = work / "libbench.so"
    subprocess.run([_build._nvcc(), *_build.FLAGS, "-I", str(_build.CSRC),
                    "-I", str(work), "-o", str(lib_path), str(SRC)],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.bench_launch.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
    result = {"card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), "cycles": {}}
    for which, name in enumerate(PRIMITIVES):
        for blocks, threads in SHAPES:
            out = torch.zeros(blocks * threads * 10, dtype=torch.int32,
                              device="cuda")
            cyc = torch.zeros(blocks, dtype=torch.int64, device="cuda")
            lib.bench_launch(which, 10, blocks, threads, out.data_ptr(),
                             cyc.data_ptr())
            err = lib.bench_launch(which, CHAIN, blocks, threads,
                                   out.data_ptr(), cyc.data_ptr())
            if err:
                raise RuntimeError(f"{name}: CUDA error {err}")
            result["cycles"][f"{name} {blocks}x{threads}"] = \
                cyc.double().mean().item() / CHAIN
    text = json.dumps(result, indent=1)
    print(text)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
