#!/usr/bin/env python3
"""Count the instructions of the built G1 fold (``csrc/blsg1.cu``) from its
SASS: the operations of one point addition and of one Montgomery
product, the counts behind the bound of ``aggregate_g1_masked`` that
``chip_smoke.py`` prints.

    python3 scripts/blsg1_sass_count.py [--out PATH] [--sass PATH]

Builds the port's kernels (``cometbft_tpu_torch/ops/_build.py``, the
same flags as the smoke run), disassembles ``libblsg1.so`` with
``cuobjdump -sass`` (``--sass`` keeps the listing) and counts the
instructions by class, as ``scripts/sha256_sass_count.py`` does.
``fp_mul`` is a called function (``__noinline__``): each kernel's
listing holds its own code up to its last ``EXIT`` and then one copy of
the callee (from the ``CALL`` target to the ``RET``), so one addition is
the level kernel's own instructions plus, for each of its 14 calls, the
callee's.  A backward branch would make a static count differ from the
dynamic one; the listing has none (reported as ``loops``).  Needs the
CUDA toolkit but no card.  Prints one JSON object and writes it to
``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))
from sha256_sass_count import loops, parse, tally  # noqa: E402


def split(insns) -> tuple:
    """(the kernel's own instructions, the callee's, number of calls):
    the callee runs from the ``CALL`` target to its ``RET``."""
    targets = {int(m.group(1), 16) for _, op, args in insns if op == "CALL"
               for m in [re.search(r"0x([0-9a-f]+)", args)] if m}
    calls = sum(op == "CALL" for _, op, _ in insns)
    if not targets:
        return insns, [], 0
    start = min(targets)
    ret = next(a for a, op, _ in insns if op == "RET" and a >= start)
    return ([i for i in insns if i[0] < start],
            [i for i in insns if start <= i[0] <= ret], calls)


def count(sass: str) -> dict:
    """Per-kernel tallies (own code and callee) and the per-addition and
    per-product totals, all instructions and the integer ALU ones."""
    out = {"kernels": {}}
    parts = {}
    for name, insns in parse(sass).items():
        short = next((k for k in ("g1_load_kernel", "g1_level_kernel",
                                  "g1_store_kernel") if k in name), name)
        own, callee, calls = split(insns)
        parts[short] = (own, callee, calls)
        out["kernels"][short] = {"own": tally(own), "callee": tally(callee),
                                 "calls": calls, "loops": len(loops(insns))}
    if "g1_level_kernel" not in parts:
        raise RuntimeError("g1_level_kernel not found in the SASS")
    own, callee, calls = parts["g1_level_kernel"]
    t_own, t_mul = tally(own), tally(callee)
    out["ops_per_mul"] = t_mul["total"]
    out["int_alu_per_mul"] = t_mul["classes"].get("int_alu", 0)
    out["mul_calls_per_add"] = calls
    out["ops_per_add"] = t_own["total"] + calls * t_mul["total"]
    out["int_alu_per_add"] = (t_own["classes"].get("int_alu", 0)
                              + calls * out["int_alu_per_mul"])
    out["loops"] = sum(k["loops"] for k in out["kernels"].values())
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--sass", default=None,
                    help="also write the SASS listing to this path")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from cometbft_tpu_torch.ops import _build

    _build.load("aggregate_g1_masked")
    lib = _build.build_dir() / "libblsg1.so"
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout
    result = {"library": str(lib.relative_to(ROOT)), **count(sass)}
    print(json.dumps(result))
    for path, text in ((args.out, json.dumps(result, indent=1)),
                       (args.sass, sass)):
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)),
                        exist_ok=True)
            Path(path).write_text(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
