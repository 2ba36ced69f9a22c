#!/usr/bin/env python3
"""Count the instructions of the built SHA-256 kernels, by class, from
their SASS, to check the operation count that ``chip_smoke.py`` uses for
the merkle kernels' bound (``SHA256_OPS_PER_BLOCK``).

    python3 scripts/sha256_sass_count.py [--out PATH]

Builds the port's kernels (``cometbft_tpu_torch/ops/_build.py``, the
same flags as the smoke run) and disassembles ``libsha256.so`` with
``cuobjdump -sass``.  For each kernel it counts every instruction by
opcode and by class (integer ALU, memory, control, other); for
``sha256_leaves_kernel`` it also counts the body of the loop over a
lane's blocks (the instructions between a backward branch and its
target), which is one compression.  Needs the CUDA toolkit (``nvcc``,
``cuobjdump``) but no card.  Prints one JSON object and writes it to
``--out``.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
INT_ALU = {"IADD3", "LOP3", "SHF", "IMAD", "LEA", "PRMT", "ISETP", "SEL",
           "IMNMX", "IABS", "SHL", "SHR", "IADD", "LOP", "MOV", "IMUL",
           "VIADD", "IDP", "BMSK", "BREV", "FLO", "POPC"}
MEMORY = {"LDG", "STG", "LDC", "LDS", "STS", "LD", "ST", "LDL", "STL"}
CONTROL = {"BRA", "EXIT", "NOP", "BSYNC", "BSSY", "RET", "CALL", "WARPSYNC",
           "BAR", "JMP"}
_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)"
                   r"(?:\.[A-Z0-9_.]+)?\s*([^;]*);")


def _class(op: str) -> str:
    if op in INT_ALU:
        return "int_alu"
    if op in MEMORY or op.startswith("ULDC"):
        return "memory"
    if op in CONTROL:
        return "control"
    return "other"


def parse(sass: str) -> dict:
    """Function name -> list of (address, opcode, operands)."""
    funcs, cur = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function\s*:\s*(\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = _INSN.search(line)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(2), m.group(3)))
    return funcs


def tally(insns) -> dict:
    ops = collections.Counter(op for _, op, _ in insns)
    classes = collections.Counter()
    for op, n in ops.items():
        classes[_class(op)] += n
    return {"total": len(insns), "classes": dict(classes),
            "opcodes": dict(ops.most_common())}


def loops(insns) -> list:
    """Bodies of the loops closed by a backward branch: (start, end)
    addresses with the body's tally."""
    out = []
    for addr, op, args in insns:
        if op != "BRA":
            continue
        m = re.search(r"0x([0-9a-f]+)", args)
        if not m:
            continue
        target = int(m.group(1), 16)
        if target < addr:
            body = [i for i in insns if target <= i[0] <= addr]
            out.append({"from": target, "to": addr, **tally(body)})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from cometbft_tpu_torch.ops import _build

    _build.load("sha256_leaves")
    lib = _build.build_dir() / "libsha256.so"
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout
    result = {"library": str(lib.relative_to(ROOT)), "kernels": {}}
    for name, insns in parse(sass).items():
        short = next((k for k in ("sha256_leaves_kernel",
                                  "merkle_subtree_kernel") if k in name),
                     name)
        result["kernels"][short] = {**tally(insns), "loops": loops(insns)}
    text = json.dumps(result)
    print(text)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    return 0 if result["kernels"] else 1


if __name__ == "__main__":
    sys.exit(main())
