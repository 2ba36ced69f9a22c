#!/usr/bin/env python3
"""Reproduce, on one CUDA card, the nvcc stack-slot fault that the port's
device code works around, and show that the workaround holds.

    python3 scripts/cuda_stack_slot_probe.py [--out PATH]

Builds ``scripts/cuda_stack_slot_probe.cu`` (over the shipped
``csrc/ed25519.cuh``) in several ways: with its ``__noinline__``
``probe_cache`` reading its input before it writes ("shipped", the rule
``ed25519.cuh`` states) or writing early (``-DEARLY_CACHE``, the body
``ge_cache`` was first written with), with ``-O3``, ``-Xcicc -O1``,
``-Xcicc -O0`` or ``-G``.  Each folds 96 windows of random cached points;
the probe counts the windows whose sum differs, as a group element, from
the plain PyTorch fold (and, for the per-thread build, the thread sums
that differ).  For the ``-O3`` builds it reads the PTX and reports, for
each call of ``probe_cache``, whether one address is passed as both
output and input.  Prints one JSON object and writes it to ``--out``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SRC = Path(__file__).resolve().with_suffix(".cu")
WINDOWS = 96
FLAGS = {"O3": ["-O3"], "O3_perthread": ["-O3", "-DPER_THREAD_OUT"],
         "cicc_O1": ["-O3", "-Xcicc", "-O1"],
         "cicc_O0": ["-O3", "-Xcicc", "-O0"], "G": ["-G"]}
def same_slot_calls(ptx: str, callee: str) -> list:
    """For each call of ``callee`` in ``ptx``: whether param0 and param1
    are the same register."""
    out = []
    for m in re.finditer(r"\{ // callseq.*?\} // callseq", ptx, re.S):
        block = m.group(0)
        if callee not in block:
            continue
        regs = dict(re.findall(r"st\.param\.b64\s+\[(param\d)\+0\],\s*(%\w+);",
                               block))
        out.append(regs.get("param0") == regs.get("param1"))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from cometbft_tpu_torch.crypto import _ed25519_py as ref
    from cometbft_tpu_torch.ops import _build, fe, group
    from cometbft_tpu_torch.ops import ed25519 as ed

    work = Path(tempfile.mkdtemp(prefix="stack_slot_probe_"))
    (work / "ed25519_consts.h").write_text(_build.consts_header())
    nvcc = _build._nvcc()
    base = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17"]
    inc = ["-I", str(_build.CSRC), "-I", str(work)]
    incs = {"early": inc + ["-DEARLY_CACHE"], "shipped": inc}
    variants = {f"{cal}_{fl}": incs[cal] + FLAGS[fl]
                for cal in incs for fl in FLAGS}
    # the .cu sits apart from csrc, so "ed25519.cuh" comes from -I
    procs = {k: subprocess.Popen(
        [nvcc, *base, *v, "-shared", "-Xcompiler", "-fPIC", "-o",
         str(work / f"{k}.so"), str(SRC)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for k, v in variants.items()}
    ptx = {}
    for cal in incs:
        k = f"{cal}_O3"
        subprocess.run([nvcc, *base, *variants[k], "-ptx", "-o",
                        str(work / f"{k}.ptx"), str(SRC)], check=True)
        ptx[k] = same_slot_calls((work / f"{k}.ptx").read_text(),
                                 "_Z11probe_cacheR")
    built = {}
    for k, p in procs.items():
        log = p.communicate()[0].decode(errors="replace")
        built[k] = p.returncode == 0
        if not built[k]:
            print(f"{k}: nvcc failed\n{log}", file=sys.stderr)

    rng = np.random.default_rng(5)
    pubs = []
    while len(pubs) < 64:
        b = rng.bytes(32)
        if ref.pt_decompress_zip215(b) is not None:
            pubs.append(np.frombuffer(b, np.uint8))
    tab, _ = ed._prepare_plain(torch.from_numpy(np.stack(pubs)))
    ents = tab.reshape(-1, 40)

    def point(c):
        ypx, ymx, z2 = (fe.int_from_limbs([int(v) for v in c[k:k + 10]])
                        for k in (0, 10, 20))
        zi = pow(z2, fe.P_INT - 2, fe.P_INT)
        return ((ypx - ymx) * zi % fe.P_INT, (ypx + ymx) * zi % fe.P_INT)

    def plain_sum(rows):
        acc = group.cache(group.identity(1, "cpu"))
        for r in rows:
            r = torch.tensor(r, dtype=torch.int64).reshape(4, 10, 1)
            acc = group.add_cc(acc, group.Cached(r[0], r[1], r[2], r[3]))
        return point(torch.cat([c[:, 0] for c in acc]).tolist())

    result = {"card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(),
        "nvcc": subprocess.run([nvcc, "--version"], capture_output=True,
                               text=True).stdout.strip().splitlines()[-1],
        "same_slot_in_ptx": ptx, "bad_windows": {}}
    for n in (3, 200):
        sel = rng.integers(0, ents.shape[0], size=(WINDOWS, n))
        inp = ents[torch.from_numpy(sel)].contiguous()
        want = [plain_sum(inp[w].tolist()) for w in range(WINDOWS)]
        inp_d = inp.cuda()
        for k in variants:
            if not built[k]:
                result["bad_windows"][f"{k}@{n}"] = "build failed"
                continue
            f = ctypes.CDLL(str(work / f"{k}.so")).fold_launch
            f.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                          ctypes.c_void_p, ctypes.c_int]
            out = torch.zeros((WINDOWS, 40), dtype=torch.int32,
                              device="cuda")
            pt = torch.zeros((WINDOWS, 128, 40), dtype=torch.int32,
                             device="cuda")
            err = f(inp_d.data_ptr(), n, out.data_ptr(), pt.data_ptr(),
                    WINDOWS)
            if err:
                result["bad_windows"][f"{k}@{n}"] = f"CUDA error {err}"
                continue
            got = out.cpu().tolist()
            result["bad_windows"][f"{k}@{n}"] = sum(
                point(got[w]) != want[w] for w in range(WINDOWS))
            if k.endswith("perthread"):      # the sums of 4 windows
                ptc = pt.cpu().tolist()
                result["bad_windows"][f"{k}@{n} threads"] = sum(
                    point(ptc[w][t]) != plain_sum(inp[w, t::128].tolist())
                    for w in range(4) for t in range(128))
    text = json.dumps(result, indent=1)
    print(text)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
