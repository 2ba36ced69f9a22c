"""Build, load and count the port's CUDA kernels.

The sources in ``csrc/`` compile with ``nvcc`` into one shared library
per source, each with plain C entry points that ``ctypes`` loads (no
PyTorch headers, so a build takes seconds).  The ``nvcc`` processes, one
per source, run at once.  The build happens at the first launch, never
at import, into the kernel bundle (``crypto/aotbundle.py``:
``build/cometbft_tpu_torch/bundle-<version>/`` under the checkout by
default, keyed by a hash of the sources, the modules the constants
headers are generated from and the flags, with a manifest of the
compiler and the card), so an edited source rebuilds and an unchanged
one loads, without generating a header.

``ed25519_consts.h`` is generated here from the port's own oracle
(``crypto/_ed25519_py.py``) and from ``ops/fe.py``, ``ops/group.py``,
``ops/ed25519.py``, ``ops/scalar.py`` and ``ops/sha512.py``,
``sha256_consts.h`` from ``ops/sha256.py`` and ``blsg1_consts.h`` from
``ops/blsg1.py``, so the kernels and the plain versions share one source
for every constant.

Every wrapper launches through :func:`launch`, which adds one to
``LAUNCHES[name]``, calls the C entry with the tensor's device current
and PyTorch's current stream there, and turns the entry's
``cudaGetLastError`` return into an exception.  A wrapper adds one to
``PLAIN_CALLS[name]`` where it runs the plain version on CPU tensors.
"""

from __future__ import annotations

import collections
import ctypes
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["LAUNCHES", "PLAIN_CALLS", "reset_launches", "load", "launch",
           "check_arg", "check_index", "build_dir",
           "consts_header", "sha256_consts_header", "blsg1_consts_header",
           "generated_headers",
           "build_log"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
ROOT = Path(__file__).resolve().parents[2]
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I = ctypes.c_void_p, ctypes.c_int
# kernel -> (source, C entry, argument types); one library per source
KERNELS = {
    "sha512_scalar": ("sha512_scalar.cu", "sha512_scalar_launch",
                      [_P, _P, _I, _I, _P, _P]),
    "ed25519_tables": ("ed25519_tables.cu", "ed25519_tables_launch",
                       [_P, _I, _I, _P, _P, _P]),
    "ed25519_verify_gather": ("ed25519_verify.cu",
                              "ed25519_verify_gather_launch",
                              [_P] * 7 + [_I, _I, _P, _P]),
    "ed25519_rlc_gather": ("ed25519_rlc.cu", "ed25519_rlc_gather_launch",
                           [_P] * 8 + [_I] * 3 + [_P] * 10),
    "ed25519_rlc_sums": ("ed25519_rlc.cu", "ed25519_rlc_sums_launch",
                         [_P] * 8 + [_I, _I, _P, _P, _I, _I] + [_P] * 9),
    "ed25519_rlc_combine": ("ed25519_rlc.cu", "ed25519_rlc_combine_launch",
                            [_P, _P, _P, _I, _P, _P]),
    "sha256_leaves": ("sha256.cu", "sha256_leaves_launch",
                      [_P, _P, _I, _I, _P, _P]),
    "merkle_level": ("sha256.cu", "merkle_level_launch", [_P, _I, _P, _P]),
    "merkle_tree": ("sha256.cu", "merkle_tree_launch", [_P, _I, _P]),
    "merkle_tree_leaves": ("sha256.cu", "merkle_tree_leaves_launch",
                           [_P, _P, _I, _I, _P, _P]),
    "aggregate_g1_masked": ("blsg1.cu", "aggregate_g1_masked_launch",
                            [_P, _P, _I, _I, _P, _I, _P, _P]),
}

LAUNCHES: collections.Counter = collections.Counter()
PLAIN_CALLS: collections.Counter = collections.Counter()
_LIBS: dict = {}


def reset_launches() -> None:
    LAUNCHES.clear()
    PLAIN_CALLS.clear()


def _c_array(values, fmt: str = "{}") -> str:
    if isinstance(values, (list, tuple)):
        return "{" + ", ".join(_c_array(v, fmt) for v in values) + "}"
    return fmt.format(values)


def consts_header() -> str:
    """The generated ``ed25519_consts.h``: every constant the device code
    needs, from the same Python definitions the plain versions use."""
    from . import fe, group, scalar, sha512
    from .ed25519 import base_comb_rows, base_niels_rows

    base = base_niels_rows()
    consts = [fe.limbs_from_int(v) for v in (
        fe.D_INT, group.D2_INT, fe.SQRT_M1_INT, group.INV2_INT,
        group.INV2D_INT)]
    lines = [
        "// Generated by cometbft_tpu_torch/ops/_build.py; do not edit.",
        "#pragma once",
        "enum { FE_D = 0, FE_D2 = 1, FE_SQRTM1 = 2, FE_INV2 = 3, "
        "FE_INV2D = 4 };",
        f"__constant__ int32_t c_fe_consts[5][10] = {_c_array(consts)};",
        "__constant__ int32_t c_base_niels[16][3][10] = "
        f"{_c_array(base)};",
        "DEV_TABLE int32_t c_base_comb[64][16][3][10] = "
        f"{_c_array(base_comb_rows())};",
        "__constant__ uint64_t c_sha512_k[80] = "
        f"{_c_array(sha512.K64, '{}ULL')};",
        "__constant__ uint64_t c_sha512_iv[8] = "
        f"{_c_array(sha512.IV64, '{}ULL')};",
        f"__constant__ int64_t c_sc_mu[6] = {_c_array(scalar.MU, '{}LL')};",
        "__constant__ uint8_t c_l_bytes[32] = "
        f"{_c_array(list(scalar.L_INT.to_bytes(32, 'little')))};",
    ]
    return "\n".join(lines) + "\n"


def sha256_consts_header() -> str:
    """The generated ``sha256_consts.h``: the SHA-256 round constants and
    initial state of the plain versions (``ops/sha256.py``)."""
    from . import sha256

    return "\n".join([
        "// Generated by cometbft_tpu_torch/ops/_build.py; do not edit.",
        "#pragma once",
        "__constant__ uint32_t c_sha256_k[64] = "
        f"{_c_array([int(k) for k in sha256.K], '{}u')};",
        "__constant__ uint32_t c_sha256_iv[8] = "
        f"{_c_array([int(v) for v in sha256.IV], '{}u')};",
    ]) + "\n"


def blsg1_consts_header() -> str:
    """The generated ``blsg1_consts.h``: p, -p^-1 mod 2^32 and the
    Montgomery constants of the plain versions (``ops/blsg1.py``), as
    little-endian 32-bit words, and the fold's rows a block
    (``FOLD_ROWS``, which a build may set first)."""
    from . import blsg1

    def words(v: int) -> str:
        return _c_array([(v >> (32 * i)) & 0xFFFFFFFF
                         for i in range(blsg1.NWORD)], "{}u")

    return "\n".join([
        "// Generated by cometbft_tpu_torch/ops/_build.py; do not edit.",
        "#pragma once",
        f"__constant__ uint32_t c_bls_p[12] = {words(blsg1.P_INT)};",
        f"__constant__ uint32_t c_bls_r2[12] = {words(blsg1.R2_INT)};",
        f"__constant__ uint32_t c_bls_one_m[12] = {words(blsg1.ONE_M_INT)};",
        f"__constant__ uint32_t c_bls_b3_m[12] = {words(blsg1.B3_M_INT)};",
        f"__constant__ uint32_t c_bls_n0 = {blsg1.N0_WORD}u;",
        "#ifndef G1_ROWS",
        f"#define G1_ROWS {blsg1.FOLD_ROWS}",
        "#endif",
    ]) + "\n"


def generated_headers() -> dict:
    """Header name -> text of every generated header the sources include."""
    return {"ed25519_consts.h": consts_header(),
            "sha256_consts.h": sha256_consts_header(),
            "blsg1_consts.h": blsg1_consts_header()}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", "") + "/bin/nvcc",
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin and PATH)")


def build_dir() -> Path:
    """The kernel bundle's directory (``crypto/aotbundle.py:
    default_path``), where the libraries are built and loaded."""
    from ..crypto import aotbundle

    return Path(aotbundle.default_path())


def build_log() -> str:
    """The compiler's output (``-Xptxas -v``: registers, spills) of the
    current build, or "" before the first build."""
    log = build_dir() / "build.log"
    return log.read_text() if log.exists() else ""


def _sources() -> list:
    """The kernel sources, each built once (in ``KERNELS`` order)."""
    return list(dict.fromkeys(src for src, _, _ in KERNELS.values()))


def _lib_name(src: str) -> str:
    return src.removesuffix(".cu")


def _build_all(out: Path) -> None:
    """Compile every kernel source at once, one nvcc per source."""
    nvcc = _nvcc()
    for name, text in generated_headers().items():
        (out / name).write_text(text)
    procs = []
    for src in _sources():
        name = _lib_name(src)
        tmp = out / f"lib{name}.so.tmp"
        cmd = [nvcc, *FLAGS, "-I", str(out), "-I", str(CSRC), "-o",
               str(tmp), str(CSRC / src)]
        procs.append((name, tmp, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    logs, failed = [], []
    for name, tmp, cmd, proc in procs:
        text = proc.communicate()[0].decode(errors="replace")
        logs.append(f"== {name}: {' '.join(cmd)}\n{text}")
        if proc.returncode != 0:
            failed.append(name)
        else:
            os.replace(tmp, out / f"lib{name}.so")
    (out / "build.log").write_text("\n".join(logs))
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(logs))


def load(name: str):
    """The ctypes entry point of kernel ``name``; on first use in a
    process every kernel is bound from the kernel bundle, which is built
    (one nvcc per source, at once) where it is absent or does not match
    the sources, the compiler or the card (``crypto/aotbundle.py:
    ensure``).  A failed build raises."""
    fn = _LIBS.get(name)
    if fn is not None:
        return fn
    from ..crypto import aotbundle

    aotbundle.ensure()
    return _LIBS[name]


def launch(name: str, t, *args) -> None:
    """Launch kernel ``name`` on ``t``'s card: the C entry gets ``args``
    and then PyTorch's current stream on that card, and is called with
    the card current, since the CUDA runtime launches on the calling
    thread's current device.  Counts one launch."""
    import torch

    fn = load(name)
    LAUNCHES[name] += 1
    with torch.cuda.device(t.device):
        err = fn(*args, torch.cuda.current_stream(t.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def check_arg(t, name: str, dtype, shape) -> None:
    """Validate a kernel argument: dtype, shape (None = any) and layout."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, want {dtype}")
    if len(t.shape) != len(shape) or any(
            s is not None and s != d for s, d in zip(shape, t.shape)):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, want {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def check_index(*checks) -> None:
    """For each ``(t, n, name)``, every entry of ``t`` must lie in [0, n):
    a row of an ``n``-row table, or a count of blocks; the kernels read
    without bounds checks.  One reduction per tensor and, on the card,
    one synchronization for all of them."""
    import torch

    live = [c for c in checks if c[0].numel()]
    if not live:
        return
    bad = torch.stack([((t < 0) | (t >= n)).any() for t, n, _ in live])
    for (_, n, name), b in zip(live, bad.tolist()):
        if b:
            raise IndexError(f"{name}: an entry lies outside [0, {n})")
