"""Shared by the host kernel harness's files
(``tests/test_torch_kernels_host_*.py``, one a kernel family, so that
``--dist loadfile`` spreads the families over test workers).

``tests/torch_kernels_host.cpp`` includes the six sources of
``cometbft_tpu_torch/csrc`` as they are and runs each kernel and launch
sequence with host threads (a block's threads, a barrier for
``__syncthreads``).  It is compiled with ``g++ -fsanitize=address,
undefined``, so undefined behaviour in the device code (a signed
overflow, a shift out of range, a read out of bounds) stops the run.
What it computes must equal the plain PyTorch versions exactly: tables
and window sums as field elements mod p (sums as group elements, since
the two folds add in different orders), digests and verdicts bit for
bit.  The tolerance is zero.

The files share one build of the harness: :func:`harness_exe` builds it
into the checkout's ``build/``, keyed by a hash of its sources, the
generated headers and the compiler line, under a file lock, so parallel
workers wait for one build instead of each compiling its own."""

import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

from cometbft_tpu_torch.crypto import _ed25519_py as ref
from cometbft_tpu_torch.ops import _build

HERE = Path(__file__).resolve().parent
L, P = ref.L, ref.P

CXX = ["g++", "-std=c++20", "-O1", "-g", "-fsanitize=address,undefined",
       "-fno-sanitize-recover=all", "-fno-omit-frame-pointer", "-Wall",
       "-Werror", "-Wno-unknown-pragmas", "-pthread"]

needs_gxx = pytest.mark.skipif(shutil.which("g++") is None,
                               reason="needs g++ to build the kernel sources "
                                      "for the host")


def _confine():
    """Two CPUs, picked by the test worker's number so that the files'
    harness runs on parallel workers do not share theirs, at the lowest
    priority."""
    cpus = sorted(os.sched_getaffinity(0))
    k = 2 * int(os.environ.get("PYTEST_XDIST_WORKER", "gw0")[2:] or 0)
    os.sched_setaffinity(0, {cpus[k % len(cpus)], cpus[(k + 1) % len(cpus)]})
    os.nice(19)


def harness_exe() -> Path:
    """The harness binary for the sources as they are, built once."""
    src = HERE / "torch_kernels_host.cpp"
    headers = _build.generated_headers()
    h = hashlib.sha256(" ".join(CXX).encode())
    for f in [src] + sorted(p for p in _build.CSRC.iterdir() if p.is_file()):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    for name, text in sorted(headers.items()):
        h.update(name.encode())
        h.update(text.encode())
    d = _build.ROOT / "build" / "torch_kernels_host" / h.hexdigest()[:16]
    exe = d / "torch_kernels_host"
    if exe.exists():
        return exe
    d.mkdir(parents=True, exist_ok=True)
    with open(d / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not exe.exists():               # another worker may have built
            for name, text in headers.items():
                (d / name).write_text(text)
            tmp = d / "torch_kernels_host.tmp"
            proc = subprocess.run(
                [*CXX, "-I", str(_build.CSRC), "-I", str(d), "-o", str(tmp),
                 str(src)], capture_output=True, text=True)
            assert proc.returncode == 0, proc.stderr[-4000:]
            tmp.replace(exe)
    return exe


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    exe = harness_exe()
    d = tmp_path_factory.mktemp("kernels_host")
    env = dict(os.environ, ASAN_OPTIONS="detect_leaks=0:abort_on_error=0",
               UBSAN_OPTIONS="print_stacktrace=1")
    count = [0]

    def run(mode, args, inputs, outputs):
        count[0] += 1
        io = d / f"call{count[0]}"
        io.mkdir()
        for name, a in inputs.items():
            np.ascontiguousarray(a).tofile(io / f"{name}.bin")
        # a block is up to 128 host threads that meet at barriers: two
        # CPUs at the lowest priority, so that other test processes do
        # not starve beside it
        proc = subprocess.run([str(exe), mode, str(io), *map(str, args)],
                              capture_output=True, text=True, env=env,
                              preexec_fn=_confine)
        assert proc.returncode == 0, proc.stderr[-4000:]
        return {name: np.fromfile(io / f"{name}.bin", dtype).reshape(shape)
                for name, (dtype, shape) in outputs.items()}

    return run
