"""The port stands alone: no module of ``cometbft_tpu_torch`` and nothing
``chip_smoke.py`` imports pulls in ``jax``, the JAX package or
``msgpack`` (absent on the card's machine; the port's codec carries its
own), at import time (checked in a fresh interpreter) or lazily inside a
function (checked on the source), and its CUDA and host C++ sources
include only headers of the port's own ``csrc/`` (or headers the port
generates)."""

import ast
import json
import os
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "cometbft_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "cometbft_tpu", "msgpack")


def _port_modules():
    import cometbft_tpu_torch

    names = ["cometbft_tpu_torch"]
    for info in pkgutil.walk_packages(cometbft_tpu_torch.__path__,
                                      "cometbft_tpu_torch."):
        names.append(info.name)
    return names


def _sources():
    return sorted(PKG.rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "scripts" / "cuda_stack_slot_probe.py",
        ROOT / "scripts" / "sha256_sass_count.py",
        ROOT / "scripts" / "fold_table_times.py",
        ROOT / "scripts" / "blsg1_core_bench.py",
        ROOT / "scripts" / "ed25519_core_bench.py"]


def _c_sources():
    return sorted(p for p in (PKG / "csrc").rglob("*")
                  if p.suffix in (".cu", ".cuh", ".cpp", ".h"))


def test_fresh_interpreter_imports_no_jax():
    mods = _port_modules()
    code = (
        "import importlib, json, sys\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "print(json.dumps(sorted(sys.modules)))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"    # torch on one thread, as in the other
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=str(ROOT), env=env)
    assert out.returncode == 0, out.stderr
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert len(mods) >= 16
    bad = [m for m in loaded if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(
    p.relative_to(ROOT)))
def test_no_jax_or_reference_import_anywhere_in_source(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in FORBIDDEN, \
                f"{path.name}:{node.lineno} imports {name}"


def test_chip_smoke_refuses_without_cuda():
    """Here there is no card: the script exits non-zero and prints no
    result line."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: this checks the refusal")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=300,
                         cwd=str(ROOT))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


@pytest.mark.parametrize("path", _c_sources(), ids=lambda p: str(
    p.relative_to(ROOT)))
def test_c_sources_include_only_the_ports_headers(path):
    from cometbft_tpu_torch.ops import _build

    generated = set(_build.generated_headers())
    for line in path.read_text().splitlines():
        m = re.match(r'\s*#\s*include\s+"([^"]+)"', line)
        if not m:
            continue
        name = m.group(1)
        assert ".." not in name and "cometbft_tpu/" not in name, name
        assert ((path.parent / name).exists()
                or (PKG / "csrc" / name).exists()
                or name in generated), f"{path.name} includes {name}"


def test_sign_bytes_encoder_includes_only_standard_headers():
    """The host sign-bytes encoder is a copy of two functions, with no
    header of the JAX package's native code (nor of the port's)."""
    src = (PKG / "csrc" / "host" / "vote_sign_bytes.cpp").read_text()
    includes = re.findall(r'^\s*#\s*include\s+(\S+)', src, re.M)
    assert includes == ["<cstdint>", "<cstring>"]
