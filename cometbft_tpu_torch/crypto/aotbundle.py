"""The kernel bundle: the port's built CUDA libraries, versioned, loaded
at node start.

Counterpart of ``cometbft_tpu/crypto/aotbundle.py``, whose bundle holds
serialized XLA executables.  The port's kernels are ``nvcc``-built
shared libraries (``ops/_build.py``), so its bundle is a directory,
``<dir>/bundle-<version>/``: one ``lib*.so`` a source of
``ops/_build.py:KERNELS``, the generated constants headers, ``build.log``
and ``manifest.json`` (written last): the format, the version, the
fingerprint, every kernel with its library and C entry, each library's
size, the ``nvcc --version`` line, the card's compute capability and
``torch.version.cuda``.  ``<dir>`` is ``compile_bundle_dir``
(:func:`configure`), by default the checkout's
``build/cometbft_tpu_torch/``.

:func:`bundle_version` hashes what the repo feeds a build: the
``csrc/`` sources, the Python modules the constants headers are
generated from (``ops/fe.py``, ``group.py``, ``ed25519.py``,
``scalar.py``, ``sha512.py``, ``sha256.py``, ``blsg1.py``, ``_build.py``
and ``crypto/_ed25519_py.py``), ``blsg1.FOLD_ROWS`` (which a build may
set first) and ``FLAGS``.  Hashing those sources, not the headers they
generate, keeps header generation (1.5 s of big-integer tables) off a
warm start: headers are generated only when a build runs.  The
fingerprint adds the compiler's version and the card's capability.

:func:`load` checks the manifest before any ``ctypes.CDLL``: ``absent``
(no manifest), ``corrupt`` (the manifest or a library does not load),
``stale`` (another version or fingerprint, another compiler, another
card's capability), else ``loaded``, with every kernel's entry bound.
``crypto_compile_bundle_stale_total{reason}`` counts ``corrupt``,
``version`` (the version, the fingerprint or the compiler) and
``capability``; ``crypto_compile_bundle_info`` is the bound kernel count,
labelled by version and status.  A bundle that is not ``loaded`` is
rebuilt from the sources in place, at first use (:func:`ensure`, which
``ops/_build.py:load`` calls) or by :func:`build`; nothing falls back to
the host, and a failed build raises.  Processes share a bundle through a
file lock: a build runs once, and a process that waited for it loads
it.  Without ``nvcc`` (a machine that only runs prebuilt kernels) the
compiler is not compared.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import functools
import hashlib
import json
import os
import subprocess
import threading
import time
from pathlib import Path

from ..ops import _build

__all__ = ["bundle_version", "default_path", "configure", "build", "load",
           "ensure", "info", "lookup", "reset", "set_info", "fingerprint",
           "GENERATORS"]

_MAGIC = "cmt-cuda-bundle"
_FORMAT = 1
_PKG = Path(__file__).resolve().parent.parent
DEFAULT_DIR = _build.ROOT / "build" / "cometbft_tpu_torch"
# the Python sources the generated headers come from
GENERATORS = ("ops/fe.py", "ops/group.py", "ops/ed25519.py",
              "ops/scalar.py", "ops/sha512.py", "ops/sha256.py",
              "ops/blsg1.py", "ops/_build.py", "crypto/_ed25519_py.py")

_DIR: list = [None]                  # compile_bundle_dir, None: default
_INFO: dict = {"status": "absent"}
_LOCK = threading.RLock()


@functools.cache
def _metrics():
    from ..libs import metrics as m

    return (
        m.gauge("crypto_compile_bundle_info",
                "kernel bundle state: value = kernels bound from it, "
                "labelled by bundle version and load status"),
        m.counter("crypto_compile_bundle_stale_total",
                  "kernel bundles ignored and rebuilt, by reason"),
    )


def _log():
    from ..libs import log as tmlog

    return tmlog.logger("aotbundle")


# -------------------------------------------------------------- identity


def bundle_version() -> str:
    """The hash of what the repo feeds a build (the module docstring);
    reads about a dozen files and generates nothing."""
    from ..ops import blsg1

    h = hashlib.sha256(f"{_MAGIC}|{_FORMAT}|{' '.join(_build.FLAGS)}|"
                       f"FOLD_ROWS={blsg1.FOLD_ROWS}".encode())
    for f in sorted(_build.CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    for rel in GENERATORS:
        h.update(rel.encode())
        h.update((_PKG / rel).read_bytes())
    return h.hexdigest()[:16]


def fingerprint(version: str, compiler: str, capability: str) -> str:
    """The version with the compiler's line and the card's capability."""
    return hashlib.sha256(
        f"{version}|{compiler}|{capability}".encode()).hexdigest()[:16]


@functools.cache
def _compiler() -> str | None:
    """``nvcc --version``'s last line, or None without ``nvcc``."""
    try:
        nvcc = _build._nvcc()
    except RuntimeError:
        return None
    out = subprocess.run([nvcc, "--version"], capture_output=True,
                         text=True, check=True).stdout
    return out.strip().splitlines()[-1]


def _capability(device=None) -> str:
    """The compute capability of ``device`` (default: the current card),
    as ``major.minor``; raises without a card."""
    import torch

    major, minor = torch.cuda.get_device_capability(device)
    return f"{major}.{minor}"


def configure(dir_: str | None = None) -> None:
    """Keep bundles under ``dir_`` (``compile_bundle_dir``; None or ""
    for the default).  Process-wide; kernels already bound stay bound."""
    _DIR[0] = dir_ or None


def default_path(dir_: str | None = None) -> str:
    """``<dir>/bundle-<version>``: one directory a version, so a source
    edit builds beside the old bundle instead of over it."""
    base = Path(dir_ or _DIR[0] or DEFAULT_DIR)
    return str(base / f"bundle-{bundle_version()}")


# ------------------------------------------------------------ build/load


def _libraries() -> dict:
    """Library file -> source, one a source of ``KERNELS``."""
    return {f"lib{_build._lib_name(s)}.so": s for s in _build._sources()}


def _check(path: Path, device=None) -> tuple:
    """``(status, reason, manifest)`` of the bundle at ``path``, from its
    manifest and its libraries' sizes alone (no library is opened)."""
    man = path / "manifest.json"
    if not man.exists():
        return "absent", None, None
    try:
        doc = json.loads(man.read_text())
        libs = doc["libraries"]
        kernels = doc["kernels"]
        want = (doc["magic"], doc["format"], doc["version"])
        fp, compiler, cap = (doc["fingerprint"], doc["compiler"],
                             doc["capability"])
    except (OSError, ValueError, KeyError, TypeError):
        return "corrupt", "corrupt", None
    if want != (_MAGIC, _FORMAT, bundle_version()) or \
            fp != fingerprint(doc["version"], compiler, cap):
        return "stale", "version", doc
    if cap != _capability(device):
        return "stale", "capability", doc
    local = _compiler()
    if local is not None and local != compiler:
        return "stale", "version", doc
    if set(libs) != set(_libraries()) or set(kernels) != set(_build.KERNELS):
        return "corrupt", "corrupt", doc
    for name, size in libs.items():
        f = path / name
        if not f.exists() or f.stat().st_size != size:
            return "corrupt", "corrupt", doc
    return "loaded", None, doc


def _bind(path: Path) -> None:
    """Open the bundle's libraries and bind every kernel's entry
    (``ops/_build.py:_LIBS``); raises ``OSError``/``AttributeError`` for a
    library that does not load or lacks an entry."""
    libs = {s: ctypes.CDLL(str(path / lib))
            for lib, s in _libraries().items()}
    bound = {}
    for k, (src, entry, argtypes) in _build.KERNELS.items():
        f = getattr(libs[src], entry)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
        bound[k] = f
    _build._LIBS.update(bound)


def _record(status: str, path: Path, doc=None, **extra) -> dict:
    info_ = {"status": status, "version": bundle_version(), "path": str(path),
             "kernels": len(_build._LIBS) if status in ("loaded", "built")
             else 0}
    if doc:
        info_.update({k: doc.get(k) for k in (
            "fingerprint", "compiler", "capability", "torch_cuda")})
    info_.update(extra)
    return set_info(info_)


def load(path: str | None = None, device=None) -> dict:
    """Load the bundle at ``path`` (default :func:`default_path`) for
    ``device``'s capability (default: the current card): the manifest is
    checked before any library is opened, then every kernel bound.
    Returns the info dict ``/status`` serves (``status`` one of
    ``absent``, ``corrupt``, ``stale``, ``loaded``; ``load_s``)."""
    path = Path(path or default_path())
    t0 = time.perf_counter()
    with _LOCK:
        status, reason, doc = _check(path, device)
        if status == "loaded":
            try:
                _bind(path)
            except (OSError, AttributeError) as e:
                status, reason = "corrupt", "corrupt"
                _log().warn("kernel bundle library does not load",
                            path=str(path), err=repr(e))
        if reason is not None:
            _metrics()[1].inc(reason=reason)
            _log().warn("kernel bundle ignored; it is rebuilt at first use",
                        path=str(path), status=status, reason=reason)
        return _record(status, path, doc, reason=reason,
                       load_s=time.perf_counter() - t0)


def build(path: str | None = None, device=None) -> dict:
    """Build every kernel from the sources into ``path`` (default
    :func:`default_path`), write the manifest last, and bind the kernels.
    Raises if ``nvcc`` fails (the info's status is then
    ``build_failed``)."""
    path = Path(path or default_path())
    with _LOCK, _locked(path):
        return _build_locked(path, device)


@contextlib.contextmanager
def _locked(path: Path):
    """The bundle's file lock, which a build holds."""
    path.mkdir(parents=True, exist_ok=True)
    with open(path / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        yield


def _build_locked(path: Path, device) -> dict:
    import torch

    t0 = time.perf_counter()
    man = path / "manifest.json"
    if man.exists():
        man.unlink()
    try:
        _build._build_all(path)
    except Exception as e:
        _record("build_failed", path, error=repr(e),
                build_s=time.perf_counter() - t0)
        raise
    version = bundle_version()
    compiler = _compiler() or "unknown"
    cap = _capability(device)
    doc = {"magic": _MAGIC, "format": _FORMAT, "version": version,
           "fingerprint": fingerprint(version, compiler, cap),
           "compiler": compiler, "capability": cap,
           "torch_cuda": torch.version.cuda,
           "kernels": {k: {"library": f"lib{_build._lib_name(s)}.so",
                           "entry": e}
                       for k, (s, e, _) in _build.KERNELS.items()},
           "libraries": {lib: (path / lib).stat().st_size
                         for lib in _libraries()},
           "build_s": time.perf_counter() - t0}
    tmp = path / "manifest.json.tmp"
    tmp.write_text(json.dumps(doc, indent=1))
    os.replace(tmp, man)
    _bind(path)
    _log().info("kernel bundle built", path=str(path),
                secs=round(doc["build_s"], 2))
    return _record("built", path, doc, build_s=doc["build_s"])


def ensure(device=None) -> None:
    """Bind every kernel, at first use: from the bundle where it loads,
    else built in place (waiting for another process's build through the
    bundle's lock, and loading what it built).  Raises if the build
    fails."""
    with _LOCK:
        if len(_build._LIBS) == len(_build.KERNELS):
            return
        path = Path(default_path())
        checked = _INFO.get("path") == str(path) and \
            _INFO.get("status") in ("absent", "corrupt", "stale")
        if not checked and load(str(path), device)["status"] == "loaded":
            return
        with _locked(path):
            status, _, doc = _check(path, device)
            if status == "loaded":
                try:
                    _bind(path)
                    _record("loaded", path, doc)
                    return
                except (OSError, AttributeError):
                    pass
            _build_locked(path, device)


def set_info(info_: dict) -> dict:
    """Record ``info_`` as the bundle state (what ``/status`` serves; a
    node records ``skipped_no_device``, ``disabled`` or ``error`` here
    too) and set the gauge."""
    global _INFO
    _INFO = info_
    _metrics()[0].set(info_.get("kernels", 0),
                      version=str(info_.get("version")),
                      status=str(info_.get("status")))
    return info_


def info() -> dict:
    """The current bundle state (the ``/status`` ``compile_bundle``)."""
    return _INFO


def lookup(name: str):
    """The bound C entry of kernel ``name``, or None before the bundle
    is loaded or built."""
    return _build._LIBS.get(name)


def reset() -> None:
    """Test hook: unbind the kernels (the libraries stay mapped) and
    forget the state."""
    global _INFO
    _build._LIBS.clear()
    _INFO = {"status": "absent"}
