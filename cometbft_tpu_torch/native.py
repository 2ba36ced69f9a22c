"""Host C++ libraries of the port, built with the host ``g++`` at first use.

Four libraries, each a copy of part of the JAX package's native code:

- ``csrc/host/bls12381.cpp`` (with ``sha256_inline.h``): BLS12-381 key
  derivation, signing, decompression and subgroup checks, hash-to-G2
  and the pairings;
- ``csrc/host/vote_sign_bytes.cpp``: the canonical vote sign bytes of a
  commit's lanes in one call (:func:`build_vote_sign_bytes`), the rows
  the dense commit rules hand to the Ed25519 kernels;
- ``csrc/host/ed25519_sign.cpp``: Ed25519 key generation and signing
  (:func:`ed25519_pubkey`, :func:`ed25519_sign`), the signing half of
  ``cometbft_tpu/native/ed25519.cpp``; its verifiers stay out, since the
  port verifies on the card.

Each builds with ``g++ -O3 -march=native`` (retried without
``-march=native`` for toolchains that refuse it) into
``build/cometbft_tpu_torch/<hash>/`` under the checkout, keyed by a hash
of the sources, the flags and the host CPU's identity, under a file
lock, so concurrent processes build once and an edited source rebuilds.
The build happens at the first :func:`load`, never at import; a failed
build raises :class:`NativeBuildError` with the compiler's output, and
there is no substitute.  :data:`BUILD_SECONDS` records each library's
build time in this process (0.0 when an earlier build was loaded).
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import platform
import subprocess
import threading
import time
from pathlib import Path

import numpy as np

__all__ = ["NativeBuildError", "BUILD_SECONDS", "lib_path", "load",
           "build_vote_sign_bytes", "ed25519_pubkey", "ed25519_sign",
           "aead_seal", "aead_open"]

HOST_SRC = Path(__file__).resolve().parent / "csrc" / "host"
ROOT = Path(__file__).resolve().parents[1]
FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]

BUILD_SECONDS: dict = {}
_LIBS: dict = {}
_LOAD_LOCK = threading.RLock()     # threads load a library once


class NativeBuildError(RuntimeError):
    pass


def _host_id() -> str:
    """The CPU's identity: a ``-march=native`` build is never reused on a
    host with another instruction set."""
    flags = ""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    flags = line
                    break
    except OSError:
        pass
    return platform.machine() + flags


def lib_path(name: str) -> Path:
    """Path of library ``name`` (``csrc/host/<name>.cpp``), built first if
    the sources, flags or host changed."""
    src = HOST_SRC / f"{name}.cpp"
    h = hashlib.sha256()
    h.update(" ".join(FLAGS).encode())
    h.update(_host_id().encode())
    for f in [src] + sorted(HOST_SRC.glob("*.h")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    out_dir = ROOT / "build" / "cometbft_tpu_torch" / h.hexdigest()[:16]
    out = out_dir / f"lib{name}_host.so"
    if out.exists():
        BUILD_SECONDS.setdefault(name, 0.0)
        return out
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not out.exists():               # another process may have built
            t0 = time.perf_counter()
            tmp = out.with_suffix(".so.tmp")
            base = ["g++", *FLAGS, str(src), "-o", str(tmp)]
            for cmd in (["g++", "-march=native", *base[1:]], base):
                proc = subprocess.run(cmd, capture_output=True, text=True)
                if proc.returncode == 0:
                    break
            else:
                raise NativeBuildError(
                    f"g++ failed for {src.name}: {' '.join(base)}\n"
                    f"{proc.stderr}")
            tmp.replace(out)
            BUILD_SECONDS[name] = time.perf_counter() - t0
        else:
            BUILD_SECONDS.setdefault(name, 0.0)
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built on first use in a process."""
    with _LOAD_LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(lib_path(name)))
            _LIBS[name] = lib
        return lib


_VSB: list = []
_U8P = ctypes.POINTER(ctypes.c_uint8)
_U64P = ctypes.POINTER(ctypes.c_uint64)
_I64P = ctypes.POINTER(ctypes.c_int64)


def _vsb():
    with _LOAD_LOCK:
        if not _VSB:
            fn = load("vote_sign_bytes").build_vote_sign_bytes
            fn.argtypes = [ctypes.c_char_p, ctypes.c_uint64,
                           ctypes.c_char_p, ctypes.c_uint64,
                           ctypes.c_char_p, ctypes.c_uint64, _I64P, _U8P,
                           ctypes.c_uint64, _U8P, ctypes.c_uint64, _U64P]
            fn.restype = ctypes.c_uint64
            _VSB.append(fn)
        return _VSB[0]


def build_vote_sign_bytes(pre_commit: bytes, pre_nil: bytes, post: bytes,
                          ts_ns, flags):
    """One commit's canonical vote sign bytes, a row per lane, in one C
    call (``cometbft_tpu/crypto/_native_ed25519.py:138``).  ``ts_ns``
    (n,) int64 timestamps, ``flags`` (n,) uint8 (2: the commit variant
    ``pre_commit``, else ``pre_nil``); ``post`` follows the timestamp.
    Returns ``(msgs uint8 (n, stride), lens int64 (n,))``, rows
    zero-padded to ``stride = 5 + max(len(pre)) + 19 + len(post)``.  A
    library that does not build raises :class:`NativeBuildError`."""
    fn = _vsb()
    ts64 = np.ascontiguousarray(ts_ns, np.int64)
    fl8 = np.ascontiguousarray(flags, np.uint8)
    n = ts64.shape[0]
    if fl8.shape != (n,):
        raise ValueError("ts_ns and flags differ in length")
    stride = 5 + max(len(pre_commit), len(pre_nil)) + 19 + len(post)
    out = np.zeros((n, stride), np.uint8)
    lens = np.zeros((n,), np.uint64)
    rc = fn(pre_commit, len(pre_commit), pre_nil, len(pre_nil), post,
            len(post), ts64.ctypes.data_as(_I64P),
            fl8.ctypes.data_as(_U8P), n, out.ctypes.data_as(_U8P), stride,
            lens.ctypes.data_as(_U64P))
    if rc != 0:
        raise RuntimeError(f"sign-bytes stride {stride} below the {rc} "
                           "bytes the encoder needs")
    return out, lens.astype(np.int64)


_SIGN: list = []


def _signer():
    with _LOAD_LOCK:
        if not _SIGN:
            lib = load("ed25519_sign")
            lib.ed25519_pubkey.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
            lib.ed25519_pubkey.restype = None
            lib.ed25519_sign.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                         ctypes.c_uint64, ctypes.c_char_p]
            lib.ed25519_sign.restype = None
            _SIGN.append(lib)
        return _SIGN[0]


def _seed(seed: bytes) -> bytes:
    seed = bytes(seed)
    if len(seed) != 32:
        raise ValueError("ed25519 seed must be 32 bytes")
    return seed


def ed25519_pubkey(seed: bytes) -> bytes:
    """The 32-byte public key of a 32-byte seed (RFC 8032 key
    generation).  A library that does not build raises
    :class:`NativeBuildError`."""
    out = ctypes.create_string_buffer(32)
    _signer().ed25519_pubkey(_seed(seed), out)
    return out.raw


def ed25519_sign(seed: bytes, msg: bytes) -> bytes:
    """The 64-byte RFC 8032 signature of ``msg`` under a 32-byte seed
    (deterministic: the same bytes as ``crypto/_ed25519_py.sign``).  A
    library that does not build raises :class:`NativeBuildError`."""
    msg = bytes(msg)
    out = ctypes.create_string_buffer(64)
    _signer().ed25519_sign(_seed(seed), msg, len(msg), out)
    return out.raw


_AEAD: list = []


def _aead():
    with _LOAD_LOCK:
        if not _AEAD:
            lib = load("aead")
            args = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
                    ctypes.c_uint64, ctypes.c_char_p, ctypes.c_uint64,
                    ctypes.c_char_p]
            lib.aead_seal.argtypes = args
            lib.aead_seal.restype = None
            lib.aead_open.argtypes = args
            lib.aead_open.restype = ctypes.c_int
            _AEAD.append(lib)
        return _AEAD[0]


def _key_nonce(key: bytes, nonce: bytes) -> tuple[bytes, bytes]:
    key, nonce = bytes(key), bytes(nonce)
    if len(key) != 32:
        raise ValueError("ChaCha20-Poly1305 key must be 32 bytes")
    if len(nonce) != 12:
        raise ValueError("ChaCha20-Poly1305 nonce must be 12 bytes")
    return key, nonce


def aead_seal(key: bytes, nonce: bytes, data: bytes, aad: bytes) -> bytes:
    """RFC 8439 seal: the ciphertext of ``data`` then its 16-byte tag over
    ``aad`` and the ciphertext.  A library that does not build raises
    :class:`NativeBuildError`."""
    key, nonce = _key_nonce(key, nonce)
    data, aad = bytes(data), bytes(aad)
    out = ctypes.create_string_buffer(len(data) + 16)
    _aead().aead_seal(key, nonce, aad, len(aad), data, len(data), out)
    return out.raw


def aead_open(key: bytes, nonce: bytes, data: bytes, aad: bytes):
    """RFC 8439 open of ``data`` (ciphertext then tag): the plaintext, or
    None when the tag does not match.  A library that does not build
    raises :class:`NativeBuildError`."""
    key, nonce = _key_nonce(key, nonce)
    data, aad = bytes(data), bytes(aad)
    if len(data) < 16:
        return None
    out = ctypes.create_string_buffer(max(1, len(data) - 16))
    if not _aead().aead_open(key, nonce, aad, len(aad), data, len(data),
                             out):
        return None
    return out.raw[:len(data) - 16]
