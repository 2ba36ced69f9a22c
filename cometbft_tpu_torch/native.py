"""Host C++ libraries of the port, built with the host ``g++`` at first use.

Six libraries, each a copy of part of the JAX package's native code:

- ``csrc/host/bls12381.cpp`` (with ``sha256_inline.h``): BLS12-381 key
  derivation, signing, decompression and subgroup checks, hash-to-G2
  and the pairings;
- ``csrc/host/vote_sign_bytes.cpp``: the canonical vote sign bytes of a
  commit's lanes in one call (:func:`build_vote_sign_bytes`), the rows
  the dense commit rules hand to the Ed25519 kernels;
- ``csrc/host/ed25519_sign.cpp``: Ed25519 key generation and signing
  (:func:`ed25519_pubkey`, :func:`ed25519_sign`), the signing half of
  ``cometbft_tpu/native/ed25519.cpp``; its verifiers stay out, since the
  port verifies on the card;
- ``csrc/host/aead.cpp``: ChaCha20-Poly1305 (:func:`aead_seal`,
  :func:`aead_open`) for the secret connection;
- ``csrc/host/secp256k1.cpp``: secp256k1 ECDSA verification
  (:func:`secp256k1_verify`, :func:`secp256k1_verify_lanes`; no TPU
  kernel computes secp256k1, and the JAX package verifies these lanes on
  its host with the same C++), key derivation and RFC 6979 signing
  (:func:`secp256k1_pubkey`, :func:`secp256k1_sign`) and RIPEMD-160
  (:func:`ripemd160`, for addresses: ``hashlib`` has it only where its
  OpenSSL build does);
- ``csrc/host/kvstore.cpp``: the native KV store
  (``storage/nativedb.py``) and the RFC-6962 trees
  (:func:`merkle_root`, :func:`merkle_levels`).

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
import os
import platform
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

__all__ = ["NativeBuildError", "BUILD_SECONDS", "lib_path", "load",
           "build_vote_sign_bytes", "ed25519_pubkey", "ed25519_sign",
           "aead_seal", "aead_open", "secp256k1_verify",
           "secp256k1_verify_lanes", "secp256k1_pubkey", "secp256k1_sign",
           "ripemd160", "merkle_root", "merkle_levels"]

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


_SECP: list = []


def _secp():
    with _LOAD_LOCK:
        if not _SECP:
            lib = load("secp256k1")
            lib.secp256k1_verify.argtypes = [ctypes.c_char_p,
                                             ctypes.c_char_p,
                                             ctypes.c_char_p,
                                             ctypes.c_uint64]
            lib.secp256k1_verify.restype = ctypes.c_int
            lib.secp256k1_verify_batch.argtypes = [
                ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p, _U64P,
                ctypes.c_uint64, _U8P]
            lib.secp256k1_verify_batch.restype = ctypes.c_uint64
            lib.secp256k1_pubkey.argtypes = [ctypes.c_char_p,
                                             ctypes.c_char_p]
            lib.secp256k1_pubkey.restype = ctypes.c_int
            lib.secp256k1_sign.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                           ctypes.c_uint64, ctypes.c_char_p]
            lib.secp256k1_sign.restype = ctypes.c_int
            lib.ripemd160.argtypes = [ctypes.c_char_p, ctypes.c_uint64,
                                      ctypes.c_char_p]
            lib.ripemd160.restype = None
            _SECP.append(lib)
        return _SECP[0]


def secp256k1_verify(pub: bytes, msg: bytes, sig: bytes) -> bool:
    """ECDSA over SHA-256(``msg``) against a 33-byte compressed key, a
    64-byte big-endian r || s with 1 <= r, s < n and s <= n/2 (the JAX
    package's ``native/secp256k1.cpp:953``).  A key or signature of
    another length is False.  A library that does not build raises
    :class:`NativeBuildError`."""
    pub, msg, sig = bytes(pub), bytes(msg), bytes(sig)
    if len(pub) != 33 or len(sig) != 64:
        return False
    return bool(_secp().secp256k1_verify(pub, sig, msg, len(msg)))


SECP_CHUNK = 64                  # lanes a host thread verifies at a time
_SECP_POOL: list = []


def _secp_pool() -> ThreadPoolExecutor:
    with _LOAD_LOCK:
        if not _SECP_POOL:
            _SECP_POOL.append(ThreadPoolExecutor(
                max_workers=min(8, os.cpu_count() or 1),
                thread_name_prefix="secp256k1"))
        return _SECP_POOL[0]


def _secp_chunk(lib, pubs, sigs, msgs, offs, lo, hi):
    out = np.zeros((hi - lo,), np.uint8)
    o = np.ascontiguousarray(offs[lo:hi + 1] - offs[lo])
    lib.secp256k1_verify_batch(pubs[33 * lo:33 * hi], sigs[64 * lo:64 * hi],
                               msgs[int(offs[lo]):int(offs[hi])],
                               o.ctypes.data_as(_U64P), hi - lo,
                               out.ctypes.data_as(_U8P))
    return out


class SecpLanes:
    """Verdicts of :func:`secp256k1_verify_lanes`, computed on host
    threads while the caller goes on; :meth:`result` waits for them."""

    def __init__(self, n: int, futures):
        self._n, self._futures = n, futures

    def result(self) -> np.ndarray:
        out = np.zeros((self._n,), bool)
        for idx, fut in self._futures:
            out[idx] = fut.result().astype(bool)
        return out


def secp256k1_verify_lanes(items) -> SecpLanes:
    """Start verifying ``(pub, msg, sig)`` lanes (bytes) in one C call a
    chunk of :data:`SECP_CHUNK` lanes, the chunks spread over up to eight
    host threads (each call releases the GIL).  A lane whose key or
    signature has another length is False without a call.  Returns a
    :class:`SecpLanes`; its ``result()`` is the (n,) bool verdicts.  A
    library that does not build raises :class:`NativeBuildError` here."""
    lib = _secp()
    items = [(bytes(p), bytes(m), bytes(s)) for p, m, s in items]
    good = [i for i, (p, _, s) in enumerate(items)
            if len(p) == 33 and len(s) == 64]
    futures = []
    if good:
        pubs = b"".join(items[i][0] for i in good)
        sigs = b"".join(items[i][2] for i in good)
        msgs = b"".join(items[i][1] for i in good)
        offs = np.zeros((len(good) + 1,), np.uint64)
        np.cumsum(np.fromiter((len(items[i][1]) for i in good), np.uint64,
                              len(good)), out=offs[1:])
        pool = _secp_pool()
        idx = np.asarray(good, np.int64)
        for lo in range(0, len(good), SECP_CHUNK):
            hi = min(lo + SECP_CHUNK, len(good))
            futures.append((idx[lo:hi], pool.submit(
                _secp_chunk, lib, pubs, sigs, msgs, offs, lo, hi)))
    return SecpLanes(len(items), futures)


def _secret(d: bytes) -> bytes:
    d = bytes(d)
    if len(d) != 32:
        raise ValueError("secp256k1 secret must be 32 bytes")
    return d


def secp256k1_pubkey(d: bytes) -> bytes:
    """The 33-byte compressed public key of the 32-byte big-endian
    scalar ``d``; ValueError unless 1 <= d < n.  A library that does not
    build raises :class:`NativeBuildError`."""
    out = ctypes.create_string_buffer(33)
    if not _secp().secp256k1_pubkey(_secret(d), out):
        raise ValueError("secp256k1 scalar out of range")
    return out.raw


def secp256k1_sign(d: bytes, msg: bytes) -> bytes:
    """The 64-byte r || s of ``msg`` under the scalar ``d``: SHA-256 of
    the message, the RFC 6979 nonce, S in the low half (byte for byte
    ``cometbft_tpu/crypto/_secp256k1_py.py:sign``); ValueError unless
    1 <= d < n.  A library that does not build raises
    :class:`NativeBuildError`."""
    msg = bytes(msg)
    out = ctypes.create_string_buffer(64)
    if not _secp().secp256k1_sign(_secret(d), msg, len(msg), out):
        raise ValueError("secp256k1 scalar out of range")
    return out.raw


def ripemd160(data: bytes) -> bytes:
    """RIPEMD-160 of ``data`` (20 bytes).  A library that does not build
    raises :class:`NativeBuildError`."""
    data = bytes(data)
    out = ctypes.create_string_buffer(20)
    _secp().ripemd160(data, len(data), out)
    return out.raw


_KV: list = []


def _kv():
    with _LOAD_LOCK:
        if not _KV:
            lib = load("kvstore")
            lib.kv_merkle_root.argtypes = [ctypes.c_char_p, _U64P,
                                           ctypes.c_uint64, ctypes.c_char_p]
            lib.kv_merkle_root.restype = None
            lib.kv_merkle_levels.argtypes = [ctypes.c_char_p, _U64P,
                                             ctypes.c_uint64,
                                             ctypes.c_char_p]
            lib.kv_merkle_levels.restype = ctypes.c_uint64
            _KV.append(lib)
        return _KV[0]


def _leaf_args(items):
    """The leaves concatenated and their (n + 1,) prefix offsets."""
    buf = b"".join(items)
    offs = np.zeros((len(items) + 1,), np.uint64)
    np.cumsum(np.fromiter(map(len, items), np.uint64, len(items)),
              out=offs[1:])
    return buf, offs


def merkle_root(items: list) -> bytes:
    """RFC-6962 root of ``items`` (``kv_merkle_root``; the empty tree is
    SHA-256 of nothing).  A library that does not build raises
    :class:`NativeBuildError`."""
    buf, offs = _leaf_args(items)
    out = ctypes.create_string_buffer(32)
    _kv().kv_merkle_root(buf, offs.ctypes.data_as(_U64P), len(items), out)
    return out.raw


def merkle_levels(items: list) -> list:
    """Every level of the level-order tree of ``items`` in one call
    (``kv_merkle_levels``): lists of 32-byte nodes, leaf hashes first,
    the root last; ``[]`` for no items.  A library that does not build
    raises :class:`NativeBuildError`."""
    n = len(items)
    widths = [n] if n else []
    while widths and widths[-1] > 1:
        widths.append((widths[-1] + 1) // 2)
    buf, offs = _leaf_args(items)
    out = ctypes.create_string_buffer(32 * max(1, sum(widths)))
    wrote = _kv().kv_merkle_levels(buf, offs.ctypes.data_as(_U64P), n, out)
    if wrote != sum(widths):
        raise RuntimeError(f"kv_merkle_levels wrote {wrote} nodes, "
                           f"want {sum(widths)}")
    raw = out.raw
    levels, pos = [], 0
    for w in widths:
        levels.append([raw[i:i + 32] for i in range(pos, pos + 32 * w, 32)])
        pos += 32 * w
    return levels
