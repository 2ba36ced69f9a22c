"""NativeDB: the C++ embedded KV engine behind the ``KVStore``
interface (counterpart of ``cometbft_tpu/storage/nativedb.py``; the
engine is ``csrc/host/kvstore.cpp``, a copy of the JAX package's
``native/kvstore.cpp``, built with ``g++`` at first use by ``native.py``;
a failed build raises ``native.NativeBuildError``).

Same on-disk record format as ``LogDB``, so the two backends, and the two
packages, read each other's files; the native engine owns the index, the
log, the fsync of every write and compaction, and Python talks to it
over a ctypes C ABI."""

from __future__ import annotations

import ctypes
import os
import struct
import threading

from .. import native as _native
from .db import KVStore

__all__ = ["NativeDB", "NativeDBError"]

_TOMBSTONE = 0xFFFFFFFF
_U32 = struct.Struct("<I")
_U8PP = ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8))
_LIB: list = []
_LOCK = threading.Lock()


def _load():
    with _LOCK:
        if _LIB:
            return _LIB[0]
        lib = _native.load("kvstore")
        lib.kv_open.restype = ctypes.c_void_p
        lib.kv_open.argtypes = [ctypes.c_char_p]
        lib.kv_close.argtypes = [ctypes.c_void_p]
        lib.kv_get.restype = ctypes.c_int
        lib.kv_get.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                               ctypes.c_uint32, _U8PP,
                               ctypes.POINTER(ctypes.c_uint32)]
        lib.kv_free.argtypes = [ctypes.POINTER(ctypes.c_uint8)]
        lib.kv_set.restype = ctypes.c_int
        lib.kv_set.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                               ctypes.c_uint32, ctypes.c_char_p,
                               ctypes.c_uint32]
        lib.kv_delete.restype = ctypes.c_int
        lib.kv_delete.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                  ctypes.c_uint32]
        lib.kv_batch.restype = ctypes.c_int
        lib.kv_batch.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                 ctypes.c_uint64]
        lib.kv_iter_new.restype = ctypes.c_void_p
        lib.kv_iter_new.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                    ctypes.c_uint32, ctypes.c_char_p,
                                    ctypes.c_uint32]
        lib.kv_iter_next.restype = ctypes.c_int
        lib.kv_iter_next.argtypes = [ctypes.c_void_p, _U8PP,
                                     ctypes.POINTER(ctypes.c_uint32), _U8PP,
                                     ctypes.POINTER(ctypes.c_uint32)]
        lib.kv_iter_free.argtypes = [ctypes.c_void_p]
        lib.kv_size.restype = ctypes.c_uint64
        lib.kv_size.argtypes = [ctypes.c_void_p]
        _LIB.append(lib)
        return lib


def _take(lib, ptr, ln) -> bytes:
    try:
        return ctypes.string_at(ptr, ln)
    finally:
        lib.kv_free(ptr)


class NativeDBError(Exception):
    pass


class NativeDB(KVStore):
    """A store over one native engine handle; any call after
    :meth:`close` raises :class:`NativeDBError` (the engine would be
    handed a freed handle)."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._lib = _load()
        self._h = self._lib.kv_open(path.encode())
        if not self._h:
            raise NativeDBError(f"cannot open native kv store at {path}")

    def _handle(self):
        if not self._h:
            raise NativeDBError("native kv store is closed")
        return self._h

    def get(self, key: bytes) -> bytes | None:
        val = ctypes.POINTER(ctypes.c_uint8)()
        vlen = ctypes.c_uint32()
        if self._lib.kv_get(self._handle(), key, len(key),
                            ctypes.byref(val), ctypes.byref(vlen)) == 0:
            return None
        return _take(self._lib, val, vlen.value)

    def set(self, key: bytes, value: bytes) -> None:
        if self._lib.kv_set(self._handle(), key, len(key), value,
                            len(value)) != 0:
            raise NativeDBError("set failed")

    def delete(self, key: bytes) -> None:
        if self._lib.kv_delete(self._handle(), key, len(key)) != 0:
            raise NativeDBError("delete failed")

    def set_batch(self, items: dict[bytes, bytes | None]) -> None:
        parts = []
        for k, v in items.items():
            vlen = _TOMBSTONE if v is None else len(v)
            parts.append(_U32.pack(len(k)) + _U32.pack(vlen) + k
                         + (v or b""))
        wire = b"".join(parts)
        if self._lib.kv_batch(self._handle(), wire, len(wire)) != 0:
            raise NativeDBError("batch failed")

    def iterate(self, start: bytes = b"", end: bytes | None = None):
        it = self._lib.kv_iter_new(self._handle(), start, len(start),
                                   end or b"", len(end or b""))
        try:
            while True:
                kp = ctypes.POINTER(ctypes.c_uint8)()
                vp = ctypes.POINTER(ctypes.c_uint8)()
                kl = ctypes.c_uint32()
                vl = ctypes.c_uint32()
                if self._lib.kv_iter_next(it, ctypes.byref(kp),
                                          ctypes.byref(kl),
                                          ctypes.byref(vp),
                                          ctypes.byref(vl)) == 0:
                    return
                yield (_take(self._lib, kp, kl.value),
                       _take(self._lib, vp, vl.value))
        finally:
            self._lib.kv_iter_free(it)

    def size(self) -> int:
        return int(self._lib.kv_size(self._handle()))

    def close(self) -> None:
        if self._h:
            self._lib.kv_close(self._h)
            self._h = None
