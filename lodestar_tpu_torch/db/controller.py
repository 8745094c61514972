"""KvController — the DatabaseController surface over the native store,
the port's copy of `lodestar_tpu/db/controller.py`.

Reference: packages/db/src/controller/level.ts (get/put/delete/batch +
keys/values/entries range scans with gt/lt bounds).  The engine is the
port's copy of the JAX package's ordered map + write-ahead log,
`lodestar_tpu_torch/native/kvstore.cpp`, compiled with the host C++
compiler at the first durable open (`kernels/build.py build_native`, into
`lodestar_tpu_torch/_build/`).  The modes are the reference's: `path=None`
is the explicit in-memory store (a dict, no durability); a durable path
whose library cannot be built raises, it never falls back to memory.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Iterator, List, Optional, Tuple

_lib: Optional[ctypes.CDLL] = None
_LIB_LOCK = threading.Lock()


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.kv_open.argtypes = [ctypes.c_char_p]
    lib.kv_open.restype = ctypes.c_void_p
    lib.kv_put.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                           ctypes.c_uint32, ctypes.c_char_p,
                           ctypes.c_uint32]
    lib.kv_put.restype = ctypes.c_int
    lib.kv_del.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                           ctypes.c_uint32]
    lib.kv_del.restype = ctypes.c_int
    lib.kv_get.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                           ctypes.c_uint32, ctypes.c_char_p,
                           ctypes.c_uint32]
    lib.kv_get.restype = ctypes.c_int64
    lib.kv_count.argtypes = [ctypes.c_void_p]
    lib.kv_count.restype = ctypes.c_uint64
    lib.kv_flush.argtypes = [ctypes.c_void_p]
    lib.kv_compact.argtypes = [ctypes.c_void_p]
    lib.kv_compact.restype = ctypes.c_int
    lib.kv_close.argtypes = [ctypes.c_void_p]
    lib.kv_iter_new.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                ctypes.c_uint32, ctypes.c_char_p,
                                ctypes.c_uint32]
    lib.kv_iter_new.restype = ctypes.c_void_p
    lib.kv_iter_next.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint32,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_char_p,
        ctypes.c_uint32, ctypes.POINTER(ctypes.c_int64),
    ]
    lib.kv_iter_next.restype = ctypes.c_int
    lib.kv_iter_free.argtypes = [ctypes.c_void_p]
    return lib


def _native() -> ctypes.CDLL:
    """The engine's library, built and loaded on the first call; raises
    OSError where it cannot be built or loaded."""
    global _lib
    with _LIB_LOCK:
        if _lib is None:
            from ..kernels import build as B

            try:
                _lib = _bind(ctypes.CDLL(str(B.build_native("kvstore"))))
            except RuntimeError as e:
                raise OSError(f"the KV store's library cannot be built: {e}") from e
        return _lib


def native_available() -> bool:
    """True where the engine's library builds and loads."""
    try:
        _native()
    except OSError:
        return False
    return True


class KvController:
    """Ordered byte KV with range scans (the LevelDbController analog)."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._mem = None
        self._h = None
        if path is not None:
            self._h = _native().kv_open(path.encode())
            if not self._h:
                raise OSError(f"kv_open failed for {path}")
        else:
            self._mem = {}

    # -- point ops ---------------------------------------------------------

    def put(self, key: bytes, value: bytes) -> None:
        if self._h:
            if _lib.kv_put(self._h, key, len(key), value, len(value)) != 0:
                raise OSError("kv_put failed")
        else:
            self._mem[bytes(key)] = bytes(value)

    def get(self, key: bytes) -> Optional[bytes]:
        if self._h:
            n = _lib.kv_get(self._h, key, len(key), None, 0)
            if n < 0:
                return None
            buf = ctypes.create_string_buffer(int(n))
            _lib.kv_get(self._h, key, len(key), buf, int(n))
            return buf.raw
        return self._mem.get(bytes(key))

    def delete(self, key: bytes) -> None:
        if self._h:
            _lib.kv_del(self._h, key, len(key))
        else:
            self._mem.pop(bytes(key), None)

    def batch_put(self, items: List[Tuple[bytes, bytes]]) -> None:
        for k, v in items:
            self.put(k, v)

    def __len__(self) -> int:
        if self._h:
            return int(_lib.kv_count(self._h))
        return len(self._mem)

    # -- range scans (reference: level.ts keys/values/entries) -------------

    def entries(
        self, gte: bytes = b"", lt: bytes = b""
    ) -> Iterator[Tuple[bytes, bytes]]:
        if self._h:
            it = _lib.kv_iter_new(self._h, gte, len(gte), lt, len(lt))
            kcap, vcap = 256, 1 << 16
            try:
                while True:
                    kb = ctypes.create_string_buffer(kcap)
                    vb = ctypes.create_string_buffer(vcap)
                    klen = ctypes.c_int64()
                    vlen = ctypes.c_int64()
                    rc = _lib.kv_iter_next(it, kb, kcap, ctypes.byref(klen),
                                           vb, vcap, ctypes.byref(vlen))
                    if rc == 0:
                        return
                    if rc < 0:  # grow buffers and retry this entry
                        kcap = max(kcap, int(klen.value))
                        vcap = max(vcap, int(vlen.value))
                        continue
                    yield kb.raw[: klen.value], vb.raw[: vlen.value]
            finally:
                _lib.kv_iter_free(it)
        else:
            for k in sorted(self._mem):
                if gte and k < gte:
                    continue
                if lt and k >= lt:
                    break
                yield k, self._mem[k]

    def keys(self, gte: bytes = b"", lt: bytes = b"") -> Iterator[bytes]:
        for k, _v in self.entries(gte, lt):
            yield k

    def values(self, gte: bytes = b"", lt: bytes = b"") -> Iterator[bytes]:
        for _k, v in self.entries(gte, lt):
            yield v

    # -- lifecycle ---------------------------------------------------------

    def flush(self) -> None:
        if self._h:
            _lib.kv_flush(self._h)

    def compact(self) -> None:
        if self._h:
            _lib.kv_compact(self._h)

    def close(self) -> None:
        if self._h:
            _lib.kv_close(self._h)
            self._h = None
