"""ctypes bindings for the native shard reader (`native/shard_reader.cpp`).

Own copy of `recbox_tpu/data/native_shards.py`, its symbols declared over
the port's build of the library (`retrieval/native.py`, ``build/native/``).

`NativeShardStream` hands `ShardLoader` decoded shard dicts from a C++
reader pool (N decoder threads + an ordered bounded ring), replacing the
Python-thread `np.load` producer on the hot path. Shards are delivered in
the exact order given, so epoch shuffling/seeding semantics are identical
to the numpy path — the backends are interchangeable bit-for-bit.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Iterator, Sequence

import numpy as np

__all__ = ["native_reader_available", "NativeShardStream"]

_DTYPES = {
    "<f4": np.float32, "<f8": np.float64, "<i4": np.int32, "<i8": np.int64,
    "<u4": np.uint32, "<u8": np.uint64, "|b1": np.bool_, "|u1": np.uint8,
    "|i1": np.int8, "<f2": np.float16, "<i2": np.int16, "<u2": np.uint16,
}

_DECLARED = False


def _lib():
    from recbox_tpu_torch.retrieval.native import load_native
    lib = load_native()
    if lib is None:
        return None
    global _DECLARED
    if not _DECLARED:
        lib.rb_shard_reader_open.restype = ctypes.c_void_p
        lib.rb_shard_reader_open.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.c_int]
        lib.rb_shard_reader_next.restype = ctypes.c_void_p
        lib.rb_shard_reader_next.argtypes = [ctypes.c_void_p]
        lib.rb_shard_reader_close.argtypes = [ctypes.c_void_p]
        lib.rb_shard_n_columns.restype = ctypes.c_int
        lib.rb_shard_n_columns.argtypes = [ctypes.c_void_p]
        lib.rb_shard_error.restype = ctypes.c_char_p
        lib.rb_shard_error.argtypes = [ctypes.c_void_p]
        lib.rb_shard_col_name.restype = ctypes.c_char_p
        lib.rb_shard_col_name.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.rb_shard_col_dtype.restype = ctypes.c_char_p
        lib.rb_shard_col_dtype.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.rb_shard_col_ndim.restype = ctypes.c_int
        lib.rb_shard_col_ndim.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.rb_shard_col_shape.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int64)]
        lib.rb_shard_col_data.restype = ctypes.c_void_p
        lib.rb_shard_col_data.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.rb_shard_col_nbytes.restype = ctypes.c_int64
        lib.rb_shard_col_nbytes.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.rb_shard_free.argtypes = [ctypes.c_void_p]
        _DECLARED = True
    return lib


def native_reader_available() -> bool:
    return _lib() is not None


class NativeShardStream:
    """Iterates decoded shard dicts in the given file order."""

    def __init__(self, paths: Sequence[str], prefetch: int = 2,
                 n_threads: int = 2):
        self._lib = _lib()
        if self._lib is None:
            raise RuntimeError("native shard reader unavailable "
                               "(the native library did not build)")
        arr = (ctypes.c_char_p * len(paths))(
            *[p.encode() for p in paths])
        self._paths = list(paths)
        self._handle = self._lib.rb_shard_reader_open(
            arr, len(paths), prefetch, n_threads)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        lib = self._lib
        while True:
            sh = lib.rb_shard_reader_next(self._handle)
            if not sh:
                return
            try:
                n_cols = lib.rb_shard_n_columns(sh)
                if n_cols == 0:
                    raise IOError("native shard reader: "
                                  + lib.rb_shard_error(sh).decode())
                part: Dict[str, np.ndarray] = {}
                for i in range(n_cols):
                    name = lib.rb_shard_col_name(sh, i).decode()
                    descr = lib.rb_shard_col_dtype(sh, i).decode()
                    if descr not in _DTYPES:
                        raise IOError(f"native reader: dtype {descr}")
                    ndim = lib.rb_shard_col_ndim(sh, i)
                    shape = (ctypes.c_int64 * ndim)()
                    lib.rb_shard_col_shape(sh, i, shape)
                    nbytes = lib.rb_shard_col_nbytes(sh, i)
                    ptr = ctypes.cast(
                        lib.rb_shard_col_data(sh, i),
                        ctypes.POINTER(ctypes.c_uint8))
                    view = np.ctypeslib.as_array(ptr, shape=(nbytes,))
                    # ONE copy out of the C++ buffer (freed after the loop)
                    a = view.view(_DTYPES[descr]).reshape(tuple(shape))
                    part[name] = np.array(a, copy=True)
                yield part
            finally:
                lib.rb_shard_free(sh)

    def close(self) -> None:
        if getattr(self, "_handle", None):
            self._lib.rb_shard_reader_close(self._handle)
            self._handle = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass
