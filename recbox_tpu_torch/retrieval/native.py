"""ctypes bindings for the native host-side retrieval kernels.

Own copy of `recbox_tpu/retrieval/native.py`: exact MIPS top-k, an IVF-Flat
approximate index, a threaded negative sampler and the categorical vocab
encode, over the repository's C++ sources `native/recbox_native.cpp` and
`native/shard_reader.cpp` (the shard reader's symbols are declared by
`data/native_shards.py`). The numpy paths and the ctypes signatures are the
JAX package's, so both give the same arrays on the same inputs.

The shared library is built with ``g++`` at first use into
``build/native/`` at the repository root (listed in `.gitignore`), never
into ``native/``. Its file name carries a digest of both sources and the
flags, so an edited source builds anew; the compiler writes to a per-pid
temporary file that `os.replace` moves into place, so concurrent builds
(test workers, the JAX package's own ``make``) never load a half-written
library. It is opened with ctypes' default ``RTLD_LOCAL``: the JAX
package's ``native/librecbox_native.so`` carries the same symbol names and
may be loaded in the same process.

`load_native()` returns None when the build fails (no compiler), and every
entry point then takes its numpy path, as in JAX; `load_native(strict=True)`
raises with the compiler's output instead. This is host code, no device
kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import time
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

__all__ = ["load_native", "native_available", "exact_topk", "IVFFlatIndex",
           "sample_negatives_native", "vocab_encode_native", "library_path",
           "BUILD_DIR", "SOURCES", "CXX_FLAGS"]

logger = logging.getLogger("recbox_tpu_torch")

_REPO = Path(__file__).resolve().parents[2]
SOURCES = (_REPO / "native" / "recbox_native.cpp",
           _REPO / "native" / "shard_reader.cpp")
BUILD_DIR = _REPO / "build" / "native"
# `native/Makefile`'s CXXFLAGS and link flag
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-pthread",
             "-shared")

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False
# how the last load went: the library's path, whether this process built
# it, the build's seconds and the compiler's output
build_info: dict = {}


def library_path() -> Path:
    """Where the library of the current sources and flags lives."""
    h = hashlib.sha1()
    for src in SOURCES:
        h.update(src.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"librecbox_native-{h.hexdigest()[:12]}.so"


def _build(so: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cxx = os.environ.get("CXX", "g++")
    cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), *map(str, SOURCES)]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        raise RuntimeError(f"native build failed: {e}") from e
    build_info.update(built=True, seconds=time.perf_counter() - t0,
                      output=proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native build failed: {cxx} exited "
                           f"{proc.returncode}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, so)


def _declare(lib: ctypes.CDLL) -> None:
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.rbn_topk_ip.argtypes = [f32p, ctypes.c_int, f32p, ctypes.c_int,
                                ctypes.c_int, ctypes.c_int, f32p, i32p,
                                ctypes.c_int]
    lib.rbn_kmeans.argtypes = [f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                               ctypes.c_int, ctypes.c_uint64, f32p, i32p,
                               ctypes.c_int]
    lib.rbn_ivf_search.argtypes = [f32p, ctypes.c_int, f32p, ctypes.c_int,
                                   ctypes.c_int, f32p, ctypes.c_int, i32p,
                                   i32p, ctypes.c_int, ctypes.c_int, f32p,
                                   i32p, ctypes.c_int]
    lib.rbn_sample_negatives.argtypes = [i32p, ctypes.c_int, ctypes.c_int,
                                         ctypes.c_int, ctypes.c_uint64, i32p,
                                         ctypes.c_int]
    lib.rbn_vocab_encode.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, i32p,
        ctypes.c_char_p, ctypes.c_int32, ctypes.c_int,
        ctypes.c_int32, i32p, ctypes.c_int]


def load_native(rebuild: bool = False,
                strict: bool = False) -> Optional[ctypes.CDLL]:
    """Load the native library, building it first if it is missing; None
    when the build fails (numpy paths), or, with ``strict``, raise with
    the compiler's output. ``rebuild`` compiles again even when the
    library exists (a library already loaded in this process stays)."""
    global _LIB, _TRIED
    if _LIB is not None:
        if rebuild:
            # the .so is already dlopen-mapped: dlopen would return the
            # stale image
            logger.warning("native lib already loaded; restart the process "
                           "to pick up a rebuild")
        return _LIB
    if _TRIED and not rebuild and not strict:
        return None
    _TRIED = True
    try:
        so = library_path()
        if rebuild or not so.exists():
            _build(so)
        else:
            build_info.update(built=False, seconds=0.0, output="")
        lib = ctypes.CDLL(str(so))
        _declare(lib)
    except Exception as e:
        if strict:
            raise
        logger.warning("native build failed (%s); numpy fallbacks active", e)
        return None
    build_info["path"] = str(so)
    _LIB = lib
    return lib


def native_available() -> bool:
    return load_native() is not None


def _f32(a: np.ndarray):
    return np.ascontiguousarray(a, np.float32)


def _ptr(a: np.ndarray, ty):
    return a.ctypes.data_as(ctypes.POINTER(ty))


def _threads(n_threads: int) -> int:
    return n_threads or min(32, os.cpu_count() or 1)


def exact_topk(queries: np.ndarray, items: np.ndarray, k: int,
               n_threads: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Exact MIPS top-k on host. Native path if available, else numpy."""
    queries = _f32(queries)
    items = _f32(items)
    nq, d = queries.shape
    ni = items.shape[0]
    if items.shape[1] != d:
        # the C++ kernel indexes both arrays with the query's d — a
        # mismatch would read past the items buffer
        raise ValueError(
            f"dim mismatch: queries d={d} vs items d={items.shape[1]}")
    k = min(k, ni)
    lib = load_native()
    if lib is not None:
        scores = np.empty((nq, k), np.float32)
        ids = np.empty((nq, k), np.int32)
        lib.rbn_topk_ip(_ptr(queries, ctypes.c_float), nq,
                        _ptr(items, ctypes.c_float), ni, d, k,
                        _ptr(scores, ctypes.c_float),
                        _ptr(ids, ctypes.c_int32), _threads(n_threads))
        return scores, ids
    full = queries @ items.T
    ids = np.argpartition(-full, k - 1, axis=1)[:, :k]
    scores = np.take_along_axis(full, ids, axis=1)
    order = np.argsort(-scores, axis=1)
    return (np.take_along_axis(scores, order, axis=1).astype(np.float32),
            np.take_along_axis(ids, order, axis=1).astype(np.int32))


class IVFFlatIndex:
    """IVF-Flat ANN index (faiss IndexIVFFlat analog): k-means coarse
    quantizer + inverted lists; search scans the `nprobe` closest lists.
    The native k-means sums in ``n_threads`` threads, so its centroids
    depend on the thread count."""

    def __init__(self, nlist: int = 64, nprobe: int = 8,
                 kmeans_iters: int = 10, seed: int = 0, n_threads: int = 0):
        if kmeans_iters < 1:
            # assignments are only written inside the iteration loop (both
            # native and numpy paths) — 0 iters would build inverted lists
            # from uninitialized memory
            raise ValueError("kmeans_iters must be >= 1")
        self.nlist = nlist
        self.nprobe = nprobe
        self.kmeans_iters = kmeans_iters
        self.seed = seed
        self.n_threads = _threads(n_threads)
        self.items: Optional[np.ndarray] = None

    def fit(self, items: np.ndarray) -> "IVFFlatIndex":
        self.items = _f32(items)
        ni, d = self.items.shape
        nlist = min(self.nlist, ni)
        self.nlist = nlist
        lib = load_native()
        self.centroids = np.empty((nlist, d), np.float32)
        assign = np.empty(ni, np.int32)
        if lib is not None:
            lib.rbn_kmeans(_ptr(self.items, ctypes.c_float), ni, d, nlist,
                           self.kmeans_iters, self.seed,
                           _ptr(self.centroids, ctypes.c_float),
                           _ptr(assign, ctypes.c_int32), self.n_threads)
        else:
            rng = np.random.default_rng(self.seed)
            self.centroids[:] = self.items[
                rng.choice(ni, nlist, replace=False)]
            x2 = (self.items ** 2).sum(-1, keepdims=True)
            for _ in range(self.kmeans_iters):
                # (ni, nlist) matmul form — the broadcast form materializes
                # an (ni, nlist, d) tensor
                d2 = (x2 - 2.0 * self.items @ self.centroids.T
                      + (self.centroids ** 2).sum(-1)[None, :])
                assign = d2.argmin(1).astype(np.int32)
                for c in range(nlist):
                    sel = self.items[assign == c]
                    if len(sel):
                        self.centroids[c] = sel.mean(0)
        order = np.argsort(assign, kind="stable")
        self.list_ids = order.astype(np.int32)
        counts = np.bincount(assign, minlength=nlist)
        self.list_offsets = np.zeros(nlist + 1, np.int32)
        np.cumsum(counts, out=self.list_offsets[1:])
        return self

    def search(self, queries: np.ndarray,
               k: int = 10) -> Tuple[np.ndarray, np.ndarray]:
        queries = _f32(queries)
        nq, d = queries.shape
        if self.items is not None and self.items.shape[1] != d:
            raise ValueError(
                f"dim mismatch: queries d={d} vs fitted items "
                f"d={self.items.shape[1]}")
        k = min(k, self.items.shape[0])
        lib = load_native()
        if lib is not None:
            scores = np.empty((nq, k), np.float32)
            ids = np.empty((nq, k), np.int32)
            lib.rbn_ivf_search(
                _ptr(queries, ctypes.c_float), nq,
                _ptr(self.items, ctypes.c_float), self.items.shape[0], d,
                _ptr(self.centroids, ctypes.c_float), self.nlist,
                _ptr(self.list_offsets, ctypes.c_int32),
                _ptr(self.list_ids, ctypes.c_int32),
                self.nprobe, k,
                _ptr(scores, ctypes.c_float), _ptr(ids, ctypes.c_int32),
                self.n_threads)
            return scores, ids
        # numpy fallback: probe lists by centroid score
        cs = queries @ self.centroids.T
        probes = np.argsort(-cs, axis=1)[:, : self.nprobe]
        scores = np.full((nq, k), -np.inf, np.float32)
        ids = np.full((nq, k), -1, np.int32)
        for q in range(nq):
            cand = np.concatenate([
                self.list_ids[self.list_offsets[c]: self.list_offsets[c + 1]]
                for c in probes[q]]) if len(probes[q]) else np.array([], int)
            if not len(cand):
                continue
            s = queries[q] @ self.items[cand].T
            kk = min(k, len(cand))
            top = np.argsort(-s)[:kk]
            scores[q, :kk] = s[top]
            ids[q, :kk] = cand[top]
        return scores, ids


def sample_negatives_native(positives: np.ndarray, n_items: int,
                            num_negs: int, seed: int = 0,
                            n_threads: int = 0) -> np.ndarray:
    """Threaded uniform negative sampling with positive exclusion
    (`h5_generator.py:72-95` semantics). numpy fallback when no native lib."""
    positives = np.ascontiguousarray(positives, np.int32)
    if n_items <= 1:
        raise ValueError("negative sampling needs n_items > 1 "
                         "(positive exclusion would spin forever)")
    n = len(positives)
    lib = load_native()
    if lib is not None:
        out = np.empty((n, num_negs), np.int32)
        lib.rbn_sample_negatives(
            _ptr(positives, ctypes.c_int32), n, n_items, num_negs, seed,
            _ptr(out, ctypes.c_int32), _threads(n_threads))
        return out
    rng = np.random.default_rng(seed)
    out = rng.integers(0, n_items, size=(n, num_negs), dtype=np.int32)
    bad = out == positives[:, None]
    while bad.any():
        out[bad] = rng.integers(0, n_items, size=int(bad.sum()), dtype=np.int32)
        bad = out == positives[:, None]
    return out


def vocab_encode_native(values: np.ndarray, vocab: dict, oov: int,
                        n_threads: int = 0):
    """Categorical vocab lookup in C++ (rbn_vocab_encode): tokens become
    fixed-width utf-8 byte slots, resolved through an open-addressing hash
    table. Returns None (the caller takes the Python loop) when the native
    lib is unavailable or the inputs don't fit the fast path."""
    lib = load_native()
    if lib is None or not vocab:
        return None

    def to_bytes(a):
        # astype('S') is a C-level ascii cast; non-ascii raises and falls
        # back to per-element utf-8 (np.char.encode is a Python loop, so
        # it is the exception path only)
        try:
            return a.astype("S")
        except (UnicodeEncodeError, UnicodeDecodeError, ValueError):
            return np.char.encode(a.astype("U"), "utf-8")

    try:
        arr = np.asarray(values)
        if arr.dtype.kind == "S":
            # raw bytes do NOT match the Tokenizer's str() vocab semantics
            # (str(b'x') == "b'x'"): the dict loop rather than whole
            # columns encoded to OOV
            return None
        elif arr.dtype.kind in "OUfiu":
            keys = to_bytes(arr if arr.dtype.kind == "U"
                            else arr.astype("U"))
        else:
            return None
        toks = to_bytes(np.asarray(list(vocab.keys()), dtype="U"))
        ids = np.fromiter(vocab.values(), np.int32, count=len(vocab))
    except (UnicodeEncodeError, UnicodeDecodeError, ValueError):
        return None
    if len(arr) >= 2 ** 31:
        return None
    keys = np.ascontiguousarray(keys)
    toks = np.ascontiguousarray(toks)
    out = np.empty(len(arr), np.int32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.rbn_vocab_encode(
        toks.ctypes.data_as(ctypes.c_char_p), len(toks),
        toks.dtype.itemsize, ids.ctypes.data_as(i32p),
        keys.ctypes.data_as(ctypes.c_char_p), len(keys),
        keys.dtype.itemsize, np.int32(oov),
        out.ctypes.data_as(i32p), _threads(n_threads))
    return out
