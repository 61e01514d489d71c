"""ctypes bindings for the port's native host library (native/io.cpp and
native/grounding.cpp; port of nl_vsgg_tpu/utils/native_io.py).

The library is built with g++ on first use into
`build/torch_native/libnlvsgg_io-<hash>.so` beside the package, named by a
hash of both sources and the flags: an edited source is rebuilt, an
unchanged one is built once per checkout. Each process compiles to a name
of its own and `os.replace`s it into place, so processes that build at once
(test workers) never load a half-written file. Without a compiler
`get_lib()` returns None and every caller takes its numpy path (config flag
`use_native_io`). Nothing is built when the module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import warnings

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRCS = tuple(os.path.join(_PKG, "native", n) for n in ("io.cpp", "grounding.cpp"))
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_native")
_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lock = threading.Lock()
_lib = None
_build_failed = False

_F32 = ctypes.POINTER(ctypes.c_float)
_I64 = ctypes.POINTER(ctypes.c_int64)
_I32 = ctypes.POINTER(ctypes.c_int32)
_U8 = ctypes.POINTER(ctypes.c_uint8)


def library_path() -> str:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for src in _SRCS:
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"libnlvsgg_io-{h.hexdigest()[:12]}.so")


def _build(target: str) -> bool:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{target}.{os.getpid()}.tmp"
    try:
        subprocess.run(["g++", *_FLAGS, *_SRCS, "-o", tmp], check=True, capture_output=True)
    except (subprocess.CalledProcessError, FileNotFoundError) as e:
        warnings.warn(f"native host library not built ({e!r}); numpy paths stand in")
        return False
    os.replace(tmp, target)  # atomic: a concurrent loader never sees half a file
    return True


def get_lib():
    """The loaded shared library, building it if needed; None on failure."""
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        target = library_path()
        if not os.path.isfile(target) and not _build(target):
            _build_failed = True
            return None
        lib = ctypes.CDLL(target)
        lib.read_npy_batch_f32.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int64,
            _F32, _I64, _I64, _I64, ctypes.c_int]
        lib.read_npy_batch_f32.restype = None
        lib.pack_padded_f32.argtypes = [
            _F32, _I64, ctypes.c_int, ctypes.c_int64, ctypes.c_int64, _F32]
        lib.pack_padded_f32.restype = None
        lib.pyset_intersect_order.argtypes = [
            _I64, ctypes.c_int, _I64, ctypes.c_int, _I64]
        lib.pyset_intersect_order.restype = ctypes.c_int
        lib.ground_pack.argtypes = [
            ctypes.c_int, ctypes.c_int, _F32, _I64,      # F, D, dets, counts
            _F32, ctypes.c_int, _I64, ctypes.c_int,      # feats, stride, counts, dim
            _I32, _I64, _F32, _F32, _F32,                # gt cls/off/att/sp/con
            _U8, ctypes.c_int,                           # person lut
            _I32, _I32, ctypes.c_int, ctypes.c_int,      # oi2ag, cnt, n_oi, fan
            ctypes.c_int, ctypes.c_int,                  # is_train, pseudo_way
            ctypes.c_int, ctypes.c_int,                  # BB, BR
            _F32, _I32, _U8, _I32, _F32, _F32, _F32,     # box-side outputs
            _I32, _I32, _U8, _F32, _F32, _F32,           # rel-side outputs
            _I64]                                        # out_counts
        lib.ground_pack.restype = ctypes.c_int
        _lib = lib
        return _lib


def _i64(a) -> np.ndarray:
    return np.ascontiguousarray(a, np.int64)


def pyset_intersect_order(a, b) -> list[int]:
    """The native engine's emulation of `list(set(a) & set(frozenset(b)))`
    (CPython's set iteration order); raises without the library."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native host library unavailable")
    a, b = _i64(a), _i64(b)
    out = np.zeros(max(len(a) + len(b), 1), np.int64)
    n = lib.pyset_intersect_order(a.ctypes.data_as(_I64), len(a), b.ctypes.data_as(_I64),
                                  len(b), out.ctypes.data_as(_I64))
    return out[:n].tolist()


def read_feat_batch(paths: list[str], cols: int, max_rows_each: int,
                    n_threads: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Parallel-read float32 .npy files into one (n, max_rows_each, cols)
    padded array; returns (array, counts). Rows past `max_rows_each` are
    dropped with a warning. Pure-numpy fallback without the library."""
    n = len(paths)

    def warn_truncated(true_counts):
        over = true_counts > max_rows_each
        if over.any():
            warnings.warn(
                f"{int(over.sum())} npy file(s) exceed max_rows={max_rows_each} "
                f"(largest {int(true_counts.max())} rows); extra rows DROPPED "
                f"(e.g. {paths[int(np.argmax(true_counts))]})")

    out = np.zeros((n, max_rows_each, cols), np.float32)
    counts = np.zeros(n, np.int64)
    lib = get_lib()
    if lib is None:
        true_counts = np.zeros(n, np.int64)
        for i, p in enumerate(paths):
            a = np.load(p)
            a = a.reshape(len(a), cols)  # `cols`, not -1: a file may hold 0 rows
            true_counts[i] = len(a)
            a = a[:max_rows_each]
            out[i, :len(a)] = a
            counts[i] = len(a)
        warn_truncated(true_counts)
        return out, counts

    offsets = _i64(np.arange(n) * max_rows_each)
    max_rows = _i64(np.full(n, max_rows_each))
    blob = b"\0".join(p.encode() for p in paths) + b"\0"
    lib.read_npy_batch_f32(blob, n, cols, out.ctypes.data_as(_F32),
                           offsets.ctypes.data_as(_I64), max_rows.ctypes.data_as(_I64),
                           counts.ctypes.data_as(_I64), n_threads)
    if (counts < 0).any():
        bad = [paths[i] for i in np.where(counts < 0)[0]]
        raise IOError(f"native npy read failed for {bad[:3]}...")
    # the native reader returns the files' true row counts
    warn_truncated(counts)
    return out, np.minimum(counts, max_rows_each)


def pack_padded(src: np.ndarray, row_counts: np.ndarray, bucket_rows: int) -> np.ndarray:
    """(total_rows, cols) ragged-concatenated rows -> (n_seg, bucket, cols)."""
    src = np.ascontiguousarray(src, np.float32)
    counts = _i64(row_counts)
    n_seg = len(counts)
    cols = src.shape[1]
    dst = np.zeros((n_seg, bucket_rows, cols), np.float32)
    lib = get_lib()
    if lib is None:
        off = 0
        for s, c in enumerate(counts):
            keep = min(int(c), bucket_rows)
            dst[s, :keep] = src[off:off + keep]
            off += int(c)
        return dst
    lib.pack_padded_f32(src.ctypes.data_as(_F32), counts.ctypes.data_as(_I64), n_seg, cols,
                        bucket_rows, dst.ctypes.data_as(_F32))
    return dst
