"""ctypes binding for the native C++ data parser (the port's copy of
shifu_tpu/data/native_parser.py, over its own copy of the source,
runtime/csrc/shifu_parser.cc).

A zlib + from_chars C++ parse, multi-threaded on newline-aligned chunks,
in place of `reader.py`'s numpy tier; both give the same arrays bit for
bit (tests/test_torch_native_parser.py).  The library is host code built
by g++ at first use (`runtime/nativelib.py`).

`available()` is False when g++ or zlib is missing (or under
SHIFU_TPU_NO_NATIVE_PARSER); `reader.read_file` then takes the numpy tier,
and `unavailable_reason()` says why (the ingest journals it).
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional

import numpy as np

_lib = None
_lib_err: Optional[str] = None
_lock = threading.Lock()

_ENV_DISABLE = "SHIFU_TPU_NO_NATIVE_PARSER"
_ENV_THREADS = "SHIFU_TPU_PARSER_THREADS"


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _lib_err
    with _lock:
        if _lib is not None or _lib_err is not None:
            return _lib
        if os.environ.get(_ENV_DISABLE):
            _lib_err = "disabled via " + _ENV_DISABLE
            return None
        try:
            from ..runtime.nativelib import build_library
            lib = ctypes.CDLL(build_library(
                "shifu_parser.cc", extra_flags=["-lz", "-pthread", "-ldl"]))
        except Exception as e:  # no g++/zlib: numpy path serves instead
            _lib_err = str(e)
            return None
        lib.shifu_parse_file.restype = ctypes.c_int
        lib.shifu_parse_file.argtypes = [
            ctypes.c_char_p, ctypes.c_char, ctypes.c_int,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64)]
        lib.shifu_parse_buffer.restype = ctypes.c_int
        lib.shifu_parse_buffer.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_char, ctypes.c_int,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64)]
        lib.shifu_parser_free.argtypes = [ctypes.POINTER(ctypes.c_float)]
        lib.shifu_count_rows.restype = ctypes.c_int64
        lib.shifu_count_rows.argtypes = [ctypes.c_char_p]
        _lib = lib
        return _lib


def reset_for_tests() -> None:
    """Forget the loaded library and any failure (tests toggle
    SHIFU_TPU_NO_NATIVE_PARSER)."""
    global _lib, _lib_err
    with _lock:
        _lib = None
        _lib_err = None


def available() -> bool:
    return _load() is not None


def unavailable_reason() -> Optional[str]:
    _load()
    return _lib_err


def _num_threads() -> int:
    try:
        return int(os.environ.get(_ENV_THREADS, "0"))
    except ValueError:
        return 0  # 0 = hardware_concurrency (decided in C++)


def pool_parser_threads(pool_width: int) -> int:
    """Per-file intra-parse thread budget when `pool_width` files parse
    concurrently: split the cores across the pool instead of pinning every
    file to 1 thread.  A 2-file shard on an 8-core host then still inflates
    8-wide (4 threads per file) while an 8-file pool degrades to the old
    1-thread-per-file policy — total parallelism stays ~cores, never
    cores².  SHIFU_TPU_PARSER_THREADS (when set) wins outright: an
    operator override is an override."""
    env = _num_threads()
    if env > 0:
        return env
    return max(1, (os.cpu_count() or 1) // max(int(pool_width), 1))


def _take(lib, out_pp, rows_p, cols_p) -> np.ndarray:
    rows, cols = rows_p.value, cols_p.value
    if rows == 0 or cols == 0:
        return np.zeros((0, max(cols, 0)), dtype=np.float32)
    # copy out of the malloc'd buffer into numpy-owned memory, then free
    arr = np.ctypeslib.as_array(out_pp, shape=(rows, cols)).copy()
    lib.shifu_parser_free(out_pp)
    return arr


def _delim_byte(delimiter: str) -> bytes:
    b = delimiter.encode()
    if len(b) != 1:
        raise ValueError(
            f"native parser supports single-byte delimiters only, got "
            f"{delimiter!r} — use the numpy reader tier")
    return b


def parse_file(path: str, delimiter: str = "|",
               threads: Optional[int] = None) -> np.ndarray:
    """Parse a (possibly gzipped) delimited file into (N, C) float32.

    `threads` overrides the intra-file parse parallelism (None = env var /
    hardware_concurrency; callers doing file-level threading pass 1 to avoid
    cores^2 oversubscription).  Raises FileNotFoundError/OSError for IO
    problems (matching the Python tier), ValueError for multi-byte
    delimiters, RuntimeError otherwise.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native parser unavailable: {_lib_err}")
    delim = _delim_byte(delimiter)
    out_pp = ctypes.POINTER(ctypes.c_float)()
    rows_p = ctypes.c_int64(0)
    cols_p = ctypes.c_int64(0)
    rc = lib.shifu_parse_file(
        path.encode(), delim,
        _num_threads() if threads is None else int(threads),
        ctypes.byref(out_pp), ctypes.byref(rows_p), ctypes.byref(cols_p))
    if rc == 4:
        if not os.path.exists(path):
            raise FileNotFoundError(f"no such data file: {path}")
        raise OSError(f"unreadable data file: {path}")
    if rc == 5:
        raise OSError(f"corrupt or truncated gzip stream: {path}")
    if rc != 0:
        raise RuntimeError(f"shifu_parse_file({path!r}) failed rc={rc}")
    return _take(lib, out_pp, rows_p, cols_p)


def parse_buffer(text: bytes, delimiter: str = "|",
                 threads: Optional[int] = None) -> np.ndarray:
    """Parse an in-memory delimited text buffer into (N, C) float32."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native parser unavailable: {_lib_err}")
    delim = _delim_byte(delimiter)
    out_pp = ctypes.POINTER(ctypes.c_float)()
    rows_p = ctypes.c_int64(0)
    cols_p = ctypes.c_int64(0)
    rc = lib.shifu_parse_buffer(
        text, len(text), delim,
        _num_threads() if threads is None else int(threads),
        ctypes.byref(out_pp), ctypes.byref(rows_p), ctypes.byref(cols_p))
    if rc != 0:
        raise RuntimeError(f"shifu_parse_buffer failed rc={rc}")
    return _take(lib, out_pp, rows_p, cols_p)


def count_rows(path: str) -> int:
    """Count non-blank data lines (gzip-aware, streaming); native
    getFileLineCount.  Raises FileNotFoundError for a missing path (same
    contract as the Python tier), RuntimeError for engine failures."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native parser unavailable: {_lib_err}")
    n = lib.shifu_count_rows(path.encode())
    if n < 0:
        if not os.path.exists(path):
            raise FileNotFoundError(f"no such data file: {path}")
        raise RuntimeError(f"shifu_count_rows({path!r}) failed")
    return int(n)
