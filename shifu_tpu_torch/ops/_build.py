"""Build the port's CUDA kernels at first use and load them with ctypes.

Each `csrc/<name>.cu` has a plain C interface and is compiled by `nvcc` on
its own into `shifu_tpu_torch/_build/lib<name>-<hash>.so`, where the hash
covers the source and the flags: an edited source builds anew, an unchanged
one loads the library already built.  No PyTorch headers are included, so a
build takes seconds (`torch.utils.cpp_extension.load` takes minutes for a
source that includes them).  A failed build raises with nvcc's stderr.

Nothing is built when this module is imported; `load(name)` builds on the
first call and `build_all()` starts one nvcc per source, all at once.
`adopt(name, path)` loads a library an AOT pack carries instead.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# nvcc's stderr per source (ptxas register/shared-memory report)
build_logs: dict[str, str] = {}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source."""


def sources() -> list[str]:
    """Kernel names: one per `csrc/*.cu`."""
    return sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu"))


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                            "bin", "nvcc")
        path = cand if os.path.exists(cand) else None
    if path is None:
        raise KernelBuildError(
            "nvcc not found (PATH or $CUDA_HOME/bin); the CUDA kernels are "
            "built from shifu_tpu_torch/csrc at first use on the card")
    return path


def source_hash(name: str) -> str:
    """The content hash of `csrc/<name>.cu`, the shared headers and the
    flags: the tag of its library's file name."""
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for fname in sorted(os.listdir(CSRC)):
        # a kernel's own source plus the shared headers
        if fname == f"{name}.cu" or fname.endswith(".cuh"):
            with open(os.path.join(CSRC, fname), "rb") as f:
                h.update(fname.encode())
                h.update(f.read())
    return h.hexdigest()[:16]


def library_path(name: str) -> str:
    """Where `csrc/<name>.cu`'s library is built (`build_all`, `load`)."""
    return os.path.join(BUILD_DIR, f"lib{name}-{source_hash(name)}.so")


def _start(name: str) -> Optional[tuple[subprocess.Popen, str, str]]:
    """Start nvcc for `name` unless its library is current; returns the
    process, the temporary output and the final path."""
    target = library_path(name)
    if os.path.exists(target):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{target}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    return proc, tmp, target


def _finish(name: str, started) -> None:
    proc, tmp, target = started
    out, err = proc.communicate()
    build_logs[name] = (out or "") + (err or "")
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise KernelBuildError(
            f"nvcc failed on csrc/{name}.cu (exit {proc.returncode}):\n{err}")
    os.replace(tmp, target)  # atomic: a concurrent loader sees all or none


def build_all(names: Optional[list[str]] = None) -> float:
    """Build every kernel (or those of `names`) that is not current, one
    nvcc per source, all started together; returns the wall seconds."""
    t0 = time.perf_counter()
    with _lock:
        started = {n: s for n in (names or sources())
                   if (s := _start(n)) is not None}
        errors = []
        for n, s in started.items():
            try:
                _finish(n, s)
            except KernelBuildError as e:
                errors.append(str(e))
        if errors:
            raise KernelBuildError("\n".join(errors))
    return time.perf_counter() - t0


def adopt(name: str, path: str) -> ctypes.CDLL:
    """Load `csrc/<name>.cu`'s library from `path`, a copy built elsewhere
    from the same source (an AOT pack's, export/aot.py, whose digest the
    caller has checked), unless this process has loaded it already; no
    nvcc runs.  Later `load(name)` calls return it."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(path)
    return lib


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, built first if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            started = _start(name)
            if started is not None:
                _finish(name, started)
            lib = ctypes.CDLL(library_path(name))
            _libs[name] = lib
    return lib
