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
`build_tool(name)` builds `csrc/tools/<name>.cu`, host code of the
kernels' selftest (ops/selftest.py), which is no kernel and not among
`sources()`.

Every source is compiled with -lineinfo, which maps each SASS instruction
to its source line for a report (compute-sanitizer's, a profiler's) and
changes no generated code.
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
TOOLS = os.path.join(CSRC, "tools")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-lineinfo", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

# sources compiled in parts, one `nvcc -c -DSHIFU_BUILD_PARTS=n
# -DSHIFU_BUILD_PART=p` a part, started with the other sources, then linked
# into the one library (each part instantiates some of the source's
# kernels; csrc/ft_block.cu says how)
PARTS = {"ft_block": 4}

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


def _start(name: str, src: Optional[str] = None, target: Optional[str] = None
           ) -> Optional[tuple[list, str, str]]:
    """Start nvcc for `name` (`src` into `target`, by default the kernel's
    source and library; one process a part for the sources in PARTS)
    unless its output is current; returns the processes, the temporary
    output and the final path."""
    target = target or library_path(name)
    if os.path.exists(target):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{target}.{os.getpid()}.{threading.get_ident()}.tmp"
    parts = PARTS.get(name, 0) if src is None else 0
    src = src or os.path.join(CSRC, f"{name}.cu")
    if parts:
        flags = [f for f in NVCC_FLAGS if f != "-shared"]
        cmds = [[_nvcc(), *flags, f"-DSHIFU_BUILD_PARTS={parts}",
                 f"-DSHIFU_BUILD_PART={p}", "-c", "-o", f"{tmp}.{p}.o", src]
                for p in range(parts)]
    else:
        cmds = [[_nvcc(), *NVCC_FLAGS, "-o", tmp, src]]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for cmd in cmds]
    return procs, tmp, target


def _finish(name: str, started) -> None:
    procs, tmp, target = started
    outs = [p.communicate() for p in procs]
    build_logs[name] = "".join((o or "") + (e or "") for o, e in outs)
    errors = [f"nvcc failed on {os.path.relpath(p.args[-1], _PKG)} (exit "
              f"{p.returncode}):\n{e}" for p, (_o, e) in zip(procs, outs)
              if p.returncode != 0]
    objs = [p.args[p.args.index("-o") + 1] for p in procs]
    if len(procs) > 1:
        if not errors:  # the parts into the library
            link = subprocess.run([_nvcc(), "-shared", "-Xcompiler", "-fPIC",
                                   "-o", tmp, *objs], capture_output=True,
                                  text=True)
            if link.returncode != 0:
                errors.append(f"nvcc failed to link {name}'s parts (exit "
                              f"{link.returncode}):\n{link.stderr}")
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    if errors:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise KernelBuildError("\n".join(errors))
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


def build_tool(name: str) -> str:
    """Build `csrc/tools/<name>.cu` into `_build/lib<name>-<hash>.so`
    unless it is current (the hash over its source and the flags); returns
    its path."""
    src = os.path.join(TOOLS, f"{name}.cu")
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    with open(src, "rb") as f:
        h.update(f.read())
    target = os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")
    with _lock:
        started = _start(name, src, target)
        if started is not None:
            _finish(name, started)
    return target


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
