"""Build and cache the port's host C++ components (the port's copy of
shifu_tpu/runtime/nativelib.py): the data parser's and the scorer's shared
libraries, and their sanitizer selftests.

`build_library("shifu_parser.cc")` compiles `runtime/csrc/<source>` with
g++ into `shifu_tpu_torch/_build/lib<name>-<machine>-<hash>.so`.  The hash
covers the source, the headers beside it and the flags, as the CUDA
kernels' names do (`ops/_build.py`): an edited source builds anew, an
unchanged one loads the library already built.  `<machine>` tags the host
CPU's capabilities, since the build uses -march=native and a library must
never load on a CPU with another ISA.  The flag variants are the JAX
package's: -march=native first, then without it for a compiler that
refuses the flag.  The output is written to a temporary name and renamed
into place, so a concurrent loader sees all of it or none.

`build_selftest("shifu_scorer.cc", sanitize="thread")` compiles the same
source with -DSHIFU_SELFTEST_MAIN into an executable instrumented by
ASan+UBSan (the default) or TSan, named `<name>-selftest-<sanitize>-<hash>`
by the same rule; running it drives the component's kernels under the
sanitizers (tests/test_torch_sanitizers.py).

Nothing is built when this module is imported.  A failed build raises
RuntimeError with g++'s stderr; the parser's callers then take the numpy
tier (`data/native_parser.unavailable_reason`).
"""

from __future__ import annotations

import hashlib
import os
import platform
import subprocess
import threading
from typing import Optional, Sequence

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "runtime", "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
BASE_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
FLAG_VARIANTS = (("-march=native", "-funroll-loops", *BASE_FLAGS),
                 BASE_FLAGS)
_lock = threading.Lock()


def _machine_tag() -> str:
    """Short id of this host's CPU capabilities (the /proc/cpuinfo flags)."""
    probe = platform.machine()
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):  # x86 / arm
                    probe += ":" + line.split(":", 1)[1].strip()
                    break
    except OSError:
        probe += ":" + platform.processor()
    return hashlib.sha1(probe.encode()).hexdigest()[:10]


def _target(source_name: str, flag_groups: Sequence[Sequence[str]],
            out_dir: str, name: str) -> str:
    """`out_dir/<name>-<hash>`, the hash over `flag_groups`, the source
    and the headers beside it."""
    h = hashlib.sha256()
    for flags in flag_groups:
        h.update(" ".join(flags).encode() + b"\0")
    for fname in sorted(os.listdir(CSRC)):
        # the source plus the headers it may include
        if fname == source_name or fname.endswith((".h", ".hpp")):
            with open(os.path.join(CSRC, fname), "rb") as f:
                h.update(fname.encode())
                h.update(f.read())
    return os.path.join(out_dir, f"{name}-{h.hexdigest()[:16]}")


def _compile(source_name: str, target: str,
             flag_variants: Sequence[Sequence[str]],
             extra_flags: Sequence[str], force: bool = False) -> str:
    """Build `target` from `runtime/csrc/<source_name>` unless it exists
    (or `force`), trying each flag variant in order; `extra_flags` follow
    the source (link libraries).  Returns `target`."""
    with _lock:
        if os.path.exists(target) and not force:
            return target
        os.makedirs(os.path.dirname(target), exist_ok=True)
        tmp = f"{target}.{os.getpid()}.{threading.get_ident()}.tmp"
        src = os.path.join(CSRC, source_name)
        err = ""
        for flags in flag_variants:
            cmd = ["g++", *flags, "-o", tmp, src, *extra_flags]
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True)
            except OSError as e:  # no g++ on PATH
                raise RuntimeError(f"native build failed: {e}") from e
            if proc.returncode == 0:
                os.replace(tmp, target)
                return target
            err = proc.stderr
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(
            f"native build failed ({' '.join(cmd)}):\n{err}")


def build_library(source_name: str, extra_flags: Sequence[str] = (),
                  out_dir: Optional[str] = None,
                  force: bool = False) -> str:
    """Compile `runtime/csrc/<source_name>` into a cached shared library
    unless it is current (or `force`); returns its path.  `extra_flags`
    follow the source on the command line (link libraries)."""
    stem = os.path.splitext(source_name)[0]
    target = _target(source_name, (*FLAG_VARIANTS, tuple(extra_flags)),
                     os.path.abspath(out_dir or BUILD_DIR),
                     f"lib{stem}-{_machine_tag()}")
    return _compile(source_name, target + ".so", FLAG_VARIANTS, extra_flags,
                    force=force)


def build_selftest(source_name: str, sanitize: str = "address,undefined",
                   extra_flags: Sequence[str] = (),
                   out_dir: Optional[str] = None,
                   force: bool = False) -> str:
    """Compile `runtime/csrc/<source_name>` with -DSHIFU_SELFTEST_MAIN into
    an executable instrumented by `-fsanitize=<sanitize>`; returns its
    path.  Running it drives the component's kernels (its `main`); exit 0
    means they passed under the sanitizers.  `force` rebuilds a current
    executable."""
    # -fno-sanitize-recover: UBSan otherwise only reports and exits 0
    flags = ("-O1", "-g", "-fno-omit-frame-pointer", f"-fsanitize={sanitize}",
             "-fno-sanitize-recover=all", "-DSHIFU_SELFTEST_MAIN",
             "-std=c++17")
    stem = os.path.splitext(source_name)[0]
    target = _target(source_name, (flags, tuple(extra_flags)),
                     os.path.abspath(out_dir or BUILD_DIR),
                     f"{stem}-selftest-{sanitize.replace(',', '_')}")
    return _compile(source_name, target, (flags,), extra_flags, force=force)
