"""Filesystem helpers of the training path: the local half of
shifu_tpu/data/fsio.py.

`join`, `is_remote`, `walk_files`, `list_files`, `read_bytes`,
`write_bytes` (atomic: a temporary file in the same directory, then
`os.replace`) and `file_info` behave as the JAX package's do on local
paths.  A remote URI (`gs://`, `hdfs://`, `s3://`, ...) is recognised by
the same rule and raises `NotImplementedError`: the remote half
(pyarrow.fs, retries) is ROADMAP.md queue A item (a)4, and nothing falls
back to another filesystem.

`read_bytes`, `write_bytes` and `list_files` carry the chaos sites
`fsio.read_bytes`, `fsio.write_bytes` and `fsio.list_files`.  The JAX
package probes them on its remote branch only; the port, whose fsio is the
local half, probes them on every call.
"""

from __future__ import annotations

import os
import re
from typing import Optional, Tuple

_SCHEME_RE = re.compile(r"^[a-zA-Z][a-zA-Z0-9+.-]*://")

# the JAX package's schemes (pyarrow.fs.FileSystem.from_uri)
_KNOWN_SCHEMES = ("hdfs", "viewfs", "gs", "gcs", "s3", "file", "mock")


def is_remote(path: str) -> bool:
    """True for the scheme:// URIs the JAX package routes through
    pyarrow.fs."""
    m = _SCHEME_RE.match(path)
    return bool(m) and path.split("://", 1)[0].lower() in _KNOWN_SCHEMES


def _local_only(path: str) -> None:
    if is_remote(path):
        raise NotImplementedError(
            f"{path!r} is a remote URI: the port's fsio has only its local "
            "half so far (remote filesystems: ROADMAP.md queue A item (a)4)")


def join(base: str, *names: str) -> str:
    """Path join that keeps a URI's scheme (one definition for both)."""
    if is_remote(base):
        return "/".join([base.rstrip("/"), *names])
    return os.path.join(base, *names)


def file_info(path: str) -> Tuple[Optional[int], Optional[int]]:
    """(size_bytes, mtime_ns) of a file; raises FileNotFoundError."""
    _local_only(path)
    st = os.stat(path)
    return int(st.st_size), int(st.st_mtime_ns)


def _probe(site: str, path: str) -> None:
    from .. import chaos
    chaos.maybe_fail(site, path=path)


def read_bytes(path: str) -> bytes:
    _probe("fsio.read_bytes", path)
    _local_only(path)
    with open(path, "rb") as f:
        return f.read()


def write_bytes(path: str, data: bytes) -> None:
    """Write a whole file so that no reader sees a torn write: a temporary
    file beside it, then `os.replace`.  Parent directories are created."""
    _probe("fsio.write_bytes", path)
    _local_only(path)
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


def walk_files(root: str) -> list[tuple[str, int]]:
    """Every file under `root`, recursively, as (path, size) sorted by
    path.  A file `root` yields itself; a missing root yields []."""
    _local_only(root)
    if os.path.isfile(root):
        try:
            return [(root, os.path.getsize(root))]
        except OSError:
            return []
    out = []
    for dirpath, _dirs, names in os.walk(root):
        for name in names:
            full = os.path.join(dirpath, name)
            try:
                out.append((full, os.path.getsize(full)))
            except OSError:
                continue
    return sorted(out)


def list_files(root: str) -> list[str]:
    """Data files under a directory, skipping '.'/'_' prefixed names (the
    reference's HDFS listing filter); a file lists itself.  A missing root
    raises FileNotFoundError."""
    _probe("fsio.list_files", root)
    _local_only(root)
    if os.path.isfile(root):
        return [root]
    out = []
    for name in sorted(os.listdir(root)):
        if name.startswith(".") or name.startswith("_"):
            continue
        full = os.path.join(root, name)
        if os.path.isfile(full):
            out.append(full)
    return out
