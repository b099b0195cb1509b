"""Filesystem helpers of the training path (port of
shifu_tpu/data/fsio.py): local paths plus hdfs:// gs:// s3:// file://
mock:// URIs.

Plain paths never touch pyarrow.  A remote URI routes through
`pyarrow.fs`, whose import is gated as in the JAX package: a missing
pyarrow raises a clear error only when a remote URI is used, and nothing
falls back to another filesystem.  Remote calls retry transient errors
with decorrelated-jitter backoff under a per-call deadline
(`SHIFU_TPU_FS_RETRIES`, `SHIFU_TPU_FS_RETRY_DEADLINE_S`); missing files
and auth-shaped errors fail at once and count in `fsio_terminal_total`;
an exhausted ladder journals `fsio_retry_exhausted`.  Filesystems are
memoized per scheme://authority endpoint.

`read_bytes`, `write_bytes`, `write_bytes_atomic` and `list_files` carry
the chaos sites `fsio.read_bytes`, `fsio.write_bytes` and
`fsio.list_files` on their remote branch, as in the JAX package.
"""

from __future__ import annotations

import os
import re
import threading as _threading
from typing import Optional, Tuple

_SCHEME_RE = re.compile(r"^[a-zA-Z][a-zA-Z0-9+.-]*://")

# schemes handled by pyarrow.fs.FileSystem.from_uri
_KNOWN_SCHEMES = ("hdfs", "viewfs", "gs", "gcs", "s3", "file", "mock")


def is_remote(path: str) -> bool:
    """True for scheme:// URIs that route through pyarrow.fs."""
    m = _SCHEME_RE.match(path)
    return bool(m) and path.split("://", 1)[0].lower() in _KNOWN_SCHEMES


def join(base: str, *names: str) -> str:
    """Path join that keeps a URI's scheme (one definition for both)."""
    if is_remote(base):
        return "/".join([base.rstrip("/"), *names])
    return os.path.join(base, *names)


# (scheme, authority) -> FileSystem: one libhdfs/GCS/S3 connection per
# endpoint instead of one per call
_fs_cache: dict = {}
_fs_lock = _threading.Lock()

# bucket-style filesystems keep the first URI segment (the bucket) in the
# in-filesystem path; authority-style ones (namenode, empty file:// host)
# strip it
_BUCKET_SCHEMES = ("gs", "gcs", "s3", "mock")


def _derive_fs_path(scheme: str, rest: str) -> str:
    # from_uri percent-decodes the path component; match it so a cache hit
    # yields exactly the path from_uri would have produced
    from urllib.parse import unquote
    if scheme in _BUCKET_SCHEMES:
        return unquote(rest)
    slash = rest.find("/")
    return unquote(rest[slash:]) if slash >= 0 else "/"


def _filesystem(path: str) -> Tuple["object", str]:
    """(pyarrow FileSystem, in-filesystem path) for a URI; the filesystem is
    memoized per scheme://authority endpoint.  The in-filesystem path is
    derived structurally and validated against from_uri's answer on the first
    call per endpoint — the endpoint is only cached when they agree, so a
    cache hit can never produce a path from_uri would not have."""
    try:
        from pyarrow import fs as pafs
    except Exception as e:  # pyarrow is optional: local paths need none
        raise RuntimeError(
            f"remote data path {path!r} needs pyarrow, which failed to "
            f"import: {e}") from e
    scheme, rest = path.split("://", 1)
    scheme = scheme.lower()
    endpoint = (scheme, "" if scheme in _BUCKET_SCHEMES else rest.split("/", 1)[0])
    derived = _derive_fs_path(scheme, rest)
    with _fs_lock:
        cached = _fs_cache.get(endpoint)
    if cached is not None:
        return cached, derived
    try:
        filesystem, fs_path = pafs.FileSystem.from_uri(path)
    except Exception as e:
        raise OSError(f"cannot open filesystem for {path!r}: {e}") from e
    if fs_path == derived:
        with _fs_lock:
            _fs_cache.setdefault(endpoint, filesystem)
    return filesystem, fs_path


def exists(path: str) -> bool:
    """Does a file/object exist at `path`?  Local paths stat; remote URIs
    ask the filesystem.  Unreachable filesystems read as absent — callers
    at this level (lease reads, staleness probes) treat "can't tell" and
    "not there" the same way."""
    if not is_remote(path):
        return os.path.exists(path)
    try:
        filesystem, fs_path = _filesystem(path)
        from pyarrow import fs as pafs
        return filesystem.get_file_info(fs_path).type \
            != pafs.FileType.NotFound
    except Exception:
        return False


def write_bytes_atomic(path: str, data: bytes) -> None:
    """Publish `data` at `path` so no reader ever observes a torn write.

    Local: tmp file + os.replace (POSIX rename atomicity).  Remote: a
    single open_output_stream/close — object stores publish the object
    only when the stream closes, which is the same no-torn-reads
    guarantee; hdfs-style filesystems expose the file at create, so a
    tmp + move lands the rename-atomicity there too."""
    if not is_remote(path):
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
        return
    filesystem, fs_path = _filesystem(path)
    tmp_fs_path = f"{fs_path}.tmp.{os.getpid()}"

    def op() -> None:
        from .. import chaos
        chaos.maybe_fail("fsio.write_bytes", path=path)
        parent = fs_path.rsplit("/", 1)[0]
        if parent and parent != fs_path:
            try:
                filesystem.create_dir(parent, recursive=True)
            except Exception:
                pass  # object stores have no dirs; write decides
        with filesystem.open_output_stream(tmp_fs_path) as f:
            f.write(data)
        try:
            filesystem.move(tmp_fs_path, fs_path)
        except Exception:
            # no rename on this store: the close above already published
            # the tmp object whole — fall back to a direct whole-object
            # write (still never torn) and drop the tmp
            with filesystem.open_output_stream(fs_path) as f:
                f.write(data)
            try:
                filesystem.delete_file(tmp_fs_path)
            except Exception:
                pass
    _retry_transient(op, _classifier(filesystem, fs_path, path),
                     op_name="write_bytes_atomic")


def open_input_file(path: str):
    """A seekable pyarrow input file for a remote URI (parquet readers need
    random access, unlike the streaming read_bytes path)."""
    filesystem, fs_path = _filesystem(path)
    return _retry_transient(lambda: filesystem.open_input_file(fs_path),
                            _classifier(filesystem, fs_path, path),
                            op_name="open_input_file")


def _retry_attempts() -> int:
    """Total tries for a transient remote failure: 1 + retries.
    SHIFU_TPU_FS_RETRIES tunes it (0 disables).  The reference leaned on the
    HDFS client's own retry policy; pyarrow surfaces transient datanode /
    network errors to the caller, so the equivalent lives here."""
    try:
        return max(0, int(os.environ.get("SHIFU_TPU_FS_RETRIES", "2"))) + 1
    except ValueError:
        return 3


# error-message markers that make a remote failure NOT worth retrying —
# auth/permission problems fail the same way on every attempt, and across a
# 1000-shard dataset pointless retries turn a clear error into minutes of
# backoff.  Best-effort string match: pyarrow raises plain OSError for most
# filesystem failures, so the type alone cannot classify.
_TERMINAL_MARKERS = ("permission denied", "access denied", "accessdenied",
                     "forbidden", "unauthorized", "authentication",
                     "kerberos", "credential", "token expired")


def _count_terminal(op_name: str, reason: str) -> None:
    """fsio_terminal_total: remote failures that gave up (no more retries) —
    best-effort telemetry, never allowed to mask the real error."""
    try:
        from .. import obs
        obs.counter("fsio_terminal_total",
                    "remote fs failures not retried / exhausted").inc(
            op=op_name or "op", reason=reason)
    except Exception:
        pass


# retry backoff bounds: decorrelated jitter between _RETRY_BASE_S and 3x the
# previous sleep, capped — a gang of hosts hitting the same flaky namenode
# must NOT re-arrive in lockstep (synchronized exponential backoff turns one
# hiccup into N coordinated thundering herds, re-triggering the overload)
_RETRY_BASE_S = 0.1
_RETRY_CAP_S = 5.0


def _retry_deadline_s() -> float:
    """Total wall-clock budget for ONE remote call's whole retry ladder
    (attempt time + backoff sleeps).  A persistent fault under a raised
    SHIFU_TPU_FS_RETRIES is otherwise unbounded per call — N shards x an
    unbounded ladder wedges job startup for hours.  0 disables the cap."""
    try:
        return max(0.0, float(os.environ.get(
            "SHIFU_TPU_FS_RETRY_DEADLINE_S", "60")))
    except ValueError:
        return 60.0


def _journal_exhausted(op_name: str, elapsed_s: float, attempts: int,
                       deadline_s: float, reason: str) -> None:
    """`fsio_retry_exhausted` journal record: which op gave up, after how
    long and how many tries — the forensic line that separates "the fault
    outlived the budget" from "the budget was too small"."""
    try:
        from .. import obs
        obs.event("fsio_retry_exhausted", op=op_name or "op",
                  elapsed_s=round(elapsed_s, 3), attempts=attempts,
                  deadline_s=round(deadline_s, 3), reason=reason)
    except Exception:
        pass


def _retry_transient(op, classify=None, op_name: str = ""):
    """Run `op()` retrying transient remote errors with decorrelated-jitter
    backoff (sleep ~ U[base, 3*prev], capped — AWS architecture blog's
    "decorrelated jitter": retries desynchronize across a gang instead of
    hammering the endpoint in waves).

    `classify(exc)` may raise a terminal error (FileNotFoundError /
    IsADirectoryError) instead of letting the retry proceed; auth-shaped
    errors (see _TERMINAL_MARKERS) never retry.  Every remote operation —
    read, streaming count, listing, parquet open — goes through here, so a
    transient namenode/datanode hiccup can't kill job startup.  Retries and
    terminal failures export as `fsio_retry_total` / `fsio_terminal_total`
    (labels: op, and reason for terminal ones)."""
    import random
    import time

    attempts = _retry_attempts()
    deadline_s = _retry_deadline_s()
    t0 = time.monotonic()
    sleep_s = _RETRY_BASE_S
    for attempt in range(attempts):
        try:
            return op()
        except (FileNotFoundError, IsADirectoryError):
            _count_terminal(op_name, "not_found")
            raise
        except Exception as e:
            if classify is not None:
                try:
                    classify(e)  # may raise the terminal classification
                except (FileNotFoundError, IsADirectoryError):
                    _count_terminal(op_name, "not_found")
                    raise
            msg = str(e).lower()
            if any(m in msg for m in _TERMINAL_MARKERS):
                _count_terminal(op_name, "auth")
                raise
            if attempt == attempts - 1:
                _count_terminal(op_name, "exhausted")
                _journal_exhausted(op_name, time.monotonic() - t0,
                                   attempt + 1, deadline_s, "attempts")
                raise
            sleep_s = min(_RETRY_CAP_S,
                          random.uniform(_RETRY_BASE_S, sleep_s * 3))
            # total-deadline cap on the ladder: if the next sleep would
            # overrun the per-call budget, surface the real error NOW —
            # retrying past the deadline only delays the same failure
            elapsed = time.monotonic() - t0
            if deadline_s > 0 and elapsed + sleep_s > deadline_s:
                _count_terminal(op_name, "deadline")
                _journal_exhausted(op_name, elapsed, attempt + 1,
                                   deadline_s, "deadline")
                raise
            try:
                from .. import obs
                obs.counter("fsio_retry_total",
                            "remote fs transient-error retries").inc(
                    op=op_name or "op")
            except Exception:
                pass
            time.sleep(sleep_s)
    raise AssertionError("unreachable")


def _classifier(filesystem, fs_path: str, path: str):
    """classify-after-the-fact for _retry_transient: one stat on the failure
    path turns missing-file/directory errors terminal."""
    from pyarrow import fs as pafs

    def classify(e: Exception) -> None:
        try:
            info = filesystem.get_file_info(fs_path)
        except Exception:
            return  # stat itself flaky: let the retry decide
        if info.type == pafs.FileType.NotFound:
            raise FileNotFoundError(f"no such data file: {path}") from e
        if info.type == pafs.FileType.Directory:
            raise IsADirectoryError(
                f"expected a file, got a directory: {path}") from e

    return classify


def upload_dir(local_dir: str, remote_dir: str,
               chunk_bytes: int = 8 << 20) -> list[str]:
    """Upload every file under local_dir to remote_dir (recursive, relative
    layout preserved); returns the remote paths written.  Streams in
    fixed-size chunks — a multi-GB weights file must not be materialized
    in host RAM.  Used to ship locally-built artifacts (export dir, native
    pack) to a remote job dir."""
    out: list[str] = []
    base = remote_dir.rstrip("/")
    for root, _dirs, files in os.walk(local_dir):
        rel_root = os.path.relpath(root, local_dir)
        for name in sorted(files):
            rel = name if rel_root == "." else f"{rel_root}/{name}"
            target = f"{base}/{rel}"
            filesystem, fs_path = _filesystem(target)

            def op() -> None:
                parent = fs_path.rsplit("/", 1)[0]
                if parent and parent != fs_path:
                    try:  # object stores have no dirs; hdfs-style need them
                        filesystem.create_dir(parent, recursive=True)
                    except Exception:
                        pass
                with open(os.path.join(root, name), "rb") as src, \
                        filesystem.open_output_stream(fs_path) as dst:
                    while True:
                        chunk = src.read(chunk_bytes)
                        if not chunk:
                            break
                        dst.write(chunk)

            _retry_transient(op, _classifier(filesystem, fs_path, target),
                             op_name="upload_dir")
            out.append(target)
    return out


def count_data_lines(path: str, chunk_bytes: int = 1 << 20) -> int:
    """Count non-blank lines of a (possibly gzipped) remote file, streaming —
    constant memory regardless of file size (the local analog streams too,
    reader.count_rows).  A transient mid-stream error restarts the whole
    count (the state is per-attempt, so a retry can't double-count)."""
    import zlib

    filesystem, fs_path = _filesystem(path)

    def op() -> int:
        count = 0
        line_has_content = False

        def feed(data: bytes) -> None:
            # count newline-terminated non-blank lines; carry blank/content
            # state across chunk borders
            nonlocal count, line_has_content
            parts = data.split(b"\n")
            for piece in parts[:-1]:
                if line_has_content or piece.strip():
                    count += 1
                line_has_content = False
            if parts[-1].strip():
                line_has_content = True

        decomp = None
        first = True
        with filesystem.open_input_stream(fs_path) as stream:
            while True:
                chunk = stream.read(chunk_bytes)
                if not chunk:
                    break
                chunk = bytes(chunk)
                if first:
                    first = False
                    if chunk[:2] == b"\x1f\x8b":
                        decomp = zlib.decompressobj(wbits=31)  # gzip wrapper
                if decomp is None:
                    feed(chunk)
                    continue
                # multi-member (concatenated) gzip: each member ends the
                # decompressobj with the remainder in unused_data — restart a
                # fresh decompressor per member (gzip.decompress semantics)
                data = chunk
                while data:
                    feed(decomp.decompress(data))
                    if not decomp.eof:
                        break
                    data = decomp.unused_data
                    decomp = zlib.decompressobj(wbits=31)
        if decomp:
            feed(decomp.flush())
        if line_has_content:
            count += 1  # final unterminated line
        return count

    return _retry_transient(op, _classifier(filesystem, fs_path, path),
                            op_name="count_data_lines")


def file_info(path: str) -> Tuple[Optional[int], Optional[int]]:
    """(size_bytes, mtime_ns) of a file; raises FileNotFoundError.  On a
    remote filesystem either element is None when it is not reported:
    callers that key caches on it must treat None as uncacheable."""
    if not is_remote(path):
        st = os.stat(path)
        return int(st.st_size), int(st.st_mtime_ns)
    filesystem, fs_path = _filesystem(path)  # guards the pyarrow import
    from pyarrow import fs as pafs
    info = filesystem.get_file_info(fs_path)
    if info.type == pafs.FileType.NotFound:
        raise FileNotFoundError(f"no such data file: {path}")
    size = None if info.size is None else int(info.size)
    mtime_ns = None if info.mtime_ns is None else int(info.mtime_ns)
    return size, mtime_ns


def read_bytes(path: str) -> bytes:
    """A file's raw bytes.  Remote URIs stream through pyarrow.fs with
    transient errors retried; NotFound/Directory and auth failures fail at
    once."""
    if not is_remote(path):
        with open(path, "rb") as f:
            return f.read()
    filesystem, fs_path = _filesystem(path)  # guards the pyarrow import

    def op() -> bytes:
        from .. import chaos
        chaos.maybe_fail("fsio.read_bytes", path=path)
        with filesystem.open_input_stream(fs_path) as stream:
            return stream.read()

    return _retry_transient(op, _classifier(filesystem, fs_path, path),
                            op_name="read_bytes")


def write_bytes(path: str, data: bytes) -> None:
    """Write a whole file.  Local: a temporary file beside it, then
    `os.replace`, parents created, so no reader sees a torn write.
    Remote: one output stream (object stores publish on close; parent
    directories are created on hdfs-style filesystems)."""
    if not is_remote(path):
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
        return
    filesystem, fs_path = _filesystem(path)

    def op() -> None:
        from .. import chaos
        chaos.maybe_fail("fsio.write_bytes", path=path)
        parent = fs_path.rsplit("/", 1)[0]
        if parent and parent != fs_path:
            try:
                filesystem.create_dir(parent, recursive=True)
            except Exception:
                pass  # object stores have no dirs; write decides
        with filesystem.open_output_stream(fs_path) as f:
            f.write(data)

    _retry_transient(op, _classifier(filesystem, fs_path, path),
                     op_name="write_bytes")


def walk_files(root: str) -> list[tuple[str, int]]:
    """Every file under `root`, recursively, as (path-or-URI, size) sorted
    by path.  A file `root` yields itself; a missing root yields []."""
    if not is_remote(root):
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
    from pyarrow import fs as pafs
    filesystem, fs_path = _filesystem(root)
    base = fs_path.rstrip("/")
    rebuild = _rebuilder(root, fs_path)
    info = _retry_transient(lambda: filesystem.get_file_info(base),
                            op_name="walk_files")
    if info.type == pafs.FileType.File:
        return [(root, int(info.size or 0))]
    if info.type == pafs.FileType.NotFound:
        return []
    infos = _retry_transient(
        lambda: filesystem.get_file_info(
            pafs.FileSelector(base, recursive=True, allow_not_found=True)),
        op_name="walk_files")
    return sorted((rebuild(i.path), int(i.size or 0)) for i in infos
                  if i.type == pafs.FileType.File)


def _rebuilder(root: str, fs_path: str):
    """In-filesystem path -> URI on `root`'s filesystem: hdfs-style paths
    start with "/" and get the authority back; bucket-style ones keep the
    bucket as their first segment."""
    scheme, rest = root.split("://", 1)
    authority = rest.split("/", 1)[0] if fs_path.startswith("/") else ""

    def rebuild(p: str) -> str:
        if _SCHEME_RE.match(p):
            return p
        if p.startswith("/"):
            return f"{scheme}://{authority}{p}"
        return f"{scheme}://{p}"

    return rebuild


def list_files(root: str) -> list[str]:
    """Data files under a directory, skipping '.'/'_' prefixed names (the
    reference's HDFS listing filter); a file lists itself.  Remote paths
    keep their scheme, so reads route back through pyarrow.  A missing
    root raises FileNotFoundError."""
    if not is_remote(root):
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
    filesystem, fs_path = _filesystem(root)  # guards the pyarrow import
    from pyarrow import fs as pafs
    from .. import chaos

    def stat_op():
        chaos.maybe_fail("fsio.list_files", path=root)
        return filesystem.get_file_info(fs_path)

    info = _retry_transient(stat_op, op_name="list_files")
    if info.type == pafs.FileType.NotFound:
        raise FileNotFoundError(f"no such data path: {root}")
    if info.type == pafs.FileType.File:
        return [root]
    rebuild = _rebuilder(root, fs_path)
    selector = pafs.FileSelector(fs_path, recursive=False)
    children = _retry_transient(lambda: filesystem.get_file_info(selector),
                                op_name="list_files")
    out = []
    for child in sorted(children, key=lambda i: i.path):
        if child.type != pafs.FileType.File:
            continue
        base = child.base_name
        if base.startswith(".") or base.startswith("_"):
            continue
        out.append(rebuild(child.path))
    return out
