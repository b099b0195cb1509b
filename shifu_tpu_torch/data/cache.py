"""Parse-once columnar cache for delimited data files, v2 (the port's copy
of shifu_tpu/data/cache.py; the same on-disk format, byte for byte, so a
cache written by either package is hot for the other).

- **raw tier** (`read_file_cached`): the first read of a data file parses
  it and writes the (N, C) float32 matrix as a little-endian `.npy` in an
  explicit cache directory; every later read is one `np.load`.
- **projected tier, format v2** (`write_projected_entry` /
  `load_projected_entry`): the fully projected per-file result — features
  already in the resolved wire format (int8 on the static `wire_params`
  grid, bf16 as its uint16 bits, or f32), the target as uint8 when that is
  exact, an all-ones weight column elided, and the train/valid mask — as a
  directory of raw `.npy` columns with an `entry.json` manifest.  The
  compaction is a disk encoding only: the loader rebuilds bit-exact
  float32 target and weight columns, so a hit equals a fresh parse,
  projection and cast.  The features come back memory-mapped.

The port holds bf16 features as their uint16 bits (numpy has no bfloat16;
`data/pipeline.bf16_bits`), which is what the entry stores, so they load
and write without a conversion.

Keying and invalidation: entry names embed sha1 hashes of the source path
and of (size, mtime_ns, delimiter, CACHE_FORMAT_VERSION); projected names
also hash the schema projection, the split parameters, the file's index
and the feature wire format (the int8 grid's clip rides in
`feature_dtype`).  Any change gives a new name, so a stale entry is never
served; writes publish atomically (`os.replace` / one directory rename)
and prune superseded entries of the same source.  Legacy v1 entries are
read once, rewritten as v2 and the v1 entry removed.

Every failure falls back to `reader.read_file`: the cache can always be
rebuilt from the data.  A failed load of an entry that exists journals
`cache_fallback`, and the `data.cache` chaos site covers entry reads and
writes.  `scan_cache` / `prune_cache` are the `cache` command's view.
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
import threading
import time
from typing import Callable, Optional

import numpy as np

# Bump when the parsed representation changes incompatibly.  v2 (this
# format): wire-format projected entries with an entry.json manifest and
# compact target/weight storage.  v1: float32 projected columns, no
# manifest — still readable (and upgraded on first touch).
CACHE_FORMAT_VERSION = 2

# Environment override: lets operators turn the cache on for unmodified jobs
# (e.g. the launcher CLI) without touching config files.
ENV_CACHE_DIR = "SHIFU_TPU_DATA_CACHE"

_MANIFEST = "entry.json"


def resolve_cache_dir(cache_dir: Optional[str] = None) -> Optional[str]:
    """Explicit argument wins; else the env var; else None (cache off)."""
    if cache_dir:
        return cache_dir
    return os.environ.get(ENV_CACHE_DIR) or None


def _sha1(text: str) -> str:
    return hashlib.sha1(text.encode()).hexdigest()


def _source_info(path: str):
    """(size, mtime_ns, path_part) for keying, or (None, None, None) when
    a remote filesystem reports no trustworthy metadata (keying on a
    constant would serve stale entries after an in-place overwrite).  A
    remote URI keys on the filesystem's metadata and on the URI itself."""
    from . import fsio

    if fsio.is_remote(path):
        size, mtime_ns = fsio.file_info(path)
        if size is None or mtime_ns is None:
            return None, None, None
        return size, mtime_ns, _sha1(path)[:16]
    st = os.stat(path)
    return st.st_size, st.st_mtime_ns, _sha1(os.path.abspath(path))[:16]


def cache_entry_name(path: str, delimiter: str,
                     version: Optional[int] = None) -> Optional[str]:
    """Deterministic cache file name for `path`'s current state, or None when
    the file is uncacheable.

    Local paths key on os.stat; remote URIs (hdfs/gs/s3/file) key on the
    filesystem's (size, mtime) metadata — so the cache also turns remote
    ingest into a local mmap-speed read after the first fetch.  A filesystem
    that reports no size or mtime returns None: keying on a constant would
    serve stale entries after an in-place overwrite, so such files are simply
    never cached.  `version` pins a specific format generation (the v1
    fallback probe passes 1); None means the current CACHE_FORMAT_VERSION.
    """
    size, mtime_ns, path_part = _source_info(path)
    if path_part is None:
        return None
    if version is None:
        version = CACHE_FORMAT_VERSION
    meta_part = _sha1(f"{size}:{mtime_ns}:{delimiter}:{version}")[:16]
    return f"{path_part}-{meta_part}.npy"


def read_file_cached(
    path: str,
    delimiter: str = "|",
    cache_dir: Optional[str] = None,
    mmap: bool = False,
    parser_threads: Optional[int] = None,
    write: bool = True,
) -> np.ndarray:
    """`reader.read_file` with a parse-once cache in front.

    With `mmap=True` a cache hit returns a read-only memory map — rows then
    page in on demand, so a dataset larger than RAM can stream through
    `iter_file_rows`-style consumers.  `write=False` reads hits (current or
    legacy-v1 keys) but never writes a new raw entry on a miss — the
    projected-entry path passes it so cold ingest does not duplicate the
    matrix as raw float32 next to the ¼-size v2 entry it is about to write.
    """
    from . import reader

    cache_dir = resolve_cache_dir(cache_dir)
    if cache_dir is None:
        return reader.read_file(path, delimiter, parser_threads=parser_threads)

    # ONE stat serves the current and legacy keys plus the prune spare set
    # (remote sources pay a metadata RPC per file_info)
    size, mtime_ns, path_part = _source_info(path)  # IO errors propagate
    if path_part is None:  # no trustworthy (size, mtime) key: don't cache
        return reader.read_file(path, delimiter, parser_threads=parser_threads)

    def versioned_name(v: int) -> str:
        return (f"{path_part}-"
                f"{_sha1(f'{size}:{mtime_ns}:{delimiter}:{v}')[:16]}.npy")

    name = versioned_name(CACHE_FORMAT_VERSION)
    hit = _load_raw_entry(cache_dir, name, mmap)
    if hit is not None:
        return hit
    keep = frozenset(versioned_name(v).rsplit(".", 1)[0].split("-")[1]
                     for v in range(1, CACHE_FORMAT_VERSION + 1))
    # legacy v1 raw entry: serve it and upgrade the key (even on a
    # write=False projected-path read — the re-key is one cheap copy that
    # keeps a bumped format from stranding a dataset-sized v1 orphan the
    # cache CLI cannot identify as reclaimable)
    v1name = versioned_name(1)
    if v1name != name:
        hit = _load_raw_entry(cache_dir, v1name, mmap)
        if hit is not None:
            _write_entry(cache_dir, name, np.asarray(hit), keep)
            # remove the v1 entry only once the v2 rewrite is actually on
            # disk — _write_entry never raises (full/read-only cache dir),
            # and deleting the sole cached copy after a swallowed write
            # failure would force a full re-parse on every later run
            if os.path.exists(os.path.join(cache_dir, name)):
                try:  # POSIX: the served mmap stays valid after unlink
                    os.remove(os.path.join(cache_dir, v1name))
                except OSError:
                    pass
            if mmap:
                fresh = _load_raw_entry(cache_dir, name, True)
                if fresh is not None:
                    return fresh
            return hit

    arr = reader.read_file(path, delimiter, parser_threads=parser_threads)
    if not write:
        return arr
    _write_entry(cache_dir, name, arr, keep)
    if mmap:
        try:
            return np.load(os.path.join(cache_dir, name), mmap_mode="r")
        except Exception:
            return arr
    return arr


def _load_raw_entry(cache_dir: str, name: str,
                    mmap: bool) -> Optional[np.ndarray]:
    entry = os.path.join(cache_dir, name)
    if not os.path.exists(entry):
        return None
    try:
        arr = np.load(entry, mmap_mode="r" if mmap else None)
        if arr.ndim == 2 and arr.dtype == np.float32:
            return arr
    except Exception:
        pass  # corrupt entry: fall through to removal + re-parse
    _journal_fallback(name, "corrupt raw entry")
    try:
        os.remove(entry)
    except OSError:
        pass
    return None


def projected_entry_name(path: str, delimiter: str, file_idx: int,
                         schema, valid_ratio: float, split_seed: int,
                         feature_dtype: str,
                         version: Optional[int] = None) -> Optional[str]:
    """Cache name for a PROJECTED per-file result (features/target/weight +
    train-valid mask, features already in the wire dtype).  Keyed on
    everything that shapes the result: source file state, schema column
    selection, split parameters, the file's position in the path list (row
    ids derive from it), the feature wire format (the int8 grid's clip rides
    in the `feature_dtype` string), and the cache format version.  One load
    then replaces parse + project + split + quantize on every later ingest.

    The entry is a DIRECTORY of raw per-column `.npy` files: raw npy loads
    mmap (np.load(mmap_mode='r')), so a warm-page-cache ingest streams the
    big features column straight into the concat/device copy instead of
    paying a zip-member copy first — measured ~3x faster aggregate load on
    the bench host.  v2 adds an `entry.json` manifest (format version,
    source identity for the `cache` command, and the compact target/weight
    recipe).  Legacy `.npz` entries from earlier rounds still load (read
    fallback below)."""
    if version is None:
        version = CACHE_FORMAT_VERSION
    base = cache_entry_name(path, delimiter, version=version)
    if base is None:
        return None
    sel = _sha1(str((tuple(schema.selected_indices),
                     tuple(schema.all_target_indices),
                     schema.weight_index, file_idx,
                     round(valid_ratio, 9), split_seed, feature_dtype,
                     version)))[:16]
    return base[:-4] + f"-p{sel}.npd"


def legacy_projected_path(entry_path: str) -> str:
    """The r4-format `.npz` path for a `.npd` directory entry path — the
    read fallback (and the hot-cache probe) accept either form."""
    return entry_path[:-4] + ".npz" if entry_path.endswith(".npd") \
        else entry_path


def _journal_fallback(name: str, reason: str) -> None:
    """Record a served-entry failure (corruption, injected read fault):
    the `cache_fallback` recovery event mirrors `checkpoint_fallback` —
    the drill-auditable proof that a damaged cache degraded to re-parse
    instead of serving garbage.  Never raises."""
    try:
        from .. import obs
        obs.counter("cache_fallback_total",
                    "cache entries that failed to serve and fell back "
                    "to re-parse").inc()
        obs.event("cache_fallback", entry=name, reason=str(reason)[:200])
    except Exception:
        pass


def _probe(op: str, path: str) -> None:
    """The `data.cache` chaos site: entry read/write attempts.  A raise
    here models a failing cache device — reads fall back to re-parse,
    writes are dropped (the cache is an accelerator, never a correctness
    dependency)."""
    from .. import chaos
    chaos.maybe_fail("data.cache", op=op, path=path)


def _decode_projected(has, get, manifest: Optional[dict]) -> Optional[dict]:
    """Shared decode for every entry form (v2 manifest directory, v1
    directory, legacy npz), given membership/load accessors: bf16 features
    round-trip as a tagged uint16 member (no container has bf16), compact
    v2 target/weight reconstruct to bit-exact float32, and a 2-D features
    matrix gates validity."""
    out = {}
    if has("features_bf16"):
        # the port's bf16 features are their uint16 bits
        out["features"] = get("features_bf16")
    else:
        out["features"] = get("features")
    if out["features"].ndim != 2:
        return None
    out["valid_mask"] = get("valid_mask")
    target = get("target")
    if target.dtype == np.uint8:
        # v2 compact storage: values were proven integers in [0, 255] at
        # write time, so the widening cast reconstructs the original f32
        # column bit-exactly
        target = target.astype(np.float32)
    out["target"] = target
    if has("weight"):
        out["weight"] = get("weight")
    else:
        # v2 elided weight: proven all-ones at write time
        rows = int((manifest or {}).get("rows",
                                        out["features"].shape[0]))
        out["weight"] = np.ones((rows, 1), np.float32)
    return out


def load_projected_entry(cache_dir: str, name: str) -> Optional[dict]:
    """Load a projected entry ({'features','target','weight','valid_mask'})
    or None on miss/failure.  Corrupt entries are removed (and journaled as
    `cache_fallback`); an injected `data.cache` read fault degrades to a
    miss without removal — the entry may be fine, the read path was not.
    The big features column comes back memory-mapped read-only — consumers
    concatenate or device_put it, which streams pages without an extra
    materializing copy."""
    entry = os.path.join(cache_dir, name)
    legacy = legacy_projected_path(entry)
    exists = os.path.isdir(entry) or (legacy != entry
                                      and os.path.exists(legacy))
    try:
        _probe("read", entry)
    except Exception as e:
        if exists:
            _journal_fallback(name, f"read fault: {e}")
        return None
    if os.path.isdir(entry):
        try:
            manifest = None
            mpath = os.path.join(entry, _MANIFEST)
            if os.path.exists(mpath):
                with open(mpath) as f:
                    manifest = json.load(f)
            out = _decode_projected(
                lambda k: os.path.exists(os.path.join(entry, k + ".npy")),
                lambda k: np.load(os.path.join(entry, k + ".npy"),
                                  mmap_mode=("r" if "features" in k
                                             else None)),
                manifest)
            if out is not None:
                return out
        except Exception as e:
            _journal_fallback(name, repr(e))
        else:
            _journal_fallback(name, "invalid entry layout")
        import shutil
        shutil.rmtree(entry, ignore_errors=True)  # corrupt: rebuildable
        return None
    if legacy != entry and os.path.exists(legacy):
        # r4-format npz entry: still serve it (no forced re-parse on
        # upgrade); new writes use the directory form
        try:
            with np.load(legacy) as z:
                out = _decode_projected(lambda k: k in z, lambda k: z[k],
                                        None)
            if out is not None:
                return out
        except Exception as e:
            _journal_fallback(name, repr(e))
        try:
            os.remove(legacy)
        except OSError:
            pass
    return None


def write_projected_entry(cache_dir: str, name: str, arrays: dict,
                          source: Optional[str] = None,
                          delimiter: str = "|",
                          version: Optional[int] = None,
                          supersedes: Optional[str] = None) -> None:
    """Atomic directory-of-npy write + prune of stale-source entries; never
    raises (cache is an accelerator only).  Atomicity: columns write into
    a tmp dir, then one rename publishes the entry — a concurrent writer
    losing the rename race just discards its tmp.

    At `version` >= 2 (the default) the entry stores the COMPACT disk
    encoding: target as uint8 when every value is an integer in [0, 255]
    (always true for Shifu's binary labels), an all-exactly-1.0 weight
    column elided entirely, and an `entry.json` manifest recording the
    format version, the reconstruction recipe, and the source identity
    the `cache` command lists/prunes by.  Both encodings reconstruct
    bit-exact float32 on load.  version=1 writes the legacy column layout
    (DataConfig.cache_format=1 interop pin) — still with a manifest, so
    the cache CLI can tell a pinned job's live entries from reclaimable
    manifest-less pre-v2 leftovers.  `supersedes` names one
    specific entry this write replaces (the v1->v2 upgrade passes the
    old-key entry) — removed after publish; the generic prune spares
    same-source entries of OTHER format generations so pinned-v1 and
    default-v2 jobs can share a cache dir without mutual eviction."""
    try:
        _probe("write", os.path.join(cache_dir, name))
        if version is None:
            version = CACHE_FORMAT_VERSION
        from .pipeline import target_u8_exact, weight_all_ones
        payload = dict(arrays)
        f = payload.get("features")
        rows = int(f.shape[0]) if f is not None else 0
        if f is not None and f.dtype == np.uint16:
            # uint16 features are bf16 bits (data/pipeline.bf16_bits)
            payload["features_bf16"] = f
            del payload["features"]
        # ONE stat of the source feeds both the manifest identity and the
        # cross-version prune spare set (a remote source pays a metadata
        # RPC per file_info — the caller already stat'ed once for the key)
        size = mtime_ns = None
        if source is not None:
            try:
                size, mtime_ns, _pp = _source_info(source)
            except OSError:
                pass
        keep = (frozenset(
            _sha1(f"{size}:{mtime_ns}:{delimiter}:{v}")[:16]
            for v in range(1, CACHE_FORMAT_VERSION + 1))
            if size is not None else frozenset())
        # EVERY generation gets a manifest: version + source identity are
        # what lets the `cache` command tell a pinned-v1 job's LIVE entries
        # (spared by prune) from manifest-less pre-v2 leftovers
        # (reclaimable).  Compact encoding stays v2-only — a v1 entry's
        # columns remain byte-compatible with the legacy reader, which
        # loads named `<col>.npy` members and ignores the extra file.
        manifest = {"version": version, "rows": rows,
                    "target_dtype": "float32", "weight_mode": "float32"}
        if version >= 2:
            t = payload.get("target")
            if t is not None and t.dtype != np.uint8 and target_u8_exact(t):
                payload["target"] = np.asarray(t).astype(np.uint8)
            if payload.get("target") is not None \
                    and payload["target"].dtype == np.uint8:
                manifest["target_dtype"] = "uint8"
            w = payload.get("weight")
            if w is not None and weight_all_ones(w):
                del payload["weight"]
                manifest["weight_mode"] = "elided"
        if source is not None:
            from . import fsio
            # absolute path, like the key hash (_source_info): the manifest
            # is read by the `cache` command from an arbitrary cwd — a
            # relative path recorded verbatim would classify every live
            # entry 'orphaned' (and --prune would delete the warm cache)
            # when the CLI runs from anywhere but the job's cwd
            if not fsio.is_remote(source):
                source = os.path.abspath(source)
            manifest.update(source=source, delimiter=delimiter,
                            source_size=size, source_mtime_ns=mtime_ns)
        os.makedirs(cache_dir, exist_ok=True)
        tmp = tempfile.mkdtemp(dir=cache_dir, suffix=".tmp")
        try:
            for k, v in payload.items():
                np.save(os.path.join(tmp, k + ".npy"),
                        np.ascontiguousarray(v))
            with open(os.path.join(tmp, _MANIFEST), "w") as mf:
                json.dump(manifest, mf)
            os.rename(tmp, os.path.join(cache_dir, name))
        finally:
            if os.path.exists(tmp):  # lost the rename race, or any error
                import shutil
                shutil.rmtree(tmp, ignore_errors=True)
        if supersedes and supersedes != name:
            target = os.path.join(cache_dir, supersedes)
            try:
                if os.path.isdir(target):
                    import shutil
                    shutil.rmtree(target, ignore_errors=True)
                elif os.path.exists(target):
                    os.remove(target)
            except OSError:
                pass
        _prune_superseded(cache_dir, name, keep)
    except Exception:  # never fail ingest for the accelerator
        pass


class AsyncEntryWriter:
    """Single background thread serializing projected-entry writes so the
    cold-ingest parse pool never stalls on cache disk IO — inflate+parse of
    file k+1 overlaps the v2 write of file k.
    Bounded (`max_pending`) so a slow cache device backpressures the pool
    instead of queueing the whole dataset; `close()` drains and joins.
    Write wall-seconds are reported through each submission's `record`
    callback (the ingest_report's per-file write_s)."""

    def __init__(self, max_pending: int = 4):
        import queue
        self._q: "queue.Queue" = queue.Queue(maxsize=max(max_pending, 1))
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="shifu-cache-writer")
        self._thread.start()

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            args, kwargs, record = item
            t0 = time.perf_counter()
            write_projected_entry(*args, **kwargs)  # never raises
            if record is not None:
                try:
                    record(time.perf_counter() - t0)
                except Exception:
                    pass

    def submit(self, cache_dir: str, name: str, arrays: dict,
               source: Optional[str] = None, delimiter: str = "|",
               version: Optional[int] = None,
               supersedes: Optional[str] = None,
               record: Optional[Callable[[float], None]] = None) -> None:
        self._q.put(((cache_dir, name, arrays),
                     {"source": source, "delimiter": delimiter,
                      "version": version, "supersedes": supersedes}, record))

    def close(self) -> None:
        """Drain every pending write and join the thread.  Idempotent."""
        if self._thread.is_alive():
            self._q.put(None)
            self._thread.join()


def _write_entry(cache_dir: str, name: str, arr: np.ndarray,
                 keep_metas: frozenset = frozenset()) -> None:
    """Atomic write + prune of superseded entries; never raises (the cache is
    an accelerator, not a correctness dependency — a read-only cache_dir just
    means every read parses)."""
    try:
        os.makedirs(cache_dir, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=cache_dir, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                np.save(f, np.ascontiguousarray(arr, dtype=np.float32))
            os.replace(tmp, os.path.join(cache_dir, name))
        finally:
            if os.path.exists(tmp):
                try:
                    os.remove(tmp)
                except OSError:
                    pass
        _prune_superseded(cache_dir, name, keep_metas)
    except OSError:
        pass


def _prune_superseded(cache_dir: str, fresh_name: str,
                      keep_metas: frozenset = frozenset()) -> None:
    """Remove entries for the same source path (path-hash prefix) whose
    META hash differs — a rewritten/re-mtimed source supersedes BOTH its
    raw `.npy` and every projected entry built from it, which would
    otherwise accumulate a dataset-sized orphan per rewrite.  Entries with
    the same meta but a different projection key stay (two jobs with
    different split params legitimately share the cache dir), as do
    entries in `keep_metas` — the same source state keyed by a different
    format generation, so a v1-pinned job (DataConfig.cache_format=1) and
    a default-v2 job sharing one cache dir never mutually evict (and
    perpetually re-parse) each other's live entries."""
    parts = fresh_name.rsplit(".", 1)[0].split("-")
    if len(parts) < 2:
        return
    path_part, meta_part = parts[0], parts[1]
    spare = keep_metas | {meta_part}
    try:
        for existing in os.listdir(cache_dir):
            if not existing.endswith((".npy", ".npz", ".npd")):
                continue
            if existing == fresh_name:
                continue
            eparts = existing.rsplit(".", 1)[0].split("-")
            if len(eparts) < 2 or eparts[0] != path_part:
                continue
            if eparts[1] in spare:
                continue  # same source state: raw + projections coexist
            target = os.path.join(cache_dir, existing)
            try:
                if os.path.isdir(target):
                    import shutil
                    shutil.rmtree(target, ignore_errors=True)
                else:
                    os.remove(target)
            except OSError:
                pass
    except OSError:
        pass


# ---------------------------------------------------------------------------
# Cache inspection (`shifu-tpu-torch cache <dir>` — launcher/cli.py)
# ---------------------------------------------------------------------------

# a *.tmp / .building-* entry younger than this may belong to a LIVE
# writer (cold ingest, out-of-core consolidation) — scan/prune leave it
# alone; a crashed writer's leftover ages past it and becomes reclaimable
TMP_GRACE_SECONDS = 3600.0


def _tree_bytes(path: str) -> int:
    total = 0
    for root, _dirs, files in os.walk(path):
        for f in files:
            try:
                total += os.path.getsize(os.path.join(root, f))
            except OSError:
                pass
    return total


def _classify_entry(cache_dir: str, name: str) -> Optional[dict]:
    """One scan record: {name, tier, version, bytes, source, status}.
    status: ok | legacy (pre-v2 format) | stale (source changed) |
    orphaned (source gone) | corrupt | tmp."""
    full = os.path.join(cache_dir, name)
    rec = {"name": name, "tier": None, "version": None,
           "bytes": 0, "source": None, "status": "ok"}
    # ONLY our own write-side temp names (mkdtemp/mkstemp suffix=".tmp",
    # outofcore's ".building-" prefix) classify as tmp — any other
    # dotfile/unknown name is skipped entirely: never listed, never
    # pruned (a `.nfsXXXX` placeholder or a user's `.gitignore` is not
    # ours to delete).  A tmp entry younger than the grace window is
    # skipped too: it may be a LIVE writer's in-flight dir, and pruning
    # it mid-build would fail the publish rename (or an out-of-core
    # memmap write) of a healthy concurrent job.
    if name.endswith(".tmp") or name.startswith(".building-"):
        try:
            age_s = time.time() - os.path.getmtime(full)
        except OSError:
            age_s = None
        if age_s is not None and age_s < TMP_GRACE_SECONDS:
            return None  # possibly live: neither listed nor pruned
        rec.update(tier="tmp", status="tmp",
                   bytes=_tree_bytes(full) if os.path.isdir(full)
                   else (os.path.getsize(full)
                         if os.path.exists(full) else 0))
        return rec
    if name.startswith("."):
        return None
    if name.startswith("dataset-") and os.path.isdir(full):
        rec.update(tier="dataset", bytes=_tree_bytes(full))
        try:
            with open(os.path.join(full, "meta.json")) as f:
                meta = json.load(f)
            rec["version"] = int(meta.get("version", 1))
            files = meta.get("files") or []
            # entry key = source state at build time, so a rewritten
            # source supersedes the dir: compare the recorded per-file
            # (size, mtime_ns) when present (older metas lack it)
            state = meta.get("file_state") or [None] * len(files)
            rec["source"] = files[0] if len(files) == 1 else \
                (f"{len(files)} files" if files else None)
            stale = False
            for p, fs in zip(files, state):
                if "://" in p:
                    continue
                if not os.path.exists(p):
                    rec["status"] = "orphaned"
                    break
                if fs and fs[0] is not None:
                    st = os.stat(p)
                    if (fs[0] != st.st_size
                            or fs[1] not in (None, st.st_mtime_ns)):
                        stale = True
            else:
                if rec["version"] < 2:
                    # pre-v2 consolidated entries key differently and can
                    # never be served again — reclaimable
                    rec["status"] = "legacy"
                elif stale:
                    rec["status"] = "stale"
        except (OSError, ValueError):
            rec["status"] = "corrupt"
        return rec
    if name.endswith(".npd") and os.path.isdir(full):
        rec.update(tier="projected", bytes=_tree_bytes(full))
        mpath = os.path.join(full, _MANIFEST)
        if not os.path.exists(mpath):
            rec.update(version=1, status="legacy")
            return rec
        try:
            with open(mpath) as f:
                manifest = json.load(f)
            rec["version"] = int(manifest.get("version", 2))
            src = manifest.get("source")
            rec["source"] = src
            if src and "://" not in src:
                if not os.path.exists(src):
                    rec["status"] = "orphaned"
                else:
                    st = os.stat(src)
                    if (manifest.get("source_size") not in (None, st.st_size)
                            or manifest.get("source_mtime_ns")
                            not in (None, st.st_mtime_ns)):
                        rec["status"] = "stale"
        except (OSError, ValueError):
            rec["status"] = "corrupt"
        return rec
    if name.endswith(".npz"):
        rec.update(tier="projected", version=1, status="legacy",
                   bytes=os.path.getsize(full) if os.path.exists(full)
                   else 0)
        return rec
    if name.endswith(".npy"):
        # raw entries carry no manifest; the content key in the NAME is the
        # only identity (version indistinguishable from the outside)
        rec.update(tier="raw",
                   bytes=os.path.getsize(full) if os.path.exists(full)
                   else 0)
        return rec
    return None  # not a cache artifact: never touched


def scan_cache(cache_dir: str) -> list[dict]:
    """Every cache artifact under `cache_dir`, classified — the data
    source for the `cache` command.  Unknown files are skipped (never listed,
    never pruned)."""
    out = []
    for name in sorted(os.listdir(cache_dir)):
        rec = _classify_entry(cache_dir, name)
        if rec is not None:
            out.append(rec)
    return out


PRUNE_STATUSES = ("tmp", "legacy", "stale", "orphaned", "corrupt")


def prune_cache(cache_dir: str,
                entries: Optional[list[dict]] = None) -> list[dict]:
    """Remove superseded/orphaned artifacts (`cache --prune`):
    leftover tmp dirs, legacy pre-v2 entries (their sources re-cache as v2
    on the next touch), entries whose recorded source changed or vanished,
    and corrupt entries.  Returns the records removed."""
    import shutil
    if entries is None:
        entries = scan_cache(cache_dir)
    removed = []
    for rec in entries:
        if rec["status"] not in PRUNE_STATUSES:
            continue
        full = os.path.join(cache_dir, rec["name"])
        try:
            if os.path.isdir(full):
                shutil.rmtree(full, ignore_errors=True)
            elif os.path.exists(full):
                os.remove(full)
        except OSError:
            pass
        if not os.path.exists(full):  # count only what actually left disk
            removed.append(rec)
    return removed
