"""Out-of-core datasets: train a partition bigger than RAM (the port's
copy of shifu_tpu/data/outofcore.py; the same consolidated layout, keys and
row order, byte for byte).

The input files are consolidated once into on-disk projected arrays
(features/target/weight, train and valid pre-split) and memory-mapped
thereafter: `TabularDataset` holds read-only `np.memmap`s, the staged tier
gathers whole batches from them, and the feeder overlaps that disk IO with
the card's compute.  The build rides the per-file projected v2 entries of
`cache.py`: it makes sure each file's entry exists (parsing the missing
ones through the ingest pool), then copies memory-mapped slices of the
already-projected, already-wire-format columns into the consolidated
arrays.  Features consolidate in the wire dtype (int8, or bf16 as its
uint16 bits); a uint8 target widens into the float32 column exactly, an
elided weight column broadcasts 1.0.

Layout per consolidated entry (a directory named by a content key):
    meta.json              row counts + dtypes + the build inputs
    train_features.npy     (Ntr, F) wire dtype   written via open_memmap
    train_target.npy       (Ntr, H) float32
    train_weight.npy       (Ntr, 1) float32
    valid_features.npy     (Nva, F)
    valid_target.npy       (Nva, H)
    valid_weight.npy       (Nva, 1)

The content key (`_entry_key`) covers each source file's cache identity
(path, size, mtime), the column projection, the split, the shuffle seed,
the wire format and OUT_OF_CORE_VERSION: any change rebuilds.  Builds are
atomic (a temporary directory renamed into place), so a killed build never
leaves a servable half-entry.

Row order: the in-RAM loader applies one global row permutation to the
training partition; scattering rows across a disk file would be random IO,
so here the write permutes at chunk granularity across files (plus a
shuffle within each chunk), seeded as the JAX package seeds it, and the
staged tier's per-epoch batch order sits on top.  Validation rows keep
file order, as in the in-RAM loader.  Under a pod each host consolidates
its own file shard (`pipeline.host_shard_assignment` at epoch 0) into
`dataset-<key>-h<host>of<hosts>`, the JAX package's name.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile
import time

import numpy as np

from ..config.schema import DataConfig, DataSchema
from . import cache as cache_mod

# v2: consolidated arrays ride the cache-v2 projected entries and store
# features in the wire dtype (see module docstring)
OUT_OF_CORE_VERSION = 2

# rows per write chunk: big enough for near-sequential IO, small enough that
# a chunk is a trivial RAM footprint (256k rows x 1000 cols x 4B = 1 GB max;
# typical tabular widths are far less)
_CHUNK_ROWS = 262_144


def _entry_key(schema: DataSchema, data: DataConfig,
               my_files: list[tuple[int, str]], feature_dtype: str) -> str:
    h = hashlib.sha1()
    h.update(f"v{OUT_OF_CORE_VERSION}".encode())
    for file_idx, path in my_files:
        # per-file cache identity = content identity (size+mtime+delimiter)
        name = cache_mod.cache_entry_name(path, data.delimiter)
        if name is None:  # no trustworthy metadata: consolidation unsafe
            raise ValueError(
                f"cannot build out-of-core dataset: {path} has no (size, "
                f"mtime) metadata to key the consolidated cache on")
        h.update(f"{file_idx}:{name};".encode())
    h.update(json.dumps({
        "sel": list(schema.selected_indices),
        "tgt": list(schema.all_target_indices),
        "wgt": schema.weight_index,
        "valid_ratio": data.valid_ratio,
        "split_seed": data.split_seed,
        "shuffle_seed": data.shuffle_seed,
        "feature_dtype": feature_dtype,
    }, sort_keys=True).encode())
    return h.hexdigest()[:24]


_PARTS = ("features", "target", "weight")


def _open_split(entry_dir: str, prefix: str) -> tuple:
    # bf16 features stay their uint16 bits, the port's bf16 representation
    return tuple(np.load(os.path.join(entry_dir, f"{prefix}_{part}.npy"),
                         mmap_mode="r") for part in _PARTS)


def load_datasets_out_of_core(schema: DataSchema, data: DataConfig,
                              host_index: int = 0, num_hosts: int = 1,
                              feature_dtype: str = "float32"):
    """(train, valid) TabularDatasets backed by read-only memmaps, features
    already in the wire dtype.

    Requires a cache directory (DataConfig.cache_dir or SHIFU_TPU_DATA_CACHE)
    — the consolidated arrays have to live somewhere durable.
    """
    from .pipeline import (TabularDataset, host_shard_assignment,
                           source_files)  # import cycle

    cache_dir = cache_mod.resolve_cache_dir(data.cache_dir)
    if cache_dir is None:
        raise ValueError(
            "out-of-core datasets need a cache directory: set "
            "DataConfig.cache_dir or SHIFU_TPU_DATA_CACHE")
    files = source_files(data)
    own = set(host_shard_assignment(
        len(files), host_index, num_hosts, seed=data.shuffle_seed, epoch=0,
        mode=data.host_shard))
    mine = [(i, p) for i, p in files if i in own]
    key = _entry_key(schema, data, mine, feature_dtype)
    entry_dir = os.path.join(cache_dir,
                             f"dataset-{key}-h{host_index}of{num_hosts}")
    if not os.path.exists(os.path.join(entry_dir, "meta.json")):
        _build_entry(entry_dir, schema, data, mine, feature_dtype, cache_dir,
                     host_index, num_hosts)
    train = TabularDataset(*_open_split(entry_dir, "train"))
    valid = TabularDataset(*_open_split(entry_dir, "valid"))
    return train, valid


class _EntryColumns:
    """Read-only mmap handles over one projected v2 entry's columns plus
    its reconstruction recipe — the build's zero-copy source.  Features
    come back in their STORAGE dtype (bf16 as uint16 bits: the consolidated
    file stores the same bits, so copies are native-speed u16 moves);
    `weight` is None when the entry elided an all-ones column."""

    def __init__(self, entry_dir: str):
        feat = os.path.join(entry_dir, "features.npy")
        if not os.path.exists(feat):
            feat = os.path.join(entry_dir, "features_bf16.npy")
        self.features = np.load(feat, mmap_mode="r")
        self.target = np.load(os.path.join(entry_dir, "target.npy"),
                              mmap_mode="r")
        wpath = os.path.join(entry_dir, "weight.npy")
        self.weight = np.load(wpath, mmap_mode="r") \
            if os.path.exists(wpath) else None
        self.valid_mask = np.asarray(
            np.load(os.path.join(entry_dir, "valid_mask.npy")))
        self.rows = int(self.features.shape[0])


def _ensure_entries(mine, schema: DataSchema, data: DataConfig,
                    feature_dtype: str, cache_dir: str) -> list[_EntryColumns]:
    """Make sure every source file has a projected v2 entry on disk and
    return mmap handles over them, parsing missing files through the
    bounded ingest pool (parallel cold ingest; parsed arrays are dropped
    immediately — only the on-disk entry and its mmap survive, so the
    build's peak RAM is pool_width in-flight files, never the shard).

    Raises when an entry could not be written: the chunked copy reads each
    entry once per chunk, which is only sane when those reads are mmap hits
    — degrading to a full re-parse per chunk would multiply parse cost by
    the chunk count with no warning.
    """
    from . import pipeline as pipe_mod

    version = pipe_mod.resolved_cache_format(data)

    def entry_path(file_idx: int, path: str) -> str:
        name = cache_mod.projected_entry_name(
            path, data.delimiter, file_idx, schema, data.valid_ratio,
            data.split_seed, feature_dtype, version=version)
        if name is None:
            raise ValueError(
                f"cannot build out-of-core dataset: {path} has no (size, "
                f"mtime) metadata to key the per-file cache on")
        return os.path.join(cache_dir, name)

    missing = [(pos, item) for pos, item in enumerate(mine)
               if not os.path.isdir(entry_path(*item))]
    if missing:
        # default pool of 2 (not cpu_count): the out-of-core regime is
        # exactly where width x file-size transients threaten host RAM;
        # ingest_workers (or the legacy read_threads spelling, same
        # fallback chain as pipeline.ingest_pool_width) raises it
        # explicitly
        width = data.ingest_workers or data.read_threads \
            or min(2, len(missing))
        width = max(1, min(width, len(missing)))
        threaded = width > 1
        from . import native_parser
        pt = native_parser.pool_parser_threads(width) if threaded else None
        stats: list = []
        t0 = time.perf_counter()

        def build_one(item):
            # writes the v2 entry synchronously (writer=None); the parsed
            # arrays are discarded — the mmap below is the real product
            pipe_mod._load_one_projected(item, schema, data, feature_dtype,
                                         threaded, parser_threads=pt,
                                         stats=stats)

        if threaded:
            from concurrent.futures import ThreadPoolExecutor
            with ThreadPoolExecutor(max_workers=width) as pool:
                list(pool.map(lambda pi: build_one(pi[1]), missing))
        else:
            for _pos, item in missing:
                build_one(item)
        pipe_mod._emit_ingest_report(stats, width,
                                     time.perf_counter() - t0,
                                     mode="outofcore")
    def materialize_dir(entry: str, path: str) -> None:
        """A served-but-not-directory entry (a legacy `.npz` under a
        pinned cache_format=1 — _load_one_projected serves it without a
        rewrite) is re-published in the directory form the chunk copy
        mmaps; a no-op when nothing loads."""
        name = os.path.basename(entry)
        hit = cache_mod.load_projected_entry(cache_dir, name)
        if hit is not None and not os.path.isdir(entry):
            cache_mod.write_projected_entry(
                cache_dir, name, hit, source=path,
                delimiter=data.delimiter, version=version)

    def open_or_rebuild(file_idx: int, path: str) -> _EntryColumns:
        entry = entry_path(file_idx, path)
        for attempt in (0, 1):
            if not os.path.isdir(entry):
                materialize_dir(entry, path)
            if os.path.isdir(entry):
                try:
                    return _EntryColumns(entry)
                except Exception:
                    # damaged columns (truncated npy, concurrent prune):
                    # the module contract is that every failure path falls
                    # back to re-parse — drop the entry and rebuild once
                    if attempt:
                        raise
                    shutil.rmtree(entry, ignore_errors=True)
            if attempt:
                break
            pipe_mod._load_one_projected((file_idx, path), schema, data,
                                         feature_dtype, False)
        raise OSError(
            f"out-of-core build needs a writable cache with space for "
            f"the projected copy of every source file, but caching "
            f"{path!r} failed (cache_dir full or unwritable?)")

    return [open_or_rebuild(file_idx, path) for file_idx, path in mine]


def _build_entry(entry_dir, schema: DataSchema, data: DataConfig, mine,
                 feature_dtype: str, cache_dir: str, host_index: int = 0,
                 num_hosts: int = 1) -> None:
    entries = _ensure_entries(mine, schema, data, feature_dtype, cache_dir)
    counts = [e.rows for e in entries]
    masks = [e.valid_mask for e in entries]
    # exclusive prefix: prefixes[i][r] = valid rows before row r — lets the
    # chunk copy find a chunk's valid write offset in O(1) instead of
    # re-summing a boolean prefix per chunk (quadratic at 1e9-row scale)
    prefixes = [np.concatenate([[0], np.cumsum(m, dtype=np.int64)])
                for m in masks]
    n_valid = int(sum(int(m.sum()) for m in masks))
    n_train = int(sum(counts)) - n_valid
    f_dim = len(schema.selected_indices)
    t_dim = len(schema.all_target_indices)
    feat_store = entries[0].features.dtype if entries else np.dtype(np.float32)
    feat_logical = ("bfloat16" if feature_dtype == "bfloat16"
                    else str(feat_store))

    # chunk write plan: (file pos, row start, row stop) per chunk, order
    # permuted across the whole shard for train decorrelation
    chunks = []
    for pos, n in enumerate(counts):
        for start in range(0, n, _CHUNK_ROWS):
            chunks.append((pos, start, min(start + _CHUNK_ROWS, n)))
    rng = np.random.default_rng(np.random.PCG64(data.shuffle_seed ^ 0xD15C))
    chunk_order = rng.permutation(len(chunks))

    parent = os.path.dirname(entry_dir) or "."
    os.makedirs(parent, exist_ok=True)
    tmp_dir = tempfile.mkdtemp(dir=parent, prefix=".building-")
    try:
        def alloc(prefix, n_rows, dim, dtype=np.float32):
            return np.lib.format.open_memmap(
                os.path.join(tmp_dir, prefix), mode="w+",
                dtype=dtype, shape=(n_rows, dim))

        out = {
            "train": (alloc("train_features.npy", n_train, f_dim, feat_store),
                      alloc("train_target.npy", n_train, t_dim),
                      alloc("train_weight.npy", n_train, 1)),
            "valid": (alloc("valid_features.npy", n_valid, f_dim, feat_store),
                      alloc("valid_target.npy", n_valid, t_dim),
                      alloc("valid_weight.npy", n_valid, 1)),
        }
        # valid rows keep file order (== in-RAM loader); compute each file's
        # valid write offset up front
        valid_offsets = np.concatenate(
            [[0], np.cumsum([int(m.sum()) for m in masks])])
        train_cursor = 0
        last_touch = time.monotonic()
        for ci in chunk_order:
            # a TB-scale copy can outlive the prune grace window
            # (cache.TMP_GRACE_SECONDS keys liveness off the dir mtime,
            # which open_memmap set at alloc time): re-touch the building
            # dir periodically so a concurrent `cache --prune` never
            # reclaims a live build mid-copy
            if time.monotonic() - last_touch > 300:
                try:
                    os.utime(tmp_dir)
                except OSError:
                    pass
                last_touch = time.monotonic()
            pos, start, stop = chunks[ci]
            e = entries[pos]
            # slices of the already-projected, already-wire-format entry —
            # a uint8 compact target widens into the f32 column bit-exactly
            # on assignment; an elided weight broadcasts 1.0
            feats = e.features[start:stop]
            tgt = e.target[start:stop]
            wgt = e.weight[start:stop] if e.weight is not None else None
            vmask = masks[pos][start:stop]
            tmask = ~vmask
            n_tr = int(tmask.sum())
            if n_tr:
                order = rng.permutation(n_tr)  # within-chunk row shuffle
                sl = slice(train_cursor, train_cursor + n_tr)
                out["train"][0][sl] = feats[tmask][order]
                out["train"][1][sl] = tgt[tmask][order]
                if wgt is not None:
                    out["train"][2][sl] = wgt[tmask][order]
                else:
                    out["train"][2][sl] = 1.0
                train_cursor += n_tr
            n_va = int(vmask.sum())
            if n_va:
                # file-ordered position: offset of this file + valid rows
                # before `start` within it (O(1) via the prefix table)
                before = int(prefixes[pos][start])
                sl = slice(valid_offsets[pos] + before,
                           valid_offsets[pos] + before + n_va)
                out["valid"][0][sl] = feats[vmask]
                out["valid"][1][sl] = tgt[vmask]
                if wgt is not None:
                    out["valid"][2][sl] = wgt[vmask]
                else:
                    out["valid"][2][sl] = 1.0
        for arrs in out.values():
            for a in arrs:
                a.flush()
        del out
        # absolute paths + per-file (size, mtime_ns) at build time: the
        # consolidated dir is keyed on source state, so a rewritten source
        # orphans it — without the recorded state the `cache` command could
        # never tell a superseded dataset dir (stale, reclaimable) from a
        # live one, leaking a dataset-sized dir per source rewrite
        file_state = []
        file_paths = []
        for _idx, p in mine:
            try:
                fsize, fmtime, _pp = cache_mod._source_info(p)
            except OSError:
                fsize = fmtime = None
            file_paths.append(p if "://" in p else os.path.abspath(p))
            file_state.append([fsize, fmtime])
        meta = {
            "version": OUT_OF_CORE_VERSION,
            "n_train": n_train, "n_valid": n_valid,
            "feature_dim": f_dim, "target_dim": t_dim,
            # logical vs storage dtype: bf16 consolidates as its uint16
            # bits (npy has no bf16) and is viewed back at open time
            "features_dtype": feat_logical,
            "wire_feature_dtype": feature_dtype,
            "host_index": int(host_index), "num_hosts": int(num_hosts),
            "files": file_paths,
            "file_state": file_state,
        }
        with open(os.path.join(tmp_dir, "meta.json"), "w") as f:
            json.dump(meta, f, indent=1)
        try:
            os.rename(tmp_dir, entry_dir)  # atomic publish
        except OSError:
            # either a concurrent builder published first (theirs is
            # equivalent) or the rename genuinely failed — only swallow if a
            # servable entry actually exists
            if not os.path.exists(os.path.join(entry_dir, "meta.json")):
                raise
            shutil.rmtree(tmp_dir, ignore_errors=True)
    except BaseException:
        shutil.rmtree(tmp_dir, ignore_errors=True)
        raise
