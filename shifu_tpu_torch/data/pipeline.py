"""Dataset, batch pipeline and input plane of the training path (port of
the single-host part of shifu_tpu/data/pipeline.py).

Files -> parse (native or numpy tier) -> projected numpy columns -> the
train/valid split -> static-shape batches.  The features can be stored in
the wire dtype at parse time (`feature_dtype` "int8c{clip}" or
"bfloat16"), and the host-to-card wire casts each batch (`wire_cast_fn`):
int8 features on the grid of `wire_params`, u8 targets and an elided
all-ones weight column.  Float32 features under a bfloat16 wire are cast
on the card (`train/loop.py`).
Epoch order is a pure function of (seed, epoch) through numpy's PCG64, the
same stream as the JAX package's, so both train on the same batches
(`epoch_order_digest` fingerprints it, equal to the JAX package's).

The input plane: `StreamingLoader` trains the first epoch on blocks as the
files parse; `staged_epoch_blocks` feeds the staged tier's host-fed
(nb, B, ...) blocks; `EpochFeeder`, one persistent pair of threads
(assembly, then placement), runs ahead across epochs for the staged and
per-batch tiers.  Its placement stage (`train/loop.py` builds it) copies
from pinned host buffers on a CUDA stream of its own.

Ingest goes through the parse-once cache (`cache.py`, v2 entries) when a
cache dir is set: `projected_cache_complete` says when every file has an
entry (the cache is "hot", and the loop loads instead of streaming);
`data.out_of_core` loads memory-mapped consolidated arrays
(`outofcore.py`).  bf16 features are held as their uint16 bits
(`bf16_bits`; numpy has no bfloat16), which the placer views as bfloat16
on the card.

The pod data plane: under a pod (launcher/pod.py) each host reads only its
slice of the source files, `host_file_shard`, from the one pure formula
`host_shard_assignment` (a function of the file count, the host, the
number of hosts, the seed, the epoch and the mode), which `load_datasets`,
`StreamingLoader`, `projected_cache_complete` and the out-of-core build
all derive their shard from.  Row ids `(file_idx << 40) + row` and the
train/valid split stay keyed on the global file index, so no row changes
its id with the host that reads it.  `interleaved_epoch_order` is the
pod's global batch order, which one process can replay.
"""

from __future__ import annotations

import dataclasses
import os
import queue
import threading
import time
from typing import Callable, Iterator, Optional

import numpy as np

from .. import obs
from ..config.schema import DataConfig, DataSchema
from . import reader, split


@dataclasses.dataclass
class TabularDataset:
    """Feature/target/weight arrays for one partition (train or valid)."""

    # (N, F) float32, int8 on the wire grid, or uint16 bf16 bits
    features: np.ndarray
    target: np.ndarray    # (N, H) float32
    weight: np.ndarray    # (N, 1) float32

    @property
    def num_rows(self) -> int:
        return int(self.features.shape[0])

    @property
    def num_features(self) -> int:
        return int(self.features.shape[1])

    def take(self, idx: np.ndarray) -> "TabularDataset":
        return TabularDataset(self.features[idx], self.target[idx],
                              self.weight[idx])


def bf16_bits(x: np.ndarray) -> np.ndarray:
    """float32 -> the uint16 bits of bfloat16, rounded to nearest even (the
    port's bf16 features: numpy has no bfloat16, and these are the bits
    the JAX package's `ml_dtypes.bfloat16` cast stores)."""
    import torch
    t = torch.from_numpy(np.ascontiguousarray(x, np.float32))
    return t.to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)


def features_f32(f: np.ndarray) -> np.ndarray:
    """Features as float32: uint16 (bf16 bits) widen exactly, anything
    else casts."""
    if f.dtype == np.uint16:
        return (np.asarray(f).astype(np.uint32) << 16).view(np.float32)
    return np.asarray(f, np.float32)


def resolved_cache_format(data: DataConfig) -> int:
    """The cache entry format generation this job writes and keys by:
    DataConfig.cache_format, 0 meaning the current CACHE_FORMAT_VERSION."""
    from . import cache as cache_lib
    return int(data.cache_format) or cache_lib.CACHE_FORMAT_VERSION


def _ingest_seconds():
    return obs.counter("ingest_seconds_total",
                       "cold-ingest wall seconds by phase")


def _write_projected(writer, cache_dir: str, name: str, arrays: dict,
                     source: str, delimiter: str, version: int,
                     rec: Optional[dict],
                     supersedes: Optional[str] = None) -> None:
    """One v2 entry write, through the async writer (cold ingest: the next
    file's parse overlaps this write) or inline; either way its wall lands
    in the ingest report's per-file write_s and the `write` phase."""
    from . import cache as cache_lib
    wsec = _ingest_seconds()

    def record(dt: float) -> None:
        wsec.inc(dt, phase="write")
        if rec is not None:
            rec["write_s"] = rec.get("write_s", 0.0) + dt

    if writer is not None:
        writer.submit(cache_dir, name, arrays, source=source,
                      delimiter=delimiter, version=version,
                      supersedes=supersedes, record=record)
        return
    t0 = time.perf_counter()
    cache_lib.write_projected_entry(cache_dir, name, arrays, source=source,
                                    delimiter=delimiter, version=version,
                                    supersedes=supersedes)
    record(time.perf_counter() - t0)


def _load_one_projected(item: tuple[int, str], schema: DataSchema,
                        data: DataConfig, feature_dtype: str,
                        threaded: bool, parser_threads: Optional[int] = None,
                        stats: Optional[list] = None, writer=None
                        ) -> tuple[dict, np.ndarray]:
    """Parse + project + split + wire-cast one file, the cache tier first.

    With a cache dir, a hit on the file's projected v2 entry replaces the
    parse, projection, split and cast with one mmap-backed load; a v1
    entry under the old key serves once and is rewritten as v2.  A miss
    parses (the raw matrix dies here) and writes the entry.  `stats`
    collects the per-file ingest-report record; `writer` (an
    AsyncEntryWriter) overlaps entry writes with the pool's parses."""
    from . import cache as cache_lib
    if feature_dtype not in ("float32", "bfloat16") \
            and not feature_dtype.startswith("int8"):
        raise ValueError(f"feature_dtype {feature_dtype!r} not supported; "
                         "expected float32, bfloat16 or int8c<clip>")
    file_idx, path = item
    cache_dir = cache_lib.resolve_cache_dir(data.cache_dir)
    version = resolved_cache_format(data)
    rec = {"file": os.path.basename(path), "tier": "parse", "rows": 0,
           "inflate_s": 0.0, "parse_s": 0.0, "write_s": 0.0}
    if stats is not None:
        stats.append(rec)
    isec = _ingest_seconds()
    name = None
    if cache_dir is not None:
        name = cache_lib.projected_entry_name(
            path, data.delimiter, file_idx, schema, data.valid_ratio,
            data.split_seed, feature_dtype, version=version)
        if name is not None:
            t_load = time.perf_counter()
            hit = cache_lib.load_projected_entry(cache_dir, name)
            upgraded = False
            v1name = None
            if hit is None and version >= 2:
                v1name = cache_lib.projected_entry_name(
                    path, data.delimiter, file_idx, schema, data.valid_ratio,
                    data.split_seed, feature_dtype, version=1)
                if v1name is not None:
                    hit = cache_lib.load_projected_entry(cache_dir, v1name)
                    upgraded = hit is not None
            if hit is not None:
                isec.inc(time.perf_counter() - t_load, phase="cache_load")
                mask = hit.pop("valid_mask")
                rec.update(tier="cache_v1" if upgraded else "cache",
                           rows=int(hit["features"].shape[0]))
                obs.counter("data_cache_hits_total",
                            "projected-cache hits (one entry load "
                            "replaced parse+project+split+cast)").inc()
                obs.counter("data_rows_read_total",
                            "rows ingested into datasets").inc(
                    int(hit["features"].shape[0]), source="cache")
                if upgraded:
                    obs.counter("data_cache_upgraded_total",
                                "legacy v1 projected entries rewritten "
                                "as v2").inc()
                    _write_projected(writer, cache_dir, name,
                                     {**hit, "valid_mask": mask}, path,
                                     data.delimiter, version, rec,
                                     supersedes=v1name)
                return hit, mask
        obs.counter("data_cache_misses_total",
                    "projected-cache misses (full parse path taken)").inc()
    t_parse = time.perf_counter()
    if parser_threads is None and threaded:
        parser_threads = 1
    # a raw-entry hit skips read_file: this sentinel tells it apart from a
    # stale record of this thread's previous parse
    reader._note_io("raw_cache", 0.0, 0.0, 0)
    # write=False when a projected entry will land: the v2 entry is the
    # warm-start intermediate, a raw f32 copy beside it would cost 4x its
    # bytes again
    rows = cache_lib.read_file_cached(
        path, data.delimiter, cache_dir=data.cache_dir,
        parser_threads=parser_threads, write=(name is None))
    parse_wall = time.perf_counter() - t_parse
    io_stats = reader.last_io_stats()
    rec["rows"] = int(rows.shape[0])
    if io_stats.get("tier") == "raw_cache":
        rec["tier"] = "raw_cache"
        isec.inc(parse_wall, phase="cache_load")
    else:
        inflate_s = min(max(io_stats.get("inflate_s", 0.0), 0.0),
                        parse_wall)
        rec["parse_s"] = round(parse_wall - inflate_s, 6)
        rec["inflate_s"] = round(inflate_s, 6)
        rec["bytes"] = int(io_stats.get("source_bytes", 0))
        rec["parser"] = io_stats.get("tier")
        isec.inc(inflate_s, phase="inflate")
        isec.inc(parse_wall - inflate_s, phase="parse")
        obs.counter("ingest_source_bytes_total",
                    "source (compressed) bytes cold ingest read").inc(
            int(io_stats.get("source_bytes", 0)))
    obs.histogram("data_file_parse_seconds",
                  "per-file parse (or raw-cache load) latency").observe(
        parse_wall)
    obs.counter("data_files_read_total", "data files parsed").inc()
    obs.counter("data_rows_read_total",
                "rows ingested into datasets").inc(
        int(rows.shape[0]), source="parse")
    obs.counter("data_bytes_read_total",
                "parsed matrix bytes produced by ingest").inc(
        int(rows.nbytes))
    cols = reader.project_columns(rows, schema)
    if feature_dtype == "bfloat16":
        cols["features"] = bf16_bits(cols["features"])
    elif feature_dtype.startswith("int8"):
        # quantize once at load: the grid is static (wire_params), so this
        # equals quantizing at every batch, at a quarter of the host RAM
        scale, offset = wire_params(schema, data)
        cols["features"] = wire_quantize(cols["features"], scale, offset)
    n = cols["features"].shape[0]
    row_ids = ((np.uint64(file_idx) << np.uint64(40))
               + np.arange(n, dtype=np.uint64))
    _, valid_mask = split.train_valid_mask(row_ids, data.valid_ratio,
                                           data.split_seed)
    if cache_dir is not None and name is not None:
        _write_projected(writer, cache_dir, name,
                         {**cols, "valid_mask": valid_mask}, path,
                         data.delimiter, version, rec)
    return cols, valid_mask


def _emit_ingest_report(stats: list, pool_width: int, wall_s: float,
                        mode: str, host_index: int = 0) -> None:
    """One `ingest_report` journal event per completed ingest (the JAX
    package's keys): the pool width, the per-phase cost split, which tier
    served each file and a per-file table of at most 32 (each parsed
    file's `parser` tier beside the JAX package's fields).  When the numpy
    tier parsed because the native parser could not be built,
    `native_parser_unavailable` journals the reason.  Never raises."""
    try:
        from . import native_parser
        files = sorted(stats, key=lambda r: r["file"])
        tiers: dict[str, int] = {}
        for r in files:
            tiers[r["tier"]] = tiers.get(r["tier"], 0) + 1
        per_file = [
            {k: (round(v, 6) if isinstance(v, float) else v)
             for k, v in r.items()} for r in files[:32]]
        obs.event(
            "ingest_report", mode=mode, files=len(files),
            pool_width=int(pool_width), wall_s=round(wall_s, 6),
            rows=int(sum(r["rows"] for r in files)),
            parse_s=round(sum(r["parse_s"] for r in files), 6),
            inflate_s=round(sum(r["inflate_s"] for r in files), 6),
            write_s=round(sum(r["write_s"] for r in files), 6),
            source_bytes=int(sum(r.get("bytes", 0) for r in files)),
            host_index=int(host_index), tiers=tiers, per_file=per_file,
            per_file_truncated=len(files) > 32)
        reason = native_parser.unavailable_reason()
        if reason is not None and any(r.get("parser") == "numpy"
                                      for r in files):
            # the numpy tier served: say why the native one could not
            obs.event("native_parser_unavailable", reason=str(reason)[:500])
    except Exception:
        pass  # telemetry must never fail the ingest it measures


def source_files(data: DataConfig) -> list[tuple[int, str]]:
    """(file index, path) in config order; the index keys the row ids of
    the train/valid split, so every entry point must agree on it."""
    return list(enumerate(f for p in data.paths
                          for f in reader.list_data_files(p)))


def shard_rotation(seed: int, epoch: int, num_hosts: int) -> int:
    """The rotation of the host<->file round-robin for `epoch`: a pure
    function of (seed, epoch, num_hosts), so every host (one rejoining
    after an elastic reshape too) derives it alone.  Epoch 0 is pinned to
    0, the fixed round-robin, so cache and out-of-core keys stay valid."""
    if num_hosts <= 1 or epoch <= 0:
        return 0
    rng = np.random.default_rng(
        np.random.PCG64([int(seed), int(epoch), int(num_hosts), 0x51A4D]))
    return int(rng.integers(num_hosts))


def host_shard_assignment(n_files: int, host_index: int, num_hosts: int,
                          *, seed: int = 0, epoch: int = 0,
                          mode: str = "static") -> list[int]:
    """The global file indices host `host_index` owns for `epoch`: the one
    shard formula of the pod data plane.  "static" (and "auto"): the
    round-robin `i % num_hosts`; "rotate": the round-robin turned by
    `shard_rotation(seed, epoch, num_hosts)`, so that across epochs every
    host visits every slice (epoch 0 equals "static").  Either way a
    partition: every file owned by exactly one host."""
    if num_hosts <= 1:
        return list(range(n_files))
    r = (shard_rotation(seed, epoch, num_hosts)
         if mode == "rotate" else 0)
    return [i for i in range(n_files)
            if (i + r) % num_hosts == host_index]


def shard_assignment_digest(n_files: int, num_hosts: int, *, seed: int = 0,
                            epoch: int = 0, mode: str = "static") -> str:
    """Digest of the whole file->host assignment for `epoch`: equal on
    every host exactly when the gang agrees on (n_files, num_hosts, seed,
    epoch, mode).  Journaled per epoch and compared by `pod-verify`, so a
    host with a stale file listing or a wrong contract shows as a split."""
    import hashlib
    h = hashlib.blake2b(digest_size=16)
    h.update(f"{n_files}:{num_hosts}:{seed}:{epoch}:{mode}".encode())
    for host in range(num_hosts):
        idx = host_shard_assignment(n_files, host, num_hosts, seed=seed,
                                    epoch=epoch, mode=mode)
        h.update(np.asarray(idx, np.int64).tobytes())
        h.update(b";")
    return h.hexdigest()


def count_source_files(data: DataConfig) -> int:
    """The number of source files the config resolves to (the `n_files`
    of host_shard_assignment and shard_assignment_digest)."""
    return sum(len(reader.list_data_files(p)) for p in data.paths)


def host_file_shard(data: DataConfig, host_index: int = 0,
                    num_hosts: int = 1, *,
                    epoch: int = 0) -> list[tuple[int, str]]:
    """This host's (global file index, path) list, assigned by global index
    through `host_shard_assignment`: the one source of the shard scheme
    for every entry point.  Chaos site `data.host_shard` probes here (the
    elastic drill kills a host exactly where its slice is derived)."""
    from .. import chaos
    chaos.maybe_fail("data.host_shard", epoch=epoch)
    files = source_files(data)
    own = set(host_shard_assignment(
        len(files), host_index, num_hosts, seed=data.shuffle_seed,
        epoch=epoch, mode=data.host_shard))
    return [(i, p) for i, p in files if i in own]


def ingest_pool_width(data: DataConfig, n_files: int) -> int:
    """Files parsed at once: ingest_workers, else read_threads, else one
    worker per file capped at cpu_count (the JAX package's rule)."""
    if n_files <= 0:
        return 1
    width = data.ingest_workers or data.read_threads \
        or min(n_files, os.cpu_count() or 1)
    return max(1, min(int(width), n_files))


def _run_ingest_pool(files: list[tuple[int, str]], schema: DataSchema,
                     data: DataConfig, feature_dtype: str, width: int,
                     on_result: Callable[[tuple], None]) -> list:
    """Parse `files` on a pool of `width` and hand each (cols, valid_mask)
    to `on_result` in file order as soon as it is ready (a streaming
    consumer starts before the pool drains).  Each native parse gets its
    share of the cores (`native_parser.pool_parser_threads`), and v2
    entry writes run on one writer thread, closed (every entry durable)
    before this returns or raises.  Returns the per-file ingest stats."""
    from concurrent.futures import ThreadPoolExecutor

    from . import cache as cache_lib, native_parser
    stats: list = []
    writer = (cache_lib.AsyncEntryWriter()
              if cache_lib.resolve_cache_dir(data.cache_dir) else None)
    threaded = width > 1 and len(files) > 1
    pt = native_parser.pool_parser_threads(width) if threaded else None
    try:
        def load_one(item):
            return _load_one_projected(item, schema, data, feature_dtype,
                                       threaded, parser_threads=pt,
                                       stats=stats, writer=writer)

        if threaded:
            with ThreadPoolExecutor(max_workers=width) as pool:
                for res in pool.map(load_one, files):
                    on_result(res)
        else:
            for item in files:
                on_result(load_one(item))
    finally:
        if writer is not None:
            writer.close()
    return stats


def _assemble(results: list, schema: DataSchema, data: DataConfig
              ) -> tuple[TabularDataset, TabularDataset]:
    """(train, valid) from per-file results: the split, then one global
    row shuffle of the training partition seeded by split_seed ^ 0xC0FFEE,
    as in the JAX package."""
    if results:
        features = np.concatenate([c["features"] for c, _ in results])
        target = np.concatenate([c["target"] for c, _ in results])
        weight = np.concatenate([c["weight"] for c, _ in results])
        valid_mask = np.concatenate([m for _, m in results])
    else:
        features = np.zeros((0, schema.feature_count), np.float32)
        target = np.zeros((0, 1), np.float32)
        weight = np.zeros((0, 1), np.float32)
        valid_mask = np.zeros((0,), bool)
    full = TabularDataset(features, target, weight)
    train_idx = np.nonzero(~valid_mask)[0]
    if len(train_idx) > 1:
        perm = np.random.default_rng(np.random.PCG64(
            data.split_seed ^ 0xC0FFEE)).permutation(len(train_idx))
        train_idx = train_idx[perm]
    return full.take(train_idx), full.take(np.nonzero(valid_mask)[0])


def load_datasets(schema: DataSchema, data: DataConfig,
                  host_index: int = 0, num_hosts: int = 1,
                  feature_dtype: str = "float32"
                  ) -> tuple[TabularDataset, TabularDataset]:
    """Load (train, valid) from this host's files of `data.paths`
    (`host_file_shard`), through the parse-once cache when
    `data.cache_dir` (or SHIFU_TPU_DATA_CACHE) is set, and out of core
    (memory-mapped consolidated arrays, `outofcore.py`) when
    `data.out_of_core` is.

    Rows split train/valid by the stable hash of (file index, row index)
    (`split.train_valid_mask`); the training partition then gets one global
    row shuffle seeded by `split_seed ^ 0xC0FFEE`, as in the JAX package.
    `feature_dtype` "bfloat16" stores the features as bf16 bits, "int8c…"
    on the int8 wire grid."""
    if data.out_of_core:
        from .outofcore import load_datasets_out_of_core
        return load_datasets_out_of_core(schema, data, host_index,
                                         num_hosts,
                                         feature_dtype=feature_dtype)
    files = host_file_shard(data, host_index, num_hosts)
    t_ingest = time.perf_counter()
    width = ingest_pool_width(data, len(files))
    results: list = []
    stats = _run_ingest_pool(files, schema, data, feature_dtype, width,
                             results.append)
    _emit_ingest_report(stats, width, time.perf_counter() - t_ingest,
                        mode="load", host_index=host_index)
    return _assemble(results, schema, data)


def projected_cache_complete(schema: DataSchema, data: DataConfig,
                             feature_dtype: str = "float32", *,
                             host_index: int = 0,
                             num_hosts: int = 1) -> bool:
    """True when every input file has a projected-cache entry (the current
    format, or a v1 or legacy `.npz` one the loader serves and upgrades):
    the ingest then runs at `np.load` speed, so the streamed first epoch
    has no parse left to hide and the loaded tiers are faster.  One stat
    per source file and one exists per entry; False on any miss, a file
    with no key, or no cache dir.  The files are this host's
    (`host_file_shard`)."""
    from . import cache as cache_lib
    cache_dir = cache_lib.resolve_cache_dir(data.cache_dir)
    if cache_dir is None or not os.path.isdir(cache_dir):
        return False
    try:
        files = host_file_shard(data, host_index, num_hosts)
        if not files:
            return False
        version = resolved_cache_format(data)
        for file_idx, path in files:
            versions = (version, 1) if version >= 2 else (version,)
            hot = False
            for v in versions:
                name = cache_lib.projected_entry_name(
                    path, data.delimiter, file_idx, schema, data.valid_ratio,
                    data.split_seed, feature_dtype, version=v)
                if name is None:
                    return False
                entry = os.path.join(cache_dir, name)
                if (os.path.exists(entry)
                        or os.path.exists(cache_lib.legacy_projected_path(
                            entry))):
                    hot = True
                    break
            if not hot:
                return False
        return True
    except OSError:
        return False


def wire_mode(schema: DataSchema, data: DataConfig,
              model_compute_dtype: str) -> str:
    """Resolved wire format of the features: "float32", "bfloat16" or
    "int8".  "auto" picks bfloat16 when the model computes in bfloat16 and
    no categorical ids ride in the features; int8 with categorical columns
    degrades to float32 (JobConfig.validate rejects it up front)."""
    mode = data.wire_dtype
    if mode == "auto":
        return ("bfloat16" if (model_compute_dtype == "bfloat16"
                               and not schema.categorical_indices)
                else "float32")
    if mode == "int8" and schema.categorical_indices:
        return "float32"
    return mode


def resident_feature_format(schema: DataSchema, data: DataConfig,
                            model_compute_dtype: str) -> str:
    """In-card feature format of the resident tier: "int8" forces the
    wire grid (categorical-free schemas only); otherwise the wire format."""
    if data.resident_format == "int8" and not schema.categorical_indices:
        return "int8"
    return wire_mode(schema, data, model_compute_dtype)


def wire_quantize(x: np.ndarray, scale: np.ndarray,
                  offset: np.ndarray) -> np.ndarray:
    """The int8 wire encoder: round((x - offset) / scale), saturated to
    [-127, 127]."""
    xf = np.asarray(x, np.float32)
    q = np.clip(np.rint((xf - offset) * (1.0 / scale)), -127, 127)
    return q.astype(np.int8)


def wire_dequantize(q: np.ndarray, scale, offset) -> np.ndarray:
    """Host-side inverse of wire_quantize: q * scale + offset in f32."""
    return (np.asarray(q, np.float32) * np.asarray(scale, np.float32)
            + np.asarray(offset, np.float32))


def wire_params(schema: DataSchema,
                data: DataConfig) -> tuple[np.ndarray, np.ndarray]:
    """Per-column (scale, offset) of the static int8 grid: a pure function
    of the config (clip / 127, zero offset), so every block, tier and
    resume quantizes alike."""
    f = schema.feature_count
    scale = np.full((f,), float(data.wire_int8_clip) / 127.0, np.float32)
    offset = np.zeros((f,), np.float32)
    return scale, offset


def target_u8_exact(t: np.ndarray) -> bool:
    """True when every target is an integer in [0, 255] (a u8 wire cast
    round-trips exactly; always true for binary labels)."""
    tf = np.asarray(t)
    if tf.dtype == np.uint8:
        return True
    if tf.dtype.kind not in "fiu":
        return False
    lo, hi = (tf.min(), tf.max()) if tf.size else (0.0, 0.0)
    if not (0.0 <= lo and hi <= 255.0):
        return False
    return bool(np.all(tf == np.floor(tf)))


def weight_all_ones(w: np.ndarray) -> bool:
    """True when every weight is exactly 1.0: the column can be elided and
    the step synthesizes ones."""
    return bool(np.all(np.asarray(w) == 1.0))


def _compact_cols(b: dict, label_on, weight_on) -> dict:
    """The compact target/weight wire on one block.  `label_on` /
    `weight_on`: True (apply), False (off) or None (detect per block)."""
    t = b.get("target")
    if t is not None and t.dtype != np.uint8 and label_on is not False:
        if label_on or target_u8_exact(t):
            b = dict(b)
            b["target"] = np.asarray(t).astype(np.uint8)
    w = b.get("weight")
    if w is not None and weight_on is not False:
        if weight_on or weight_all_ones(w):
            b = dict(b)
            del b["weight"]
    return b


def wire_cast_fn(schema: DataSchema, data: DataConfig,
                 model_compute_dtype: str, compact=False):
    """Host-side cast of a batch or block before it goes to the card, or
    None.  int8 quantizes float features on the wire grid; a bfloat16 wire
    is cast on the card (module docstring).  `compact`: False (features
    only), True (per-block
    detection of the u8 target / elided weight) or an explicit
    (label_ok, weight_ok) pair decided dataset-wide."""
    mode = wire_mode(schema, data, model_compute_dtype)
    if compact is False or compact is None:
        label_on = weight_on = False
    else:
        label_on, weight_on = (None, None) if compact is True else compact
        if data.wire_label_dtype == "float32":
            label_on = False
        if data.wire_weight_mode == "float32":
            weight_on = False
    compacting = label_on is not False or weight_on is not False

    def compact_fn(b: dict) -> dict:
        return _compact_cols(b, label_on, weight_on) if compacting else b

    if mode == "int8":
        scale, offset = wire_params(schema, data)

        def cast_q(b: dict) -> dict:
            f = b.get("features")
            if f is not None and f.dtype != np.int8:
                b = dict(b)
                b["features"] = wire_quantize(f, scale, offset)
            return compact_fn(b)

        return cast_q
    return compact_fn if compacting else None


def epoch_permutation(n: int, *, shuffle: bool = True, seed: int = 0,
                      epoch: int = 0) -> np.ndarray:
    """The per-epoch order: PCG64 seeded by seed * 1_000_003 + epoch, the
    JAX package's stream, shared by the per-batch and resident tiers."""
    if not shuffle:
        return np.arange(n)
    return np.random.default_rng(
        np.random.PCG64(seed * 1_000_003 + epoch)).permutation(n)


def batch_iterator(ds: TabularDataset, batch_size: int, *,
                   shuffle: bool = True, seed: int = 0, epoch: int = 0,
                   drop_remainder: bool = True
                   ) -> Iterator[dict[str, np.ndarray]]:
    """{'features', 'target', 'weight'} batches in epoch_permutation order;
    drop_remainder keeps every batch the same shape."""
    n = ds.num_rows
    if n == 0:
        return
    order = epoch_permutation(n, shuffle=shuffle, seed=seed, epoch=epoch)
    end = (n // batch_size) * batch_size if drop_remainder else n
    for start in range(0, end, batch_size):
        idx = order[start:start + batch_size]
        yield {"features": ds.features[idx], "target": ds.target[idx],
               "weight": ds.weight[idx]}


def num_batches(ds: TabularDataset, batch_size: int,
                drop_remainder: bool = True) -> int:
    if drop_remainder:
        return ds.num_rows // batch_size
    return -(-ds.num_rows // batch_size)


def pad_to_batch(batch: dict[str, np.ndarray], batch_size: int
                 ) -> tuple[dict[str, np.ndarray], np.ndarray]:
    """Pad a short batch to batch_size with zero-weight rows; returns
    (padded, validity mask).  Full-dataset eval uses it so that no row is
    dropped and the padding counts nowhere."""
    n = batch["features"].shape[0]
    if n == batch_size:
        return batch, np.ones((batch_size,), bool)
    pad = batch_size - n
    out = {k: np.concatenate([v, np.zeros((pad,) + v.shape[1:], v.dtype)])
           for k, v in batch.items()}
    out["weight"][n:] = 0.0
    mask = np.zeros((batch_size,), bool)
    mask[:n] = True
    return out, mask


def wire_row_bytes(schema: DataSchema, data: DataConfig,
                   model_compute_dtype: str,
                   compact: bool = True) -> int:
    """Bytes one row costs on the host-to-card wire under the resolved
    formats (the compact target/weight wire assumed when `compact`): sizes
    staged chunks by bytes rather than rows."""
    mode = wire_mode(schema, data, model_compute_dtype)
    per_feat = {"int8": 1, "bfloat16": 2}.get(mode, 4)
    n_tgt = max(len(schema.all_target_indices), 1)
    tgt = (1 if (compact and data.wire_label_dtype != "float32") else 4)
    wgt = (0 if (compact and data.wire_weight_mode != "float32") else 4)
    return schema.feature_count * per_feat + n_tgt * tgt + wgt


# -- the input plane ----------------------------------------------------------

class StreamingLoader:
    """Background-parse loader for the streamed first epoch.

    Parses the files on a background pool (the same per-file parse,
    projection and split as `load_datasets`, writing v2 cache entries as
    it parses when a cache dir is set) and exposes the results two ways:

    - `first_epoch_blocks(batch_size, block_batches)`: stacked (nb, B, ...)
      train blocks as soon as enough rows have parsed, in file order (the
      global shuffle applies to the retained dataset afterwards);
    - `datasets()`: blocks until every file parsed; returns the same
      (train, valid) pair `load_datasets` builds, for the later epochs.
    """

    def __init__(self, schema: DataSchema, data: DataConfig,
                 feature_dtype: str = "float32", host_index: int = 0,
                 num_hosts: int = 1):
        self._schema = schema
        self._data = data
        self._feature_dtype = feature_dtype
        self._host_index = host_index
        self._items = host_file_shard(data, host_index, num_hosts)
        self._results: list[tuple[dict, np.ndarray]] = []
        self._datasets: Optional[tuple[TabularDataset, TabularDataset]] = None
        self._valid: Optional[TabularDataset] = None
        self.real_batches = 0  # set by first_epoch_blocks
        # parse-result queue depth: prefetch_depth, auto (0) keeping 4
        self._q: queue.Queue = queue.Queue(maxsize=data.prefetch_depth or 4)
        self._abort = False  # see abort_blocks()
        self._thread = threading.Thread(target=self._produce, daemon=True,
                                        name="shifu-stream-parse")
        self._thread.start()

    def _produce(self) -> None:
        t_ingest = time.perf_counter()
        width = ingest_pool_width(self._data, len(self._items))
        try:
            # the pool's writer is closed (entries durable) before the
            # stats return, before the hot-cache probe can run
            stats = _run_ingest_pool(self._items, self._schema, self._data,
                                     self._feature_dtype, width, self._q.put)
        except BaseException as e:  # surface parse errors to the consumer
            self._q.put(e)
            return
        _emit_ingest_report(stats, width, time.perf_counter() - t_ingest,
                            mode="stream", host_index=self._host_index)
        self._q.put(None)

    def first_epoch_blocks(self, batch_size: int, block_batches: int,
                           pad_tail: bool = True) -> Iterator[dict]:
        """Stacked train blocks in arrival order; retains every result for
        datasets().  Must be consumed before datasets() is called.

        Every block has the same shape (block_batches, batch_size, ...).
        With `pad_tail` the final partial block is completed with
        zero-weight rows, exact for weighted_mse and weighted_bce without
        an L2 term (zero-weight rows add zero loss and zero gradient), so
        every parsed train row trains in the streamed epoch; otherwise the
        tail waits for the retained dataset's later epochs.
        `real_batches` counts batches holding at least one real row (the
        train_error denominator)."""
        self.real_batches = 0
        buf: list[dict] = []
        buffered = 0
        target_rows = batch_size * block_batches

        def take_rows(take: int) -> dict:
            nonlocal buffered
            parts: list[dict] = []
            got = 0
            while got < take:
                head = buf[0]
                need = take - got
                n = head["features"].shape[0]
                if n <= need:
                    parts.append(buf.pop(0))
                    got += n
                else:
                    parts.append({k: v[:need] for k, v in head.items()})
                    buf[0] = {k: v[need:] for k, v in head.items()}
                    got += need
            buffered -= take
            return {k: np.concatenate([p[k] for p in parts])
                    for k in parts[0]}

        def as_block(flat: dict) -> dict:
            return {k: v.reshape(block_batches, batch_size, *v.shape[1:])
                    for k, v in flat.items()}

        while True:
            try:
                item = self._q.get(timeout=0.1)
            except queue.Empty:
                if self._abort:
                    return
                continue
            if item is None:
                break
            if isinstance(item, BaseException):
                raise item
            cols, valid_mask = item
            self._results.append((cols, valid_mask))
            if self._abort:
                return  # retained above; _drain takes over the queue
            tm = ~valid_mask
            if tm.any():
                buf.append({k: v[tm] for k, v in cols.items()})
                buffered += int(tm.sum())
            while buffered >= target_rows:
                self.real_batches += block_batches
                yield as_block(take_rows(target_rows))
        if buffered and pad_tail:
            n_real = buffered
            flat = take_rows(n_real)
            pad = target_rows - n_real
            padded = {k: np.concatenate(
                [v, np.zeros((pad,) + v.shape[1:], v.dtype)])
                for k, v in flat.items()}
            padded["weight"][n_real:] = 0.0
            self.real_batches += -(-n_real // batch_size)
            yield as_block(padded)

    def _drain(self) -> None:
        """Join the background parse, collecting what first_epoch_blocks
        did not consume.  Timed gets: the sentinel may already be consumed,
        and the producer may be blocked on a full queue."""
        done = False
        while not done:
            try:
                item = self._q.get(timeout=0.1)
            except queue.Empty:
                if not self._thread.is_alive():
                    done = True
                continue
            if item is None:
                done = True
            elif isinstance(item, BaseException):
                raise item
            else:
                self._results.append(item)
        self._thread.join()

    def abort_blocks(self) -> None:
        """Cooperative shutdown of a first_epoch_blocks consumer in another
        thread: the generator exits at its next poll."""
        self._abort = True

    def train_rows_total(self) -> int:
        """The train rows this host parsed: drains the background parse
        and counts the split masks, assembling no arrays (what a streamed
        epoch that ended early left untrained is this less the rows it
        trained)."""
        if self._datasets is not None:
            return self._datasets[0].num_rows
        self._drain()
        return int(sum(int((~m).sum()) for _, m in self._results))

    def valid_dataset(self) -> TabularDataset:
        """The valid partition only (a few % of the rows), for the
        streamed epoch's eval, without the full train assembly."""
        if self._datasets is not None:
            return self._datasets[1]
        if self._valid is None:
            self._drain()
            parts = [(c, m) for c, m in self._results if m.any()]
            if parts:
                self._valid = TabularDataset(*(
                    np.concatenate([c[k][m] for c, m in parts])
                    for k in ("features", "target", "weight")))
            else:
                self._valid = TabularDataset(
                    np.zeros((0, self._schema.feature_count), np.float32),
                    np.zeros((0, 1), np.float32),
                    np.zeros((0, 1), np.float32))
        return self._valid

    def train_dataset(self) -> TabularDataset:
        """The train partition with load_datasets' global shuffle,
        assembled when an epoch first needs it."""
        return self.datasets()[0]

    def datasets(self) -> tuple[TabularDataset, TabularDataset]:
        """(train, valid), identical to load_datasets' output."""
        if self._datasets is None:
            self._drain()
            self._datasets = _assemble(self._results, self._schema,
                                       self._data)
            self._results = []
        return self._datasets


def staged_epoch_offset(num_rows: int, batch_size: int, *,
                        shuffle: bool = True, epoch: int = 0) -> int:
    """The staged tier's per-epoch row-offset rotation (batch composition
    drifts across epochs when rows don't divide the batch evenly)."""
    nb_total = num_rows // batch_size
    slack = num_rows - nb_total * batch_size
    return (epoch * 997) % (slack + 1) if (shuffle and slack > 0) else 0


def staged_epoch_blocks(ds: TabularDataset, batch_size: int, *,
                        shuffle: bool = True, seed: int = 0, epoch: int = 0,
                        block_batches: int = 32
                        ) -> Iterator[dict[str, np.ndarray]]:
    """{'features': (nb, B, F), ...} stacked blocks for the staged epoch:
    the dataset viewed as (num_batches, B, ...) from the epoch's row
    offset, whole batches gathered in the epoch's block permutation (row
    shuffling happens once, at load)."""
    n = ds.num_rows
    nb_total = n // batch_size
    if nb_total == 0:
        return
    offset = staged_epoch_offset(n, batch_size, shuffle=shuffle, epoch=epoch)

    def as_blocks(arr: np.ndarray) -> np.ndarray:
        return arr[offset:offset + nb_total * batch_size].reshape(
            nb_total, batch_size, *arr.shape[1:])

    feats = as_blocks(ds.features)
    targ = as_blocks(ds.target)
    wgt = as_blocks(ds.weight)
    order = epoch_permutation(nb_total, shuffle=shuffle, seed=seed,
                              epoch=epoch)
    for start in range(0, nb_total, block_batches):
        idx = order[start:start + block_batches]
        yield {"features": feats[idx], "target": targ[idx],
               "weight": wgt[idx]}


def prefetch_to_device(items: Iterator[dict], put_fn, size: int = 2
                       ) -> Iterator:
    """A producer thread runs `put_fn` (cast and placement) over `items`
    up to `size` ahead of the consumer; errors reach the consumer.  With
    `size` <= 0 it runs inline."""
    lat = obs.histogram("data_batch_latency_seconds",
                        "host batch production + device placement latency")

    def timed_put(b):
        t0 = time.perf_counter()
        out = put_fn(b)
        lat.observe(time.perf_counter() - t0)
        return out

    if size <= 0:
        for b in items:
            yield timed_put(b)
        return
    q: queue.Queue = queue.Queue(maxsize=size)
    end = object()

    def producer() -> None:
        try:
            for b in items:
                q.put(timed_put(b))
        except BaseException as e:  # surface errors to the consumer
            q.put(e)
            return
        q.put(end)

    threading.Thread(target=producer, daemon=True,
                     name="shifu-prefetch").start()
    while True:
        item = q.get()
        if item is end:
            return
        if isinstance(item, BaseException):
            raise item
        yield item


def next_prefetch_depth(current: int, exposed_fraction: float,
                        lo: int = 2, hi: int = 8) -> int:
    """Auto prefetch depth (prefetch_depth == 0): one step per epoch from
    the ledger's exposed-input fraction.  Visible starvation doubles the
    feeder's device-side bound (up to `hi`); a fully hidden input path
    decays it one step toward `lo`."""
    if exposed_fraction > 0.05:
        return min(max(current * 2, lo), hi)
    if exposed_fraction < 0.01 and current > lo:
        return current - 1
    return current


def epoch_order_digest(tier: str, num_rows: int, batch_size: int, *,
                       shuffle: bool = True, seed: int = 0,
                       epoch: int = 0) -> Optional[str]:
    """blake2b hex digest of the batch order a tier draws for (seed,
    epoch), the JAX package's: `staged` = the row offset and the block
    permutation (staged_epoch_blocks); `batch` = batch_iterator's row
    permutation; `resident` = the loop's block order.  None for the
    streamed first epoch (file order) and unknown tiers."""
    import hashlib

    if tier == "staged":
        nb_total = num_rows // batch_size
        if nb_total == 0:
            return None
        offset = staged_epoch_offset(num_rows, batch_size, shuffle=shuffle,
                                     epoch=epoch)
        order = epoch_permutation(nb_total, shuffle=shuffle, seed=seed,
                                  epoch=epoch)
        payload = np.concatenate([[offset], order]).astype(np.int64)
    elif tier in ("batch", "resident"):
        n = num_rows if tier == "batch" else num_rows // batch_size
        if n == 0:
            return None
        payload = np.asarray(epoch_permutation(n, shuffle=shuffle, seed=seed,
                                               epoch=epoch), np.int64)
    else:
        return None
    return hashlib.blake2b(payload.tobytes(), digest_size=16).hexdigest()


def interleaved_epoch_order(host_row_ids, local_batch_size: int, *,
                            shuffle: bool = True, seed: int = 0,
                            epoch: int = 0) -> np.ndarray:
    """The pod's global batch order, as row ids: global batch `b` of
    `epoch` is the rank-order concatenation of every host's rows
    `local_perm[b*lbs:(b+1)*lbs]`, `local_perm` being the same
    `epoch_permutation(min_rows, ...)` on every host.  One process
    replaying it reproduces an N-host run's global batches.  Rows past
    `min_rows` and the batch tail are dropped, as the loop's min-host-rows
    agreement and drop-remainder do.  A flat (steps * hosts * lbs,) array;
    reshape to (steps, hosts, lbs) for per-batch views."""
    if not host_row_ids:
        return np.zeros((0,), np.int64)
    min_rows = min(len(r) for r in host_row_ids)
    steps = min_rows // local_batch_size
    if steps == 0:
        return np.zeros((0,), np.int64)
    perm = epoch_permutation(min_rows, shuffle=shuffle, seed=seed,
                             epoch=epoch)
    take = perm[: steps * local_batch_size]
    cols = [np.asarray(r, np.int64)[take].reshape(steps, local_batch_size)
            for r in host_row_ids]
    return np.stack(cols, axis=1).reshape(-1)


class _DepthGate:
    """Resizable counting gate bounding the feeder's device queue: the
    placement thread acquires a slot per staged item, the consumer
    releases one per item drained.  Shrinking records a deficit that
    absorbs later releases instead of blocking anyone."""

    def __init__(self, depth: int):
        self._sem = threading.Semaphore(depth)
        self._lock = threading.Lock()
        self._deficit = 0
        self.depth = depth

    def acquire(self, timeout: float) -> bool:
        return self._sem.acquire(timeout=timeout)

    def release(self) -> None:
        with self._lock:
            if self._deficit > 0:
                self._deficit -= 1
                return
        self._sem.release()

    def resize(self, depth: int) -> None:
        with self._lock:
            delta = depth - self.depth
            self.depth = depth
            if delta < 0:
                self._deficit += -delta
                return
            # pay down a shrink deficit before releasing new permits
            paid = min(self._deficit, delta)
            self._deficit -= paid
            delta -= paid
        for _ in range(delta):
            self._sem.release()


class FeederError(RuntimeError):
    """The persistent feeder died without delivering its epoch: raised in
    the consumer, so a dead producer fails the epoch instead of hanging
    it."""


class EpochFeeder:
    """Persistent cross-epoch input feeder (the JAX package's overlap
    engine).  One pair of host threads lives for the whole job and runs
    ahead across epoch boundaries:

      assembly thread:  epoch_source(epoch) -> host items (shuffle, gather,
                        and whatever host transform the source applies)
      placement thread: put_fn(item) -> device items (pinned copy to the
                        card on a stream of its own, in the training loop)

    so epoch N+1's first items are assembled and placed while epoch N
    computes and evaluates.  Items arrive strictly in epoch order, and
    each epoch's order is the source's pure function of (seed, epoch), so
    the batches equal the per-epoch path's.

    Bounds: `host_depth` assembled items (host RAM), `depth` placed items
    (device memory); `set_depth` resizes the device bound between epochs.
    An exception in either thread is re-raised in the consumer; a thread
    that dies without its sentinel raises FeederError at the consumer's
    next poll.  `close()` (idempotent) aborts both threads and drops what
    was produced ahead."""

    _POLL_S = 0.1

    def __init__(self, epoch_source, put_fn, epochs, *,
                 depth: int = 2, host_depth: int = 4):
        self._source = epoch_source
        self._put_fn = put_fn
        self._epochs = list(epochs)
        self._abort = threading.Event()
        self._hostq: queue.Queue = queue.Queue(maxsize=max(host_depth, 1))
        self._devq: queue.Queue = queue.Queue()  # bounded by _gate
        self._gate = _DepthGate(max(depth, 1))
        self._staged_lock = threading.Lock()
        self._staged = 0  # item records in devq (sentinels excluded)
        self._prod_s: dict[int, float] = {}  # epoch -> host seconds
        self._lat = obs.histogram(
            "data_batch_latency_seconds",
            "host batch production + device placement latency")
        self._threads = [
            threading.Thread(target=self._assemble, daemon=True,
                             name="shifu-feeder-assemble"),
            threading.Thread(target=self._place, daemon=True,
                             name="shifu-feeder-place"),
        ]
        for t in self._threads:
            t.start()

    # -- producer side ------------------------------------------------------

    def _put(self, q, item) -> bool:
        while not self._abort.is_set():
            try:
                q.put(item, timeout=self._POLL_S)
                return True
            except queue.Full:
                continue
        return False

    def _assemble(self) -> None:
        from .. import chaos
        try:
            for ep in self._epochs:
                if self._abort.is_set():
                    return
                # chaos site "data.feeder": the feeder thread boundary; a
                # raise here must fail the epoch in the consumer
                chaos.maybe_fail("data.feeder", epoch=ep)
                prod = 0.0
                t0 = time.perf_counter()
                for item in self._source(ep):
                    prod += time.perf_counter() - t0
                    if not self._put(self._hostq, ("item", ep, item, prod)):
                        return
                    prod = 0.0
                    t0 = time.perf_counter()
                prod += time.perf_counter() - t0
                if not self._put(self._hostq, ("end", ep, None, prod)):
                    return
            self._put(self._hostq, ("done", None, None, 0.0))
        except BaseException as e:  # forwarded, re-raised by the consumer
            self._put(self._hostq, ("error", None, e, 0.0))

    def _host_get(self):
        """Next host-queue record, or None when assembly is gone for good
        (a last non-blocking look first: its final sentinel may land
        between a timeout and its exit)."""
        while not self._abort.is_set():
            try:
                return self._hostq.get(timeout=self._POLL_S)
            except queue.Empty:
                if not self._threads[0].is_alive():
                    try:
                        return self._hostq.get_nowait()
                    except queue.Empty:
                        return None
        return None

    def _place(self) -> None:
        place_s: dict[int, float] = {}
        try:
            while not self._abort.is_set():
                item = self._host_get()
                if item is None:
                    return
                tag, ep, payload, prod = item
                if tag == "item":
                    t0 = time.perf_counter()
                    dev = self._put_fn(payload)
                    dt = time.perf_counter() - t0
                    self._lat.observe(prod + dt)
                    place_s[ep] = place_s.get(ep, 0.0) + prod + dt
                    while not self._abort.is_set():
                        if self._gate.acquire(timeout=self._POLL_S):
                            with self._staged_lock:
                                self._staged += 1
                            self._devq.put(("item", ep, dev))
                            break
                    continue
                if tag == "end":
                    total = place_s.pop(ep, 0.0) + prod
                    self._devq.put(("end", ep, total))
                    continue
                self._devq.put((tag, ep, payload))  # done / error
                return
        except BaseException as e:
            self._devq.put(("error", None, e))

    # -- consumer side ------------------------------------------------------

    def _get(self):
        while True:
            try:
                return self._devq.get(timeout=self._POLL_S)
            except queue.Empty:
                if self._abort.is_set() or not any(
                        t.is_alive() for t in self._threads):
                    try:
                        return self._devq.get_nowait()
                    except queue.Empty:
                        raise FeederError(
                            "input feeder died without delivering its "
                            "epoch (producer thread gone)")

    def epoch(self, epoch: int) -> Iterator:
        """Device items for `epoch`, in order.  Epochs must be consumed in
        the order the feeder was constructed with."""
        while True:
            tag, ep, payload = self._get()
            if tag == "error":
                self._abort.set()
                raise payload
            if tag == "done":
                raise FeederError(
                    f"feeder exhausted before epoch {epoch} (consumed out "
                    "of order?)")
            if ep != epoch:
                self._abort.set()
                raise FeederError(
                    f"feeder/consumer epoch mismatch: got {ep}, "
                    f"expected {epoch}")
            if tag == "end":
                self._prod_s[epoch] = payload
                return
            with self._staged_lock:
                self._staged -= 1
            try:
                yield payload
            finally:
                self._gate.release()

    def production_seconds(self, epoch: int) -> float:
        """Host seconds this epoch's items cost to assemble and place,
        wherever they ran; 0.0 until the epoch's end marker was consumed."""
        return self._prod_s.get(epoch, 0.0)

    def ready_ahead(self) -> int:
        """Items already placed beyond what the consumer pulled: at an
        epoch boundary, the next epoch's prefetched items."""
        with self._staged_lock:
            return max(self._staged, 0)

    @property
    def depth(self) -> int:
        return self._gate.depth

    def set_depth(self, depth: int) -> None:
        """Resize the device-queue bound (auto mode; between epochs)."""
        self._gate.resize(max(int(depth), 1))

    def close(self) -> None:
        """Abort both threads and discard run-ahead items.  Idempotent."""
        self._abort.set()
        deadline = time.monotonic() + 10.0
        while (any(t.is_alive() for t in self._threads)
               and time.monotonic() < deadline):
            try:  # drain so a producer blocked on a full gate/queue exits
                self._devq.get_nowait()
                self._gate.release()
            except queue.Empty:
                time.sleep(self._POLL_S / 2)
        for t in self._threads:
            t.join(timeout=1.0)
