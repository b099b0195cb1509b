"""Gzip and plain pipe-delimited normalized-data reader, and parquet (port
of shifu_tpu/data/reader.py).

`read_file` takes the JAX package's tiers in its order: parquet by
extension (through a lazy `pyarrow.parquet` import); else the native C++
parser (`native_parser`: zlib + from_chars, multi-threaded) when g++ could
build it; else the numpy tier here, which splits the whole decompressed
text in newline-aligned slabs and reshapes by the column count, with a
per-line fallback that keeps every row (bad cells become NaN, imputed at
projection).  Both text tiers give the same arrays bit for bit.  Each read
records its tier and cost split for this thread (`last_io_stats`), which
the ingest report reads.  `read_files` can put the parse-once cache
(`data/cache.py`) in front.  A remote URI (hdfs:// gs:// s3:// file://
mock://) is fetched whole through `data/fsio.py`, decompressed by its gzip
magic and parsed by the same tiers from the buffer; remote parquet opens a
seekable pyarrow file, and a remote count streams.
"""

from __future__ import annotations

import gzip
import io
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, Iterator, Optional, Sequence

import numpy as np

from ..config.schema import DataSchema

# Per-thread record of the most recent read_file call's cost split —
# {tier, inflate_s, parse_s, source_bytes} — so the ingest pool's
# concurrent parses never mix records.  The native tier fuses inflate and
# parse in C++, so its whole wall lands in parse_s.
_io_local = threading.local()


def _note_io(tier: str, inflate_s: float, parse_s: float,
             source_bytes: int) -> None:
    _io_local.stats = {"tier": tier, "inflate_s": inflate_s,
                       "parse_s": parse_s, "source_bytes": source_bytes}


def last_io_stats() -> dict:
    """This thread's cost split for its most recent `read_file`; an empty
    dict before the first read."""
    return dict(getattr(_io_local, "stats", {}))


def open_maybe_gzip(path: str) -> io.BufferedReader:
    """Open a file, transparently gunzipping by magic number (not extension)."""
    f = open(path, "rb")
    magic = f.read(2)
    f.seek(0)
    if magic == b"\x1f\x8b":
        return gzip.open(f, "rb")  # type: ignore[return-value]
    return f


def parse_rows(text: bytes | str, delimiter: str = "|") -> np.ndarray:
    """Parse delimited float rows into an (N, C) float32 array; the column
    count comes from the first non-blank line."""
    if isinstance(text, bytes):
        text = text.decode("utf-8", errors="replace")
    text = text.strip("\n")
    first_line = next((ln for ln in text.split("\n") if ln.strip()), "")
    if not first_line:
        return np.zeros((0, 0), dtype=np.float32)
    ncols = first_line.count(delimiter) + 1
    num_lines = text.count("\n") + 1
    flat = _fast_parse(text, delimiter)
    if flat is None or flat.size != num_lines * ncols:
        return _parse_ragged(text, delimiter, ncols)
    return flat.reshape(-1, ncols)


def _fast_parse(text: str, delimiter: str) -> Optional[np.ndarray]:
    """Split + bulk float conversion in ~16 MB newline-aligned slabs (the
    per-token strings exist for one slab at a time); None on a
    non-numeric cell."""
    slab = 1 << 24
    out = []
    pos, n = 0, len(text)
    try:
        while pos < n:
            if n - pos <= slab:
                end = n
            else:
                end = text.rfind("\n", pos, pos + slab)
                if end <= pos:
                    end = n  # one line longer than the slab: take it whole
            chunk = text[pos:end].replace(delimiter, " ")
            out.append(np.array(chunk.split(), dtype=np.float32))
            pos = end + 1
    except (ValueError, OverflowError):
        return None
    if not out:
        return np.zeros((0,), dtype=np.float32)
    return out[0] if len(out) == 1 else np.concatenate(out)


def _parse_ragged(text: str, delimiter: str, ncols: int) -> np.ndarray:
    rows = []
    for line in text.split("\n"):
        if not line.strip():
            continue  # blank lines are not rows
        vals = np.full((ncols,), np.nan, dtype=np.float32)
        for i, c in enumerate(line.split(delimiter)[:ncols]):
            try:
                vals[i] = float(c)
            except ValueError:
                pass  # NaN, imputed at projection
        rows.append(vals)
    if not rows:
        return np.zeros((0, ncols), dtype=np.float32)
    return np.stack(rows)


def _parse_bytes(raw: bytes, delimiter: str,
                 parser_threads: Optional[int] = None) -> np.ndarray:
    """Tier selection for an in-memory buffer: the native parse when
    available, the numpy tier otherwise (identical outputs)."""
    from . import native_parser
    if len(delimiter.encode()) == 1 and native_parser.available():
        try:
            return native_parser.parse_buffer(raw, delimiter,
                                              threads=parser_threads)
        except RuntimeError:
            pass
    return parse_rows(raw, delimiter)


_PARQUET_EXTS = (".parquet", ".pq")


def is_parquet(path: str) -> bool:
    return path.lower().endswith(_PARQUET_EXTS)


def _parquet_source(path: str):
    """A local path, or a seekable pyarrow file for a remote URI (parquet
    readers need random access)."""
    from . import fsio
    return fsio.open_input_file(path) if fsio.is_remote(path) else path


def _fetch_decompressed(path: str) -> tuple[bytes, int]:
    """A remote file's bytes, gunzipped when they start with the gzip
    magic, and the fetched (source) byte count."""
    from . import fsio
    raw = fsio.read_bytes(path)
    fetched = len(raw)
    if raw[:2] == b"\x1f\x8b":
        raw = gzip.decompress(raw)
    return raw, fetched


def _read_parquet(path: str) -> np.ndarray:
    """One parquet file -> the same (N, C) float32 matrix the text parsers
    produce; column positions (file order) take the place of the text
    column indices ColumnConfig refers to.  A non-numeric column is a data
    error, reported by name and position."""
    import pyarrow.parquet as pq

    table = pq.ParquetFile(_parquet_source(path)).read()
    cols = []
    for i in range(table.num_columns):
        arr = table.column(i).to_numpy(zero_copy_only=False)
        try:
            cols.append(np.asarray(arr, dtype=np.float32))
        except (ValueError, TypeError) as e:
            field = table.schema.field(i)
            raise ValueError(
                f"{path}: parquet column {i} ({field.name!r}) is not "
                f"numeric (dtype {field.type}); normalized training data "
                "must be numeric") from e
    if not cols:
        return np.zeros((0, 0), dtype=np.float32)
    return np.ascontiguousarray(np.column_stack(cols))


def _local_size(path: str) -> int:
    try:
        return os.path.getsize(path)
    except OSError:
        return 0


def read_file(path: str, delimiter: str = "|",
              parser_threads: Optional[int] = None) -> np.ndarray:
    """Read one data file into (N, C) float32: gzip or plain delimited
    text, or parquet (by its .parquet/.pq extension).

    Text takes the native C++ parser when it builds, else the numpy tier;
    an engine failure in the native parser falls back to numpy, while IO
    errors (FileNotFoundError, OSError) propagate.  `parser_threads` caps
    the native parse's threads (a file-level pool passes its share, so the
    parallelism stays ~cores, not cores^2)."""
    from . import fsio, native_parser
    if is_parquet(path):
        t0 = time.perf_counter()
        arr = _read_parquet(path)
        _note_io("parquet", 0.0, time.perf_counter() - t0, _local_size(path))
        return arr
    if fsio.is_remote(path):
        t0 = time.perf_counter()
        raw, fetched = _fetch_decompressed(path)
        t1 = time.perf_counter()
        arr = _parse_bytes(raw, delimiter, parser_threads)
        _note_io("remote", t1 - t0, time.perf_counter() - t1, fetched)
        return arr
    if len(delimiter.encode()) == 1 and native_parser.available():
        try:
            t0 = time.perf_counter()
            arr = native_parser.parse_file(path, delimiter,
                                           threads=parser_threads)
            _note_io("native", 0.0, time.perf_counter() - t0,
                     _local_size(path))
            return arr
        except RuntimeError:
            pass  # engine-internal failure: the numpy tier serves
    t0 = time.perf_counter()
    with open_maybe_gzip(path) as f:
        raw = f.read()
    t1 = time.perf_counter()
    arr = parse_rows(raw, delimiter)
    _note_io("numpy", t1 - t0, time.perf_counter() - t1, _local_size(path))
    return arr


def read_files(paths: Sequence[str], delimiter: str = "|",
               cache_dir: Optional[str] = None,
               num_threads: Optional[int] = None) -> list[np.ndarray]:
    """Read many files concurrently (inflate and parse release the GIL),
    preserving input order; each parse then runs on one thread.  With
    `cache_dir` each file goes through the parse-once cache
    (`cache.read_file_cached`)."""
    from .cache import read_file_cached

    if num_threads is None:
        num_threads = min(len(paths), os.cpu_count() or 1)
    threaded = num_threads > 1 and len(paths) > 1

    def one(p: str) -> np.ndarray:
        return read_file_cached(p, delimiter, cache_dir=cache_dir,
                                parser_threads=1 if threaded else None)

    if not threaded:
        return [one(p) for p in paths]
    with ThreadPoolExecutor(max_workers=num_threads) as pool:
        return list(pool.map(one, paths))


def count_rows(paths: Sequence[str]) -> int:
    """Total non-blank data rows across files, gzip-aware (the reference's
    getFileLineCount): parquet from its metadata, text through the native
    counter, else a streamed count."""
    from . import fsio, native_parser
    use_native = native_parser.available()
    total = 0
    for p in paths:
        if is_parquet(p):
            import pyarrow.parquet as pq
            total += pq.ParquetFile(_parquet_source(p)).metadata.num_rows
            continue
        if fsio.is_remote(p):
            total += fsio.count_data_lines(p)  # streaming, constant memory
            continue
        if use_native:
            try:
                total += native_parser.count_rows(p)
                continue
            except RuntimeError:
                pass  # engine-internal failure: count in Python
        with open_maybe_gzip(p) as f:
            for line in f:
                if line.strip():  # non-blank data lines only (= parser rows)
                    total += 1
    return total


def list_data_files(root: str) -> list[str]:
    """Data files under a directory or remote URI, skipping '.'/'_'
    prefixed names (the reference's HDFS listing filter); a file path
    lists itself."""
    from . import fsio
    return fsio.list_files(root)


def shard_paths(paths: Sequence[str], shard_index: int,
                num_shards: int) -> list[str]:
    """Round-robin file paths across hosts: path i goes to shard
    i % num_shards (the reference's per-worker file split, without its
    "#files must be >= #workers" failure: a shard with no files is
    empty)."""
    return [p for i, p in enumerate(paths) if i % num_shards == shard_index]


def iter_file_rows(paths: Iterable[str], delimiter: str = "|",
                   chunk_rows: int = 262144) -> Iterator[np.ndarray]:
    """(chunk_rows, C) arrays of each file in turn, one file parsed at a
    time, so the whole dataset is never held at once."""
    for path in paths:
        arr = read_file(path, delimiter)
        for start in range(0, arr.shape[0], chunk_rows):
            yield arr[start:start + chunk_rows]


def project_columns(rows: np.ndarray, schema: DataSchema,
                    impute_value: float = 0.0) -> dict[str, np.ndarray]:
    """Raw (N, C) rows -> features (selected columns, NaN imputed), target
    (N, H) and weight (N, 1; 1.0 without a weight column, negatives and
    NaNs clamp to 1.0 as in the reference)."""
    n = rows.shape[0]
    sel = np.asarray(schema.selected_indices, dtype=np.int64)
    need = max([*schema.selected_indices, *schema.all_target_indices,
                schema.weight_index]) + 1
    if n and rows.shape[1] < need:
        raise ValueError(
            f"parsed rows have {rows.shape[1]} columns but the schema "
            f"references column index {need - 1}; the data delimiter "
            "(dataSet.dataDelimiter / DataConfig.delimiter) probably does "
            "not match the files")
    features = rows[:, sel] if n else np.zeros((0, len(sel)), np.float32)
    features = np.nan_to_num(features, nan=impute_value)
    tgt_idx = np.asarray(schema.all_target_indices, dtype=np.int64)
    target = rows[:, tgt_idx] if n else np.zeros((0, len(tgt_idx)),
                                                  np.float32)
    if schema.weight_index >= 0:
        weight = rows[:, schema.weight_index:schema.weight_index + 1].copy()
        weight[~(weight >= 0.0)] = 1.0  # negatives and NaNs -> 1.0
    else:
        weight = np.ones((n, 1), dtype=np.float32)
    return {
        "features": np.ascontiguousarray(features, dtype=np.float32),
        "target": np.ascontiguousarray(target, dtype=np.float32),
        "weight": np.ascontiguousarray(weight, dtype=np.float32),
    }
