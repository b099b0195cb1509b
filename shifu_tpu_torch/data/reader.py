"""Gzip and plain pipe-delimited normalized-data reader (port of the local
text path of shifu_tpu/data/reader.py).

Parsing is vectorized: the whole decompressed text is split by numpy in
newline-aligned slabs and reshaped by the column count; rows with a
non-numeric cell fall back to a per-line parse that keeps every row (bad
cells become NaN, imputed at projection).  Parquet, remote file systems, the
native C++ parser and the parse-once cache wait for a later slice
(ROADMAP.md queue A).
"""

from __future__ import annotations

import gzip
import io
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence

import numpy as np

from ..config.schema import DataSchema


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


def read_file(path: str, delimiter: str = "|") -> np.ndarray:
    """Read one local gzip or plain delimited file into (N, C) float32."""
    with open_maybe_gzip(path) as f:
        raw = f.read()
    return parse_rows(raw, delimiter)


def read_files(paths: Sequence[str], delimiter: str = "|",
               num_threads: Optional[int] = None) -> list[np.ndarray]:
    """Read many files concurrently (inflate and parse release the GIL in
    part), preserving input order."""
    if num_threads is None:
        num_threads = min(len(paths), os.cpu_count() or 1)
    if num_threads <= 1 or len(paths) <= 1:
        return [read_file(p, delimiter) for p in paths]
    with ThreadPoolExecutor(max_workers=num_threads) as pool:
        return list(pool.map(lambda p: read_file(p, delimiter), paths))


def list_data_files(root: str) -> list[str]:
    """Data files under a local directory, skipping '.'/'_' prefixed names
    (the reference's HDFS listing filter); a file path lists itself."""
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
