"""Synthetic tabular data for tests and benchmarks (port of
shifu_tpu/data/synthetic.py: one seed gives the same rows in both packages).

Plays the role of the reference's bundled WDBC demo dataset (30 z-scaled
features, binary target — reference: resources/ssgd.py:20 FEATURE_COUNT=30):
a reproducible generator for normalized pipe-delimited rows with a learnable
logistic ground truth, plus writers that produce the exact gzip on-disk format
the reference trainer consumed (ssgd_monitor.py:375-385).
"""

from __future__ import annotations

import gzip
import os

import numpy as np

from ..config.schema import ColumnSpec, DataSchema


def make_schema(
    num_features: int = 30,
    with_weight: bool = False,
    num_categorical: int = 0,
    vocab_size: int = 100,
    num_targets: int = 1,
) -> DataSchema:
    """Column layout: [targets..., (weight,) f0..fN-1]; the last
    num_categorical features are categorical; num_targets > 1 models Shifu
    multi-target mode."""
    columns = [ColumnSpec(index=t, name=f"target{t}" if num_targets > 1 else "target",
                          is_target=True)
               for t in range(num_targets)]
    weight_index = -1
    offset = num_targets
    if with_weight:
        weight_index = offset
        columns.append(ColumnSpec(index=weight_index, name="wgt", is_weight=True))
        offset += 1
    selected = []
    for i in range(num_features):
        idx = offset + i
        is_cat = i >= num_features - num_categorical
        columns.append(ColumnSpec(
            index=idx, name=f"f{i}", is_selected=True,
            is_categorical=is_cat, vocab_size=vocab_size if is_cat else 0))
        selected.append(idx)
    return DataSchema(
        columns=tuple(columns),
        target_index=0,
        weight_index=weight_index,
        selected_indices=tuple(selected),
        target_indices=tuple(range(num_targets)) if num_targets > 1 else (),
    )


def make_rows(
    num_rows: int,
    schema: DataSchema,
    seed: int = 0,
    noise: float = 0.5,
) -> np.ndarray:
    """Generate (N, C) raw rows matching `schema` column indices.

    Numeric features ~ N(0,1) (post-ZSCALE normalization, like the reference's
    normalized input); categorical features are integer ids stored as floats.
    Target = Bernoulli(sigmoid(w.x + noise)) for a fixed random w, so models
    can beat AUC 0.5 by a wide, stable margin.
    """
    rng = np.random.default_rng(seed)
    ncols = max(c.index for c in schema.columns) + 1
    rows = np.zeros((num_rows, ncols), dtype=np.float32)

    cat_set = set(schema.categorical_indices)
    num_idx = [i for i in schema.selected_indices if i not in cat_set]
    by_index = {c.index: c for c in schema.columns}

    logits = np.zeros(num_rows, dtype=np.float64)
    if num_idx:
        x = rng.standard_normal((num_rows, len(num_idx))).astype(np.float32)
        rows[:, num_idx] = x
        w = rng.standard_normal(len(num_idx))
        w /= max(np.linalg.norm(w), 1e-9)  # unit norm: signal strength is
        logits += 1.5 * (x @ w)            # seed-independent (std 1.5)
    for i in sorted(cat_set):
        vocab = max(by_index[i].vocab_size, 2)
        ids = rng.integers(0, vocab, size=num_rows)
        rows[:, i] = ids.astype(np.float32)
        effect = rng.standard_normal(vocab) * 0.5
        logits += effect[ids]

    for h, t_idx in enumerate(schema.all_target_indices):
        # each target head mixes the shared logits with its own projection
        head_logits = logits + noise * rng.standard_normal(num_rows)
        if h > 0 and num_idx:
            w_h = rng.standard_normal(len(num_idx))
            w_h /= max(np.linalg.norm(w_h), 1e-9)
            head_logits = 0.5 * head_logits + 1.5 * (rows[:, num_idx] @ w_h)
        prob = 1.0 / (1.0 + np.exp(-head_logits))
        rows[:, t_idx] = (rng.random(num_rows) < prob).astype(np.float32)
    if schema.weight_index >= 0:
        rows[:, schema.weight_index] = rng.uniform(0.5, 2.0, num_rows).astype(np.float32)
    return rows


def write_files(
    rows: np.ndarray,
    directory: str,
    num_files: int = 4,
    delimiter: str = "|",
    compress: bool = True,
) -> list[str]:
    """Write rows as pipe-delimited gzip part files (the reference's on-disk
    normalized format, ssgd_monitor.py:375-385 + gzip)."""
    os.makedirs(directory, exist_ok=True)
    paths = []
    chunks = np.array_split(rows, num_files)
    for i, chunk in enumerate(chunks):
        name = f"part-{i:05d}" + (".gz" if compress else "")
        path = os.path.join(directory, name)
        lines = "\n".join(
            delimiter.join(_fmt(v) for v in row) for row in chunk)
        data = (lines + "\n").encode()
        if compress:
            with gzip.open(path, "wb") as f:
                f.write(data)
        else:
            with open(path, "wb") as f:
                f.write(data)
        paths.append(path)
    return paths


def _fmt(v: float) -> str:
    # integers (targets, categorical ids) print compactly
    if float(v).is_integer():
        return str(int(v))
    return f"{v:.6g}"
