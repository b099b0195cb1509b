"""In-memory dataset and batch pipeline of the training path (port of the
single-host part of shifu_tpu/data/pipeline.py).

Files -> vectorized parse -> projected numpy columns -> the train/valid
split -> static-shape batches.  The features can be stored in the int8 wire
dtype at parse time (`feature_dtype` "int8c{clip}"), and the host-to-card
wire casts each batch (`wire_cast_fn`): int8 features on the grid of
`wire_params`, u8 targets and an elided all-ones weight column.  numpy has
no bfloat16, so a bfloat16 wire is cast on the card (`train/loop.py`), where
the model would cast its input anyway.
Epoch order is a pure function of (seed, epoch) through numpy's PCG64, the
same stream as the JAX package's, so both train on the same batches.

Waits for later slices (ROADMAP.md queue A): the parse-once cache (v2), the
streaming loader of the first epoch, `EpochFeeder`, the staged tier, the
out-of-core tier and multi-host sharding.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

from ..config.schema import DataConfig, DataSchema
from . import reader, split


@dataclasses.dataclass
class TabularDataset:
    """Feature/target/weight arrays for one partition (train or valid)."""

    features: np.ndarray  # (N, F) float32, or int8 on the wire grid
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


def _load_one(item: tuple[int, str], schema: DataSchema, data: DataConfig,
              feature_dtype: str) -> tuple[dict, np.ndarray]:
    """Parse + project + quantize + split one file."""
    file_idx, path = item
    cols = reader.project_columns(reader.read_file(path, data.delimiter),
                                  schema)
    if feature_dtype.startswith("int8"):
        # quantize once at load: the grid is static (wire_params), so this
        # equals quantizing at every batch, at a quarter of the host RAM
        scale, offset = wire_params(schema, data)
        cols["features"] = wire_quantize(cols["features"], scale, offset)
    elif feature_dtype != "float32":
        raise ValueError(f"feature_dtype {feature_dtype!r} not supported by "
                         "the port's loader; expected float32 or int8c<clip>")
    n = cols["features"].shape[0]
    row_ids = ((np.uint64(file_idx) << np.uint64(40))
               + np.arange(n, dtype=np.uint64))
    _, valid_mask = split.train_valid_mask(row_ids, data.valid_ratio,
                                           data.split_seed)
    return cols, valid_mask


def load_datasets(schema: DataSchema, data: DataConfig,
                  feature_dtype: str = "float32"
                  ) -> tuple[TabularDataset, TabularDataset]:
    """Load (train, valid) from `data.paths` on one host, no cache.

    Rows split train/valid by the stable hash of (file index, row index)
    (`split.train_valid_mask`); the training partition then gets one global
    row shuffle seeded by `split_seed ^ 0xC0FFEE`, as in the JAX package."""
    from concurrent.futures import ThreadPoolExecutor

    # (file index, path) in config order; the index keys the row ids of
    # the train/valid split
    files = list(enumerate(f for p in data.paths
                           for f in reader.list_data_files(p)))
    width = data.ingest_workers or data.read_threads or len(files)
    width = max(1, min(width, len(files)))
    with ThreadPoolExecutor(max_workers=width) as pool:
        results = list(pool.map(
            lambda it: _load_one(it, schema, data, feature_dtype), files))
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
