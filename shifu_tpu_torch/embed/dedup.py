"""Per-batch unique-id compaction (port of shifu_tpu/embed/dedup.py).

A tabular batch touches far fewer distinct table rows than it has id cells.
`attach_dedup` compacts each host batch to its per-field unique ids, before
the wire cast, and adds `(embed_unique, embed_inverse)` to the batch dict;
the sparse update (train/sparse_embed.py) then updates each touched row
once.  The unique array is padded with the sentinel id V (one past the last
row) up to the batch size, so its shape is the same for every batch; the
update skips the sentinel.

There is no journal in the port: the counts stay on the transform's
`dedup_state` (batches, unique rows touched, raw id cells).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..ops.embedding import embedding_lookup

# batch keys: the sparse apply reads embed_unique; embed_inverse rides
# along for `dedup_lookup`
UNIQUE_KEY = "embed_unique"
INVERSE_KEY = "embed_inverse"


def host_ids(features: np.ndarray, layout) -> np.ndarray:
    """(B, F) float features -> (B, Nc) int32 ids, by the rule of the port's
    `models/embedding.split_features`, so that the compacted ids are exactly
    the rows the forward gathers: NaN reads as 0, the float is clamped into
    [0, vocab - 1] per field and then truncated.  (The JAX package casts
    first and clips after; numpy turns a float of 2^31 or more into INT_MIN,
    which its clip then sends to 0 where its forward uses vocab - 1.)"""
    raw = np.asarray(features)[:, np.asarray(layout.categorical_positions,
                                             np.int64)].astype(np.float32)
    hi = np.asarray(layout.vocab_sizes, np.float32) - 1
    raw = np.nan_to_num(raw, nan=0.0)
    return np.minimum(np.maximum(raw, np.float32(0.0)), hi).astype(np.int32)


def dedup_ids(ids: np.ndarray, sentinel: int,
              capacity: Optional[int] = None
              ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-field unique compaction of a (B, Nc) id batch: (unique
    (capacity, Nc) int32 padded with `sentinel`, inverse (B, Nc) int32 with
    ids[b, f] == unique[inverse[b, f], f], counts (Nc,) int64 distinct ids
    per field).  capacity defaults to B."""
    b, nc = ids.shape
    if capacity is None:
        capacity = b
    unique = np.full((capacity, nc), sentinel, np.int32)
    inverse = np.empty((b, nc), np.int32)
    counts = np.empty((nc,), np.int64)
    for f in range(nc):
        u, inv = np.unique(ids[:, f], return_inverse=True)
        if u.size > capacity:
            raise ValueError(f"dedup capacity {capacity} < {u.size} distinct "
                             f"ids (field {f})")
        unique[:u.size, f] = u
        inverse[:, f] = inv.reshape(-1)
        counts[f] = u.size
    return unique, inverse, counts


def attach_dedup(layout, sentinel: int) -> Callable[[dict], dict]:
    """Host-side batch transform: adds UNIQUE_KEY and INVERSE_KEY to each
    batch dict that holds a (B, F) 'features' matrix (others pass
    unchanged).  It reads the f32 features, so it runs before the wire
    cast.  `transform.dedup_state` counts batches, unique rows and raw id
    cells."""
    state = {"batches": 0, "unique": 0, "cells": 0}

    def transform(batch: dict) -> dict:
        feats = batch.get("features")
        if feats is None or getattr(feats, "ndim", 0) != 2:
            return batch
        ids = host_ids(feats, layout)
        unique, inverse, counts = dedup_ids(ids, sentinel)
        out = dict(batch)
        out[UNIQUE_KEY] = unique
        out[INVERSE_KEY] = inverse
        state["batches"] += 1
        state["unique"] += int(counts.sum())
        state["cells"] += int(ids.size)
        return out

    transform.dedup_state = state
    return transform


def dedup_lookup(table: torch.Tensor, unique: torch.Tensor,
                 inverse: torch.Tensor) -> torch.Tensor:
    """The lookup through the compacted ids: gather the unique rows once
    (the sentinel rows come back NaN and are never selected), then expand
    to (B, Nc, D) with the inverse map.  The same values as the raw-id
    lookup; the gradient sums duplicate rows in another order."""
    rows = embedding_lookup(table, unique)                     # (U, Nc, D)
    return torch.take_along_dim(rows, inverse.long()[:, :, None], dim=0)
