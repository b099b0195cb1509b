"""Deterministic train/valid row split (port of shifu_tpu/data/split.py,
unchanged: the same hash gives the same partition in both packages).

The reference re-draws `random.random() >= VALID_TRAINING_DATA_RATIO` per row
per run (reference: resources/ssgd_monitor.py:395), so the partition changes
across restarts — documented as a quirk (SURVEY.md section 5.9).  Here each row
gets a stable uniform in [0,1) from an integer hash of (seed, global row id),
so resume/restart and every host agree on the partition.
"""

from __future__ import annotations

import numpy as np

_GOLDEN = np.uint64(0x9E3779B97F4A7C15)


def _splitmix64(x: np.ndarray) -> np.ndarray:
    """Vectorized splitmix64 finalizer: uint64 -> well-mixed uint64."""
    with np.errstate(over="ignore"):
        z = x + _GOLDEN
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return z ^ (z >> np.uint64(31))


def row_uniform(row_ids: np.ndarray, seed: int = 0) -> np.ndarray:
    """Stable uniform [0,1) per row id."""
    ids = row_ids.astype(np.uint64)
    with np.errstate(over="ignore"):
        mixed = _splitmix64(ids ^ _splitmix64(np.full_like(ids, np.uint64(seed & (2**64 - 1)))))
    return (mixed >> np.uint64(11)).astype(np.float64) / float(1 << 53)


def train_valid_mask(
    row_ids: np.ndarray,
    valid_ratio: float,
    seed: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """Return (train_mask, valid_mask) boolean arrays.

    A row is validation iff its stable uniform < valid_ratio — the
    deterministic analog of the reference's `random.random() >= ratio` branch
    (ssgd_monitor.py:395).
    """
    u = row_uniform(row_ids, seed)
    valid = u < valid_ratio
    return ~valid, valid


def bagging_mask(row_ids: np.ndarray, sample_rate: float, seed: int = 1) -> np.ndarray:
    """Deterministic bagging subsample (Shifu train.baggingSampleRate)."""
    if sample_rate >= 1.0:
        return np.ones(row_ids.shape[0], dtype=bool)
    return row_uniform(row_ids, seed ^ 0x5ADB) < sample_rate
