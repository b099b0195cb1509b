"""Mergeable streaming distribution sketches for drift detection (a copy
of shifu_tpu/obs/sketch.py: numpy only).

The train loop builds a reference profile from the training partition
(`build_profile`), `export/artifact.save_artifact` freezes it into the
artifact as `baseline_profile.json`, and the scoring daemon accumulates the
same sketch shape over live traffic, so obs/drift.py can diff the two (PSI
per feature, mean shift, score KL).

- Fixed grid, not data-derived: feature histograms ride the int8 wire
  grid (data/pipeline.wire_params, `q = round((x - offset) / scale)`
  saturated to [-127, 127]), the same 255-bucket axis on the training
  host, in the artifact and in every serving replica, so histograms from
  different processes add and compare directly.  Int8 wire bytes bin
  without dequantization.
- One flattened bincount per batch: all F features bin in a single
  `np.bincount` over `(q + 127) + feature_index * 255`.

Every sketch's state is additive (counts and moment sums), which gives
both `merge` and trailing windows by cumulative-snapshot subtraction
(obs/drift.py).  Mean and variance derive from the grid histogram: exact
for int8 traffic, within scale/2 per value for f32.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

# the int8 wire grid: values live on [-127, 127] -> 255 buckets
N_BUCKETS = 255
# PSI rebins the 255 fine buckets into coarse groups (255 = 17 * 15):
# fine enough to localize a shift, coarse enough that a healthy window
# populates every group and the epsilon smoothing stays negligible
PSI_GROUPS = 17
_PSI_FOLD = N_BUCKETS // PSI_GROUPS  # 15

# score-distribution sketch: sigmoid outputs on [0, 1]
SCORE_BINS = 64

_EPS = 1e-6

PROFILE_KIND = "shifu_tpu_baseline_profile"
PROFILE_VERSION = 1


def default_grid(num_features: int,
                 clip: float = 8.0) -> tuple[np.ndarray, np.ndarray]:
    """The static per-feature (scale, offset) of the int8 wire grid —
    the same pure-function-of-config grid data/pipeline.wire_params
    builds (scale = clip/127, offset = 0), duplicated here so sketches
    stay importable without the data plane (serving daemons and CLI
    renderers never touch DataSchema)."""
    f = int(num_features)
    scale = np.full((f,), float(clip) / 127.0, np.float32)
    offset = np.zeros((f,), np.float32)
    return scale, offset


class FeatureSketch:
    """Per-feature streaming distribution sketch on the int8 wire grid.

    State: one (F, 255) count matrix.  `update` takes a (B, F) batch —
    int8 wire bytes bin directly, float features quantize through the
    SAME grid first (one vectorized pass) — and costs one flattened
    bincount.  Moments (`moments()`) derive from the histogram: exact
    for int8 input, within scale/2 per value for floats.  NOT
    thread-safe; callers serialize (the daemon's dispatch worker is the
    only writer, snapshots copy under the daemon's drift lock)."""

    def __init__(self, num_features: int,
                 scale: Optional[np.ndarray] = None,
                 offset: Optional[np.ndarray] = None):
        self.num_features = int(num_features)
        if scale is None or offset is None:
            scale, offset = default_grid(self.num_features)
        self.scale = np.asarray(scale, np.float32).reshape(-1)
        self.offset = np.asarray(offset, np.float32).reshape(-1)
        if self.scale.shape[0] != self.num_features \
                or self.offset.shape[0] != self.num_features:
            raise ValueError(
                f"grid shape mismatch: {self.scale.shape[0]} scales / "
                f"{self.offset.shape[0]} offsets for "
                f"{self.num_features} features")
        self.hist = np.zeros((self.num_features, N_BUCKETS), np.int64)
        self.rows = 0
        # flattened-bincount index offset, built once: feature j's bucket
        # q lands at j*255 + (q+127)
        self._feat_base = (np.arange(self.num_features, dtype=np.int64)
                           * N_BUCKETS)

    # -- accumulation --------------------------------------------------

    def update(self, x: np.ndarray) -> None:
        """Accumulate a (B, F) batch — int8 bins as-is (the bytes on the
        wire ARE the bucket ids), anything else quantizes through the
        grid first.  One bincount for all F features."""
        x = np.asarray(x)
        if x.ndim == 1:
            x = x[None, :]
        if x.shape[1] != self.num_features:
            raise ValueError(f"batch has {x.shape[1]} features, sketch "
                             f"has {self.num_features}")
        if x.shape[0] == 0:
            return
        if x.dtype == np.int8:
            q = x.astype(np.int64)
        else:
            xf = np.asarray(x, np.float32)
            q = np.clip(np.rint((xf - self.offset) * (1.0 / self.scale)),
                        -127, 127).astype(np.int64)
        idx = (q + 127) + self._feat_base  # (B, F), values < F*255
        flat = np.bincount(idx.ravel(),
                           minlength=self.num_features * N_BUCKETS)
        self.hist += flat.reshape(self.num_features, N_BUCKETS)
        self.rows += int(x.shape[0])

    def merge(self, other: "FeatureSketch") -> "FeatureSketch":
        """Add another sketch's counts into this one (same grid)."""
        if other.num_features != self.num_features:
            raise ValueError("cannot merge sketches with different "
                             f"feature counts ({self.num_features} vs "
                             f"{other.num_features})")
        if not (np.allclose(self.scale, other.scale)
                and np.allclose(self.offset, other.offset)):
            raise ValueError("cannot merge sketches on different grids")
        self.hist += other.hist
        self.rows += other.rows
        return self

    # -- readouts ------------------------------------------------------

    def grid_values(self) -> np.ndarray:
        """(F, 255) feature value at each bucket center:
        q*scale + offset for q in [-127, 127]."""
        q = np.arange(-127, 128, dtype=np.float64)
        return (q[None, :] * self.scale[:, None].astype(np.float64)
                + self.offset[:, None].astype(np.float64))

    def moments(self) -> tuple[np.ndarray, np.ndarray]:
        """Per-feature (mean, variance) from the grid histogram — the
        streaming-moments readout (additive across merges by
        construction: summed counts ARE the parallel-Welford combine)."""
        n = self.hist.sum(axis=1).astype(np.float64)
        safe_n = np.maximum(n, 1.0)
        v = self.grid_values()
        s = (self.hist * v).sum(axis=1)
        ss = (self.hist * v * v).sum(axis=1)
        mean = s / safe_n
        var = np.maximum(ss / safe_n - mean * mean, 0.0)
        mean = np.where(n > 0, mean, 0.0)
        var = np.where(n > 1, var, 0.0)
        return mean, var

    # -- serialization -------------------------------------------------

    def to_dict(self) -> dict:
        mean, var = self.moments()
        return {
            "num_features": self.num_features,
            "rows": int(self.rows),
            "scale": [round(float(s), 8) for s in self.scale],
            "offset": [round(float(o), 8) for o in self.offset],
            "hist": self.hist.tolist(),
            "mean": [round(float(m), 6) for m in mean],
            "var": [round(float(v), 6) for v in var],
        }

    @classmethod
    def from_dict(cls, d: dict) -> "FeatureSketch":
        sk = cls(int(d["num_features"]),
                 scale=np.asarray(d["scale"], np.float32),
                 offset=np.asarray(d["offset"], np.float32))
        hist = np.asarray(d["hist"], np.int64)
        if hist.shape != sk.hist.shape:
            raise ValueError(f"histogram shape {hist.shape} does not "
                             f"match ({sk.num_features}, {N_BUCKETS})")
        sk.hist = hist
        sk.rows = int(d.get("rows", hist.sum(axis=1).max(initial=0)))
        return sk


class ScoreSketch:
    """Streaming sketch of the score distribution: a fixed-bin histogram
    over [0, 1] (sigmoid outputs) plus exact additive moments — the
    serving side of the score-KL drift axis and the profile's record of
    what the model's output looked like on the frozen epoch."""

    def __init__(self, bins: int = SCORE_BINS):
        self.bins = int(bins)
        self.hist = np.zeros(self.bins, np.int64)
        self.n = 0
        self.sum = 0.0
        self.sumsq = 0.0

    def update(self, scores: np.ndarray) -> None:
        s = np.asarray(scores, np.float64).ravel()
        if s.size == 0:
            return
        idx = np.clip((s * self.bins).astype(np.int64), 0, self.bins - 1)
        self.hist += np.bincount(idx, minlength=self.bins)
        self.n += int(s.size)
        self.sum += float(s.sum())
        self.sumsq += float((s * s).sum())

    def merge(self, other: "ScoreSketch") -> "ScoreSketch":
        if other.bins != self.bins:
            raise ValueError(f"cannot merge score sketches with "
                             f"different bins ({self.bins} vs "
                             f"{other.bins})")
        self.hist += other.hist
        self.n += other.n
        self.sum += other.sum
        self.sumsq += other.sumsq
        return self

    def mean(self) -> float:
        return self.sum / self.n if self.n else 0.0

    def var(self) -> float:
        if self.n < 2:
            return 0.0
        m = self.mean()
        return max(self.sumsq / self.n - m * m, 0.0)

    def to_dict(self) -> dict:
        return {"bins": self.bins, "n": int(self.n),
                "sum": round(self.sum, 6), "sumsq": round(self.sumsq, 6),
                "hist": self.hist.tolist()}

    @classmethod
    def from_dict(cls, d: dict) -> "ScoreSketch":
        sk = cls(int(d["bins"]))
        hist = np.asarray(d["hist"], np.int64)
        if hist.shape != sk.hist.shape:
            raise ValueError(f"score histogram has {hist.shape[0]} bins, "
                             f"expected {sk.bins}")
        sk.hist = hist
        sk.n = int(d.get("n", hist.sum()))
        sk.sum = float(d.get("sum", 0.0))
        sk.sumsq = float(d.get("sumsq", 0.0))
        return sk


# ------------------------------------------------------ divergence math


def _normalize(counts: np.ndarray) -> np.ndarray:
    """Counts -> epsilon-smoothed probabilities along the last axis."""
    c = np.asarray(counts, np.float64)
    total = c.sum(axis=-1, keepdims=True)
    p = c / np.maximum(total, 1.0) + _EPS
    return p / p.sum(axis=-1, keepdims=True)


def psi(expected_counts: np.ndarray, actual_counts: np.ndarray,
        groups: int = PSI_GROUPS) -> np.ndarray:
    """Population Stability Index per feature over rebinned buckets.

    Both inputs are (..., 255) fine-grid counts; the 255 buckets fold
    into `groups` coarse groups (255 = 17*15) before the classic
    ``sum((p - q) * ln(p / q))`` with epsilon smoothing — the smoothing
    bounds a group empty on one side instead of blowing up to inf.
    Returns a (...,) array (scalar-shaped for a single feature).  The
    conventional reading: < 0.1 stable, 0.1-0.25 moderate shift,
    > 0.25 significant."""
    e = np.asarray(expected_counts, np.float64)
    a = np.asarray(actual_counts, np.float64)
    if e.shape[-1] != a.shape[-1]:
        raise ValueError(f"bucket counts differ: {e.shape[-1]} vs "
                         f"{a.shape[-1]}")
    nb = e.shape[-1]
    if groups > 1 and nb % groups == 0:
        fold = nb // groups
        e = e.reshape(e.shape[:-1] + (groups, fold)).sum(axis=-1)
        a = a.reshape(a.shape[:-1] + (groups, fold)).sum(axis=-1)
    p = _normalize(e)
    q = _normalize(a)
    return ((q - p) * np.log(q / p)).sum(axis=-1)


def kl_divergence(p_counts: np.ndarray, q_counts: np.ndarray) -> float:
    """KL(p || q) over two same-shape count vectors with epsilon
    smoothing — the score-distribution drift axis (baseline || live)."""
    p = _normalize(np.asarray(p_counts, np.float64).ravel())
    q = _normalize(np.asarray(q_counts, np.float64).ravel())
    return float((p * np.log(p / q)).sum())


def mean_shift_sigmas(base_mean: np.ndarray, base_var: np.ndarray,
                      live_mean: np.ndarray) -> np.ndarray:
    """|live_mean - base_mean| in units of the baseline's per-feature
    std — the first-moment drift axis (cheap, interpretable, catches a
    pure translation even when PSI is diluted across buckets)."""
    sd = np.sqrt(np.maximum(np.asarray(base_var, np.float64), 0.0))
    sd = np.maximum(sd, _EPS)
    return np.abs(np.asarray(live_mean, np.float64)
                  - np.asarray(base_mean, np.float64)) / sd


# --------------------------------------------------- the frozen profile


def build_profile(features: FeatureSketch, score: ScoreSketch,
                  feature_names: Optional[Sequence[str]] = None,
                  train_auc: Optional[float] = None,
                  train_error: Optional[float] = None,
                  epoch: Optional[int] = None) -> dict:
    """The ``baseline_profile.json`` payload: the frozen stats epoch the
    drift engine diffs live traffic against.  JSON-serializable, fully
    self-describing (grid + histograms + moments + score sketch +
    training AUC), rebuildable into sketches via `profile_sketches`."""
    prof = {
        "kind": PROFILE_KIND,
        "version": PROFILE_VERSION,
        "num_features": features.num_features,
        "rows": int(features.rows),
        "features": features.to_dict(),
        "score": score.to_dict(),
    }
    if feature_names is not None:
        names = [str(n) for n in feature_names]
        if len(names) == features.num_features:
            prof["feature_names"] = names
    if train_auc is not None and not np.isnan(train_auc):
        prof["train_auc"] = round(float(train_auc), 6)
    if train_error is not None and not np.isnan(train_error):
        prof["train_error"] = round(float(train_error), 6)
    if epoch is not None:
        prof["epoch"] = int(epoch)
    return prof


def validate_profile(profile: dict) -> dict:
    """Structural check on a loaded baseline profile; returns it.
    Raises ValueError with a precise reason — the caller (drift plane)
    degrades to drift-disabled, never serves garbage comparisons."""
    if not isinstance(profile, dict):
        raise ValueError("baseline profile is not a JSON object")
    if profile.get("kind") != PROFILE_KIND:
        raise ValueError(f"not a baseline profile (kind="
                         f"{profile.get('kind')!r})")
    if int(profile.get("version", 0)) > PROFILE_VERSION:
        raise ValueError(f"baseline profile version "
                         f"{profile.get('version')} is newer than this "
                         f"reader ({PROFILE_VERSION})")
    for key in ("features", "score"):
        if key not in profile:
            raise ValueError(f"baseline profile missing {key!r}")
    return profile


def profile_sketches(profile: dict) -> tuple[FeatureSketch, ScoreSketch]:
    """Rebuild the (FeatureSketch, ScoreSketch) pair from a profile."""
    validate_profile(profile)
    return (FeatureSketch.from_dict(profile["features"]),
            ScoreSketch.from_dict(profile["score"]))


def profile_summary(profile: dict) -> dict:
    """Compact journal-safe summary of a profile (the per-epoch
    `baseline_profile` event body: no histograms, bounded bytes)."""
    feats = profile.get("features") or {}
    score = profile.get("score") or {}
    out = {
        "rows": int(profile.get("rows", 0)),
        "num_features": int(profile.get("num_features", 0)),
        "score_mean": round(float(score.get("sum", 0.0))
                            / max(int(score.get("n", 0)), 1), 6),
    }
    if "train_auc" in profile:
        out["train_auc"] = profile["train_auc"]
    if "train_error" in profile:
        out["train_error"] = profile["train_error"]
    if "epoch" in profile:
        out["epoch"] = profile["epoch"]
    means = feats.get("mean")
    if means:
        out["feature_mean_min"] = round(float(min(means)), 6)
        out["feature_mean_max"] = round(float(max(means)), 6)
    return out
