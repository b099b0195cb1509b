"""Batch scoring seam and the port's engine (port of the `BatchScorer` seam
and the `JaxScorer` role of shifu_tpu/export/scorer.py).

`TorchScorer` rebuilds the model from an artifact, loads its weights
through `params_from_jax`, and scores on the card (or on the CPU when asked)
under `torch.inference_mode()`.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from .artifact import load_artifact, params_from_jax


class BatchScorer:
    """The batch-dispatch seam the serving daemon wraps.

    Subclasses set `engine`, `num_features` and implement `_score_batch(x)`
    on a validated (N, F) float32 matrix; the seam owns input coercion and
    the width check.  `static_shapes` tells the daemon to pad batches up its
    bucket ladder.  `n_valid` is accepted for the daemon's padded batches
    (the rows past it are padding)."""

    engine = "base"
    static_shapes = False
    num_features: int

    def _score_batch(self, x: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def _as_batch(self, rows) -> np.ndarray:
        x = np.asarray(rows, dtype=np.float32)
        if x.ndim == 1:
            x = x[None, :]
        if x.ndim != 2 or x.shape[1] != self.num_features:
            raise ValueError(
                f"expected {self.num_features} features, got "
                f"{x.shape[-1] if x.ndim else 0}")
        return x

    def compute_batch(self, rows, n_valid: Optional[int] = None
                      ) -> np.ndarray:
        """Score (N, F) float rows -> (N, num_heads) probabilities."""
        return self._score_batch(self._as_batch(rows))

    def compute(self, row: Sequence[float]) -> float:
        """Single-row score in [0, 1] (the reference's call shape)."""
        return float(self.compute_batch(
            np.asarray(row, dtype=np.float64))[0, 0])


class TorchScorer(BatchScorer):
    """Scores an artifact with the port's model on `device` (default
    `cuda:0`; raises where CUDA is absent unless `device="cpu"`)."""

    engine = "torch"
    static_shapes = True  # the daemon pads to its bucket ladder

    def __init__(self, export_dir: str, device: DeviceLike = None):
        from ..models.registry import build_model

        self.device = resolve_device(device)
        art = load_artifact(export_dir)
        extra = art.sidecar.get("inputnames", ["shifu_input_0"])[1:]
        if extra:
            raise ValueError(
                f"artifact declares extra named inputs {extra}; the torch "
                "engine replays the single-input model and cannot bind them")
        self.topology = art.topology
        self.spec = art.spec
        self.num_features = int(art.topology["num_features"])
        self.model = build_model(art.spec, art.schema, self.device)
        self.model.load_state_dict(params_from_jax(art.weights, self.model))

    def _score_batch(self, x: np.ndarray) -> np.ndarray:
        with torch.inference_mode():
            feats = torch.from_numpy(x).to(self.device)
            probs = torch.sigmoid(self.model(feats).float())
            return probs.cpu().numpy()
