"""Training on one device: `train(job, ...)` (train/loop.py)."""

from .loop import EpochMetrics, TrainResult, evaluate, init_state, train

__all__ = ["EpochMetrics", "TrainResult", "evaluate", "init_state", "train"]
