"""Training: `train(job, ...)` (train/loop.py), its steps (train/step.py),
the train state and the checkpoints (train/checkpoint.py).  The JAX
package's `build_optimizer` is `optimizers.build_transform` here, and its
`make_forward_fn` is the artifact's scoring module
(`export.artifact.scoring_module`)."""

from .checkpoint import make_manager, restore, restore_latest, save
from .loop import EpochMetrics, TrainResult, evaluate, init_state, train
from .step import (make_device_epoch_step, make_epoch_scan_step,
                   make_eval_step, make_local_sgd_epoch_step, make_loss_fn,
                   make_train_step)
from .train_state import TrainState

__all__ = ["make_manager", "restore", "restore_latest", "save",
           "EpochMetrics", "TrainResult", "evaluate", "init_state", "train",
           "make_device_epoch_step", "make_local_sgd_epoch_step",
           "make_epoch_scan_step", "make_eval_step", "make_loss_fn",
           "make_train_step", "TrainState"]
