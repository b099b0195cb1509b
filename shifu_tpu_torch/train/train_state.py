"""Train state (port of shifu_tpu/train/train_state.py): the module, its
optimizer and the step counter.

The JAX package keeps params, optimizer state and step as one immutable
pytree; the port holds the `nn.Module` (its parameters are the params), an
`Optimizer` that updates them in place, and `step`, the number of
optimizer updates applied (micro-steps of gradient accumulation included,
as `TrainState.step` counts them).
"""

from __future__ import annotations

import dataclasses

from torch import nn

from .optimizers import Optimizer


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: Optimizer
    step: int = 0

    def apply_gradients(self) -> "TrainState":
        """One optimizer update from the parameters' .grad."""
        self.optimizer.step()
        self.step += 1
        return self
