"""Train state (port of shifu_tpu/train/train_state.py): the module, its
optimizer and the step counter.

The JAX package keeps params, optimizer state and step as one immutable
pytree; the port holds the `nn.Module` (its parameters are the params), an
`Optimizer` that updates them in place, and `step`, the number of
optimizer updates applied (micro-steps of gradient accumulation included,
as `TrainState.step` counts them).  Under a sparse embedding plan
(train/sparse_embed.py) the optimizer holds every parameter but the
embedding tables, and `table_slots` holds the tables' moment slots by
parameter name; it is None for a dense job.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from torch import nn

from .optimizers import Optimizer


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: Optimizer
    step: int = 0
    table_slots: Optional[dict] = None

    def apply_gradients(self) -> "TrainState":
        """One dense optimizer update from the parameters' .grad."""
        self.optimizer.step()
        self.step += 1
        return self
