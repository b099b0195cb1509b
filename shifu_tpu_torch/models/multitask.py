"""Multi-task model (port of shifu_tpu/models/multitask.py): a shared
`MLPTrunk` named `trunk`, then for each head h a tower `tower_{h}` of
width max(hidden[-1] // 2, 4) with the last hidden activation and a 1-unit
logit `shifu_output_{h}`; the logits are concatenated to float32 (B, H).
The loss averages the per-head weighted losses
(ops/losses.multitask_loss); the scorer applies the sigmoid."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..config.schema import ModelSpec
from .base import MLPTrunk, ShifuDense, dtype_of


class MultiTask(nn.Module):

    def __init__(self, spec: ModelSpec, in_features: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cdt = dtype_of(spec.compute_dtype)
        self.num_heads = spec.num_heads
        self.trunk = MLPTrunk(spec, in_features, generator)
        width = max(spec.hidden_nodes[-1] // 2, 4)
        for h in range(spec.num_heads):
            self.add_module(f"tower_{h}", ShifuDense(
                self.trunk.out_features, width, spec.activations[-1],
                spec.xavier_bias_init, spec.compute_dtype, generator,
                param_dtype=spec.param_dtype))
            self.add_module(f"shifu_output_{h}", ShifuDense(
                width, 1, None, spec.xavier_bias_init, spec.compute_dtype,
                generator, param_dtype=spec.param_dtype))

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        x = self.trunk(features.to(self.cdt))
        logits = [getattr(self, f"shifu_output_{h}")(
            getattr(self, f"tower_{h}")(x)) for h in range(self.num_heads)]
        return torch.cat(logits, dim=-1).float()
