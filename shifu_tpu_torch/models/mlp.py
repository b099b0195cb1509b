"""The Shifu MLP (port of shifu_tpu/models/mlp.py): input (B, F) float ->
hidden xavier dense layers -> `shifu_output_0` head; emits float32 logits
(B, num_heads), the sigmoid is applied by the scorer."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..config.schema import ModelSpec
from .base import MLPTrunk, ScoringHead, dtype_of


class ShifuMLP(nn.Module):
    def __init__(self, spec: ModelSpec, num_features: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cdt = dtype_of(spec.compute_dtype)
        self.trunk = MLPTrunk(spec, num_features, generator)
        self.head = ScoringHead(spec, self.trunk.out_features, generator)

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        return self.head(self.trunk(features.to(self.cdt)))
