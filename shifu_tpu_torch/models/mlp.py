"""The Shifu MLP (port of shifu_tpu/models/mlp.py): input (B, F) float ->
hidden xavier dense layers -> `shifu_output_0` head; emits float32 logits
(B, num_heads), the sigmoid is applied by the scorer."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..config.schema import ModelSpec
from .base import MLPTrunk, ScoringHead, Wire, dtype_of


class ShifuMLP(nn.Module):
    """`wire`: the int8 grid when the training loop feeds wire-format
    features straight into the model; layer 0 then takes int8 inputs
    (models/base._WireDense)."""

    def __init__(self, spec: ModelSpec, num_features: int,
                 generator: Optional[torch.Generator] = None,
                 wire: Optional[Wire] = None):
        super().__init__()
        self.cdt = dtype_of(spec.compute_dtype)
        self.wire = wire
        self.trunk = MLPTrunk(spec, num_features, generator, wire)
        self.head = ScoringHead(spec, self.trunk.out_features, generator)

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        if not (self.wire is not None and features.dtype == torch.int8):
            features = features.to(self.cdt)
        return self.head(self.trunk(features))
