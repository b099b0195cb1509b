"""Wide&Deep (port of shifu_tpu/models/wide_deep.py): the BASELINE ladder's
~1000-column risk-scoring rung.

Wide: a linear model over the numeric features plus a per-field,
per-id bias (degree-1 memorization).  Deep: the ModelConfig MLP trunk over
[numeric, flattened categorical embeddings].  The per-id bias table and the
deep embedding read the same ids, so they share one lookup
(`fused_lookup`).  Submodules carry the Flax tree's names, so an
artifact's weights map onto the state_dict by name.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..config.schema import ModelSpec
from .base import MLPTrunk, ShifuDense, dtype_of
from .embedding import FieldLayout, fused_lookup, paired_cat_embed, \
    split_features


class WideDeep(nn.Module):
    def __init__(self, spec: ModelSpec, layout: FieldLayout,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.layout = layout
        self.cdt = dtype_of(spec.compute_dtype)
        heads, pdt = spec.num_heads, spec.param_dtype
        self.wide_linear = ShifuDense(
            layout.num_numeric, heads, None, spec.xavier_bias_init,
            spec.compute_dtype, generator, param_dtype=pdt)
        if layout.num_categorical:
            self.deep_embedding, self.wide_cat_embedding = paired_cat_embed(
                layout, spec, generator)
        self.trunk = MLPTrunk(
            spec, layout.num_numeric
            + layout.num_categorical * spec.embedding_dim, generator)
        self.shifu_output_0 = ShifuDense(
            self.trunk.out_features, heads, None, spec.xavier_bias_init,
            spec.compute_dtype, generator, param_dtype=pdt)

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        numeric, ids = split_features(features, self.layout)
        numeric = numeric.to(self.cdt)
        wide = self.wide_linear(numeric)
        deep_in = numeric
        if self.layout.num_categorical:
            emb, cat_bias = fused_lookup(
                [self.deep_embedding, self.wide_cat_embedding], ids)
            wide = wide + cat_bias.sum(dim=1)
            deep_in = torch.cat([numeric, emb.reshape(emb.shape[0], -1)],
                                dim=-1)
        deep = self.shifu_output_0(self.trunk(deep_in))
        return (wide + deep).float()
