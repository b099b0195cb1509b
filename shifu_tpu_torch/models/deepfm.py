"""DeepFM (port of shifu_tpu/models/deepfm.py): the BASELINE ladder's CTR
rung with high-cardinality categoricals.

Every selected column is a field with a k-dim vector (categorical fields by
table lookup, numeric fields by value-scaled vectors).  The components
share those vectors: the first-order sum of per-field scalars, the FM
second-order term 0.5 * ((sum_f v_f)^2 - sum_f v_f^2) summed over k, and the
MLP trunk over the flattened vectors.  The k-dim table and the scalar
first-order table read the same ids, so they share one lookup
(`fused_lookup`).  Dtypes follow the JAX module: the first-order term in
the compute dtype, the FM term in the field vectors' dtype (float32 where
numeric vectors meet float32 params) and cast to float32 after its sums,
the output float32.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..config.schema import ModelSpec
from .base import MLPTrunk, ShifuDense, cat_promoted, dtype_of
from .embedding import FieldLayout, NumericEmbed, fused_lookup, \
    paired_cat_embed, split_features


class DeepFM(nn.Module):
    def __init__(self, spec: ModelSpec, layout: FieldLayout,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.layout = layout
        self.cdt = dtype_of(spec.compute_dtype)
        k, heads, pdt = spec.embedding_dim, spec.num_heads, spec.param_dtype
        if layout.num_numeric:
            self.numeric_embedding = NumericEmbed(
                layout, k, spec.compute_dtype, generator, pdt)
        if layout.num_categorical:
            self.cat_embedding, self.first_order_cat = paired_cat_embed(
                layout, spec, generator)
        self.first_order_numeric = ShifuDense(
            layout.num_numeric, heads, None, spec.xavier_bias_init,
            spec.compute_dtype, generator, param_dtype=pdt)
        self.trunk = MLPTrunk(spec, layout.num_fields * k, generator)
        self.shifu_output_0 = ShifuDense(
            self.trunk.out_features, heads, None, spec.xavier_bias_init,
            spec.compute_dtype, generator, param_dtype=pdt)

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        numeric, ids = split_features(features, self.layout)
        vecs = []
        cat_first = None
        if self.layout.num_numeric:
            vecs.append(self.numeric_embedding(numeric))
        if self.layout.num_categorical:
            cat_vec, cat_first = fused_lookup(
                [self.cat_embedding, self.first_order_cat], ids)
            vecs.append(cat_vec)
        v = cat_promoted(vecs, dim=1)                          # (B, F, k)

        first = self.first_order_numeric(numeric.to(self.cdt))  # (B, H)
        if cat_first is not None:
            first = first + cat_first.sum(dim=1)

        sum_sq = torch.square(v.sum(dim=1))
        sq_sum = torch.square(v).sum(dim=1)
        fm = 0.5 * (sum_sq - sq_sum).sum(dim=-1, keepdim=True)

        deep = self.shifu_output_0(self.trunk(v.reshape(v.shape[0], -1)))
        return (first + fm.float() + deep).float()
