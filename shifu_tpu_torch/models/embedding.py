"""Feature embeddings (port of shifu_tpu/models/embedding.py): field
layout, the numeric/categorical split, the categorical tables and the
numeric field vectors, and `fused_lookup`, one lookup for the tables that
share ids.  Every lookup goes through `ops/embedding.embedding_lookup`
(kernel #5 on the card; re-exported here)."""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
from torch import nn

from ..config.schema import DataSchema, ModelSpec
from ..ops.embedding import embedding_lookup
from ..ops.initializers import xavier_uniform
from .base import dtype_of


@dataclasses.dataclass(frozen=True)
class FieldLayout:
    """Positions of numeric vs categorical fields inside the (B, F) feature
    matrix (categorical cells hold integer ids stored as floats)."""

    numeric_positions: tuple[int, ...]
    categorical_positions: tuple[int, ...]
    vocab_sizes: tuple[int, ...]

    @property
    def num_numeric(self) -> int:
        return len(self.numeric_positions)

    @property
    def num_categorical(self) -> int:
        return len(self.categorical_positions)

    @property
    def num_fields(self) -> int:
        return self.num_numeric + self.num_categorical


def field_layout(schema: DataSchema) -> FieldLayout:
    cat_set = set(schema.categorical_indices)
    by_index = {c.index: c for c in schema.columns}
    numeric, cats, vocabs = [], [], []
    for pos, idx in enumerate(schema.selected_indices):
        if idx in cat_set:
            cats.append(pos)
            v = by_index[idx].vocab_size
            vocabs.append(v if v > 0 else 1024)  # hashed fallback vocab
        else:
            numeric.append(pos)
    return FieldLayout(tuple(numeric), tuple(cats), tuple(vocabs))


def split_features(features: torch.Tensor, layout: FieldLayout
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, F) float -> (numeric (B, Nn) float, categorical ids (B, Nc) int32).

    Ids truncate toward zero and clip per field into [0, vocab):
    out-of-range and unseen ids land in the bucket at the edge, as in the
    JAX package.  The clip is applied to the float before the integer cast
    (NaN reads as 0), so the cast never meets a value out of int32's range:
    XLA saturates such a cast, PyTorch leaves it undefined."""
    b = features.shape[0]
    dev = features.device
    if layout.num_numeric:
        num = features[:, torch.tensor(layout.numeric_positions, device=dev)]
    else:
        num = features.new_zeros((b, 0))
    if layout.num_categorical:
        raw = features[:, torch.tensor(layout.categorical_positions,
                                       device=dev)].float()
        hi = torch.tensor(layout.vocab_sizes, dtype=torch.float32,
                          device=dev) - 1
        raw = torch.nan_to_num(raw, nan=0.0)
        ids = torch.minimum(raw.clamp(min=0.0), hi).to(torch.int32)
    else:
        ids = torch.zeros((b, 0), dtype=torch.int32, device=dev)
    return num, ids


class CategoricalEmbed(nn.Module):
    """Per-field embedding tables stacked as one `embedding` param
    (num_fields, max_vocab, dim) in `param_dtype`; ids (B, Nc) ->
    (B, Nc, dim) in the compute dtype through `embedding_lookup`.
    `table()` is the compute-dtype table, for `fused_lookup`."""

    def __init__(self, layout: FieldLayout, dim: int,
                 compute_dtype: str = "bfloat16",
                 generator: Optional[torch.Generator] = None,
                 param_dtype: str = "float32"):
        super().__init__()
        self.layout = layout
        self.dim = dim
        self.cdt = dtype_of(compute_dtype)
        if layout.num_categorical:
            self.embedding = nn.Parameter(xavier_uniform(
                (layout.num_categorical, max(layout.vocab_sizes), dim),
                generator).to(dtype_of(param_dtype)))

    def table(self) -> torch.Tensor:
        return self.embedding.to(self.cdt)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        if self.layout.num_categorical == 0:
            return torch.zeros((ids.shape[0], 0, self.dim), dtype=self.cdt,
                               device=ids.device)
        return embedding_lookup(self.table(), ids)


def fused_lookup(embeds: Sequence[CategoricalEmbed], ids: torch.Tensor
                 ) -> list[torch.Tensor]:
    """One lookup for several CategoricalEmbeds over the same ids: their
    tables concatenated along dim, gathered once, the result split back
    per embed.  The same values as a lookup per embed.  (The JAX package
    looks them up separately under SHIFU_TPU_PALLAS, only because its TPU
    kernel needs D % 128 == 0; the card has no such limit.)"""
    fused = embedding_lookup(torch.cat([e.table() for e in embeds], dim=-1),
                             ids)
    return list(fused.split([e.dim for e in embeds], dim=-1))


def paired_cat_embed(layout: FieldLayout, spec: ModelSpec,
                     generator: Optional[torch.Generator] = None
                     ) -> tuple[CategoricalEmbed, CategoricalEmbed]:
    """The (embedding_dim, num_heads) pair of tables over the same ids that
    Wide&Deep and DeepFM both hold, looked up together by `fused_lookup`."""
    return tuple(CategoricalEmbed(layout, dim, spec.compute_dtype, generator,
                                  spec.param_dtype)
                 for dim in (spec.embedding_dim, spec.num_heads))


class NumericEmbed(nn.Module):
    """Numeric feature tokens: x_j -> x_j * w_j + b_j, (B, Nn) -> (B, Nn, dim).

    As in the JAX module, x is cast to the compute dtype and then meets the
    params in `param_dtype`, so with float32 params the tokens come out in
    float32 (type promotion)."""

    def __init__(self, layout: FieldLayout, dim: int,
                 compute_dtype: str = "bfloat16",
                 generator: Optional[torch.Generator] = None,
                 param_dtype: str = "float32"):
        super().__init__()
        self.layout = layout
        self.dim = dim
        self.cdt = dtype_of(compute_dtype)
        if layout.num_numeric:
            pdt = dtype_of(param_dtype)
            self.weight = nn.Parameter(
                xavier_uniform((layout.num_numeric, dim), generator).to(pdt))
            self.bias = nn.Parameter(
                torch.zeros((layout.num_numeric, dim), dtype=pdt))

    def forward(self, numeric: torch.Tensor) -> torch.Tensor:
        if self.layout.num_numeric == 0:
            return torch.zeros((numeric.shape[0], 0, self.dim),
                               dtype=self.cdt, device=numeric.device)
        x = numeric.to(self.cdt)
        return x[:, :, None] * self.weight[None] + self.bias[None]
