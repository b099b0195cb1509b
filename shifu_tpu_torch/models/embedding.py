"""Feature embeddings (port of the FT-Transformer's part of
shifu_tpu/models/embedding.py): field layout, the numeric/categorical
split, the two tokenizers, and `embedding_lookup` (the gather of
shifu_tpu/ops/pallas_embedding.py with its XLA-path gradient)."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from ..config.schema import DataSchema
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


class _EmbeddingLookup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, ids):
        nc = table.shape[0]
        ctx.save_for_backward(ids)
        ctx.table_shape, ctx.table_dtype = tuple(table.shape), table.dtype
        fields = torch.arange(nc, device=ids.device)
        return table[fields[None, :], ids.long()]

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        nc, v, d = ctx.table_shape
        flat = (torch.arange(nc, device=ids.device)[None, :] * v
                + ids.long()).reshape(-1)
        grad = torch.zeros((nc * v, d), dtype=torch.float32, device=g.device)
        grad.index_add_(0, flat, g.reshape(-1, d).float())
        return grad.reshape(nc, v, d).to(ctx.table_dtype), None


def embedding_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """out[b, f, :] = table[f, ids[b, f], :] for a (Nc, V, D) table and
    (B, Nc) ids in [0, V).  Its gradient scatter-adds the rows in f32 and
    rounds once to the table's dtype, as JAX's `_scatter_grad` (and the
    one-hot gradient) then `.astype` do: a plain bf16 gather would add a
    row's updates in bf16 in its backward.  Plain PyTorch on every device;
    the TPU lookup kernel (pallas_embedding.py `_pallas_lookup`) waits for
    the embedding models' slice (ROADMAP.md)."""
    return _EmbeddingLookup.apply(table, ids)


class CategoricalEmbed(nn.Module):
    """Per-field embedding tables stacked as one `embedding` param
    (num_fields, max_vocab, dim); ids (B, Nc) -> (B, Nc, dim) in the
    compute dtype through `embedding_lookup`."""

    def __init__(self, layout: FieldLayout, dim: int,
                 compute_dtype: str = "bfloat16",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.layout = layout
        self.dim = dim
        self.cdt = dtype_of(compute_dtype)
        if layout.num_categorical:
            self.embedding = nn.Parameter(xavier_uniform(
                (layout.num_categorical, max(layout.vocab_sizes), dim),
                generator))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        if self.layout.num_categorical == 0:
            return torch.zeros((ids.shape[0], 0, self.dim), dtype=self.cdt,
                               device=ids.device)
        return embedding_lookup(self.embedding.to(self.cdt), ids)


class NumericEmbed(nn.Module):
    """Numeric feature tokens: x_j -> x_j * w_j + b_j, (B, Nn) -> (B, Nn, dim).

    As in the JAX module, x is cast to the compute dtype and then meets the
    float32 params, so the tokens come out in float32 (type promotion)."""

    def __init__(self, layout: FieldLayout, dim: int,
                 compute_dtype: str = "bfloat16",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.layout = layout
        self.dim = dim
        self.cdt = dtype_of(compute_dtype)
        if layout.num_numeric:
            self.weight = nn.Parameter(
                xavier_uniform((layout.num_numeric, dim), generator))
            self.bias = nn.Parameter(
                torch.zeros((layout.num_numeric, dim), dtype=torch.float32))

    def forward(self, numeric: torch.Tensor) -> torch.Tensor:
        if self.layout.num_numeric == 0:
            return torch.zeros((numeric.shape[0], 0, self.dim),
                               dtype=self.cdt, device=numeric.device)
        x = numeric.to(self.cdt)
        return x[:, :, None] * self.weight[None] + self.bias[None]
