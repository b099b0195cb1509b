"""Feature embeddings (port of shifu_tpu/models/embedding.py): field
layout, the numeric/categorical split, the categorical tables and the
numeric field vectors, and `fused_lookup`, one lookup for the tables that
share ids.  Every lookup goes through `ops/embedding.embedding_lookup`
(kernel #5 on the card; re-exported here).

A stacked table may be split over a mesh axis (parallel/sharding.
place_model offers the block to `CategoricalEmbed.accept_split`):
- by vocab (a sparse plan's rule, embed/shard.py): the module holds rows
  [offset, offset + V/S) of the global table and a `VocabShard`, and
  `sharded_lookup` gathers from the local slice with the kernel and sums
  the slices' partial results over the group.  The values are the
  unsharded lookup's, bit for bit: each global id lands in exactly one
  slice, the other slices add zeros.
- by field (DEFAULT_RULES' `P(model, None)` on a (Nc, V, D) table): the
  module holds fields [offset, offset + Nc/S) and a `FieldShard`; the
  kernel looks up this rank's fields only, and `field_lookup` all-gathers
  the (B, Nc/S, D) result over the group on the field axis.  Its backward
  hands each rank the cotangent of its own fields, which the lookup's
  backward scatters into the local table in f32, as on one device."""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import torch
from torch import nn

from ..config.schema import DataSchema, ModelSpec
from ..ops.embedding import embedding_lookup
from ..ops.initializers import xavier_uniform
from ..parallel.distributed import gather_grad, sum_forward
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
        ids = features.new_zeros((b, 0), dtype=torch.int32)
    return num, ids


@dataclasses.dataclass(frozen=True)
class VocabShard:
    """This rank's slice of a vocab-sharded table: rows [offset, offset +
    rows) of a `vocab`-row table; `group` sums the slices (the model
    axis's process group, None alone)."""

    offset: int
    rows: int
    vocab: int
    group: Any = None


def sharded_lookup(table: torch.Tensor, ids: torch.Tensor,
                   shard: VocabShard) -> torch.Tensor:
    """The lookup of global (B, Nc) ids in a vocab-sharded table, from the
    local (Nc, V/S, D) slice: the unsharded `embedding_lookup`'s values
    and gradient.  Ids wrap and go out of range by the GLOBAL vocab (ids in
    [-V, 0) wrap, ids outside [-V, V) give a NaN row).  The ids of other
    slices, and a lower slice's ids rebased below 0 (which the kernel would
    wrap), are clamped to row 0 before the kernel and their rows zeroed
    with `where` (a multiply would keep a NaN); the partial results are
    summed over the group, whose backward is the identity, so each slice's
    gradient reaches its own rows only."""
    v = shard.vocab
    ids = ids.long()
    wrapped = torch.where(ids < 0, ids + v, ids)
    valid = (wrapped >= 0) & (wrapped < v)
    local = wrapped - shard.offset
    mine = valid & (local >= 0) & (local < shard.rows)
    part = embedding_lookup(table, torch.where(mine, local, 0).to(torch.int32))
    part = torch.where(mine[..., None], part, torch.zeros_like(part))
    out = sum_forward(part, shard.group)
    return torch.where(valid[..., None], out,
                       torch.full_like(out, float("nan")))


@dataclasses.dataclass(frozen=True)
class FieldShard:
    """This rank's fields of a field-split table: fields [offset, offset +
    count) of the stacked (Nc, V, D) table; `group` gathers the fields
    (the split axis's process group)."""

    offset: int
    count: int
    group: Any = None


def field_lookup(table: torch.Tensor, ids: torch.Tensor,
                 shard: FieldShard) -> torch.Tensor:
    """The lookup of global (B, Nc) ids in a field-split table: this
    rank's (count, V, D) fields through the kernel, then the (B, Nc, D)
    result all-gathered over the group on the field axis, with a
    gradient (the unsharded lookup's values and gradient)."""
    mine = ids[:, shard.offset:shard.offset + shard.count].contiguous()
    return gather_grad(embedding_lookup(table, mine), shard.group, 1)


class CategoricalEmbed(nn.Module):
    """Per-field embedding tables stacked as one `embedding` param
    (num_fields, max_vocab, dim) in `param_dtype`; ids (B, Nc) ->
    (B, Nc, dim) in the compute dtype through `embedding_lookup`.
    `table()` is the compute-dtype table, for `fused_lookup`.  A split
    table holds its block and `vocab_shard` or `field_shard`
    (`accept_split`)."""

    def __init__(self, layout: FieldLayout, dim: int,
                 compute_dtype: str = "bfloat16",
                 generator: Optional[torch.Generator] = None,
                 param_dtype: str = "float32"):
        super().__init__()
        self.layout = layout
        self.dim = dim
        self.cdt = dtype_of(compute_dtype)
        self.vocab_shard: Optional[VocabShard] = None
        self.field_shard: Optional[FieldShard] = None
        if layout.num_categorical:
            self.embedding = nn.Parameter(xavier_uniform(
                (layout.num_categorical, max(layout.vocab_sizes), dim),
                generator).to(dtype_of(param_dtype)))

    def accept_split(self, leaf: str, sharding) -> bool:
        """Take the table's block when it is split by vocab (the second
        axis) or by field (the first) over one mesh axis; a split of the
        embedding dimension is left to the all-gather."""
        if leaf != "embedding":
            return False
        spec = tuple(sharding.spec) + (None,) * 3
        axes = [a for a in spec[:3] if a is not None]
        if len(axes) != 1 or spec[2] is not None:
            return False
        mesh, axis = sharding.mesh, axes[0]
        index, group = mesh.axis_index(axis), mesh.group(axis)
        if spec[0] is not None:
            count = self.embedding.shape[0]
            self.field_shard = FieldShard(index * count, count, group)
        else:
            rows = self.embedding.shape[1]
            self.vocab_shard = VocabShard(index * rows, rows,
                                          rows * mesh.axis_size(axis), group)
        return True

    def table(self) -> torch.Tensor:
        return self.embedding.to(self.cdt)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        if self.layout.num_categorical == 0:
            return ids.new_zeros((ids.shape[0], 0, self.dim),
                                 dtype=self.cdt)
        return _lookup(self.table(), ids, self)


def _lookup(table: torch.Tensor, ids: torch.Tensor,
            embed: CategoricalEmbed) -> torch.Tensor:
    if embed.vocab_shard is not None:
        return sharded_lookup(table, ids, embed.vocab_shard)
    if embed.field_shard is not None:
        return field_lookup(table, ids, embed.field_shard)
    return embedding_lookup(table, ids)


def fused_lookup(embeds: Sequence[CategoricalEmbed], ids: torch.Tensor
                 ) -> list[torch.Tensor]:
    """One lookup for several CategoricalEmbeds over the same ids: their
    tables concatenated along dim, gathered once, the result split back
    per embed.  The same values as a lookup per embed.  (The JAX package
    looks them up separately under SHIFU_TPU_PALLAS, only because its TPU
    kernel needs D % 128 == 0; the card has no such limit.)  Embeds split
    alike (by vocab or by field) concatenate their local blocks alike;
    embeds split differently are looked up one by one."""
    first = embeds[0]
    if any((e.vocab_shard, e.field_shard)
           != (first.vocab_shard, first.field_shard) for e in embeds[1:]):
        return [e(ids) for e in embeds]
    fused = _lookup(torch.cat([e.table() for e in embeds], dim=-1), ids,
                    first)
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
            return numeric.new_zeros((numeric.shape[0], 0, self.dim),
                                     dtype=self.cdt)
        x = numeric.to(self.cdt)
        return x[:, :, None] * self.weight[None] + self.bias[None]
