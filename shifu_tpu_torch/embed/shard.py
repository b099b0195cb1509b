"""Vocab-sharded embedding tables and their shard-local rows-touched
update (port of shifu_tpu/embed/shard.py).

For large vocabularies a replicated (Nc, V, D) table and its two Adadelta
slots are the memory budget, so the sparse plan shards the table's VOCAB
axis over the mesh's `model` axis: model rank s owns rows [s * V/S,
(s + 1) * V/S) of every stacked table and of its slots.  The lookup runs
kernel #5 on the local slice and sums the slices' partial rows over the
model group (models/embedding.sharded_lookup).  The update is shard-local:
each rank receives the global batch's ids, rebases them by its row offset,
maps foreign ids and the dedup sentinel to the local sentinel V/S, and
kernel #6 updates the local slice, skipping every id outside [0, V/S).
Id-to-shard routing is offset arithmetic, no collective; no rank holds the
whole table.  Under data parallelism the touched rows' gradients are
averaged over the data group first (`make_sharded_rows_update`'s `data_group`; each
rank's loss is scaled so that the average is the global batch's
gradient, train/step.py): (U, Nc, D) rows, batch-proportional, never the
dense (Nc, V, D) gradient.

The placement itself is parallel/sharding.place_model's: the stacked
tables' modules take their vocab slices (models/embedding.CategoricalEmbed.
accept_split).  As in the JAX package the VOCAB_SHARD_RULES pattern also
matches the numeric field vectors (`numeric_embedding`), whose D axis is
then split and all-gathered where the forward uses it.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.embedding import fused_rows_update
from ..parallel import distributed
from ..parallel.mesh import MODEL_AXIS, Mesh

# the sparse plan's rule: stacked (Nc, V, D) tables split the vocab axis
VOCAB_SHARD_SPEC = (None, MODEL_AXIS, None)
VOCAB_SHARD_RULES = ((r".*[Ee]mbedding.*", VOCAB_SHARD_SPEC),)


def make_sharded_rows_update(mesh: Optional[Mesh], *, nc: int, vocab: int,
                             shards: int, rule: str, data_group=None):
    """fn(table, slots, g, ids, lr, unique=False) -> (table, slots): the
    rows-touched update of this rank's slice of a vocab-sharded table, in
    place, through kernel #6 (`ops/embedding.fused_rows_update`).  table,
    slots and g (the table's dense gradient) are local (Nc, V/S, D)
    slices; ids are the global batch's (U, Nc) ids (raw, or unique with
    the sentinel V padding them), rebased to the slice, foreign ids and
    the sentinel mapped to the local sentinel V/S.  With `data_group` the
    gathered (U, Nc, D) gradient rows are averaged over it first.
    `shards` 1 is the replicated table (offset 0)."""
    if vocab % shards != 0:
        raise ValueError(f"vocab {vocab} not divisible by {shards} shards")
    vloc = vocab // shards
    lo = (mesh.axis_index(MODEL_AXIS) if shards > 1 else 0) * vloc

    def update(table, slots, g, ids, lr, unique: bool = False):
        rebased = ids.long() - lo
        local_ids = torch.where((rebased >= 0) & (rebased < vloc), rebased,
                                vloc)
        fields = torch.arange(nc, device=ids.device)[None, :]
        # foreign and sentinel ids gather a clamped row the update skips
        g_rows = g[fields, local_ids.clamp(0, vloc - 1)].float()
        distributed.all_reduce(g_rows, data_group, "avg")
        return fused_rows_update(table, slots, g_rows,
                                 local_ids.to(torch.int32), rule, lr,
                                 unique=unique)

    return update


def assert_vocab_sharded(table: torch.Tensor, shards: int,
                         vocab: int) -> None:
    """Test/debug assertion: this rank's table holds V/shards vocab rows,
    never the whole table."""
    if table.shape[1] != vocab // shards:
        raise AssertionError(
            f"table slice {tuple(table.shape)} on rank "
            f"{distributed.process_index()}: expected a vocab slice of "
            f"{vocab // shards} rows ({shards} shards of {vocab})")
