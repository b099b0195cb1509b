"""Rows-touched-only optimizer updates for embedding tables (port of
shifu_tpu/train/sparse_embed.py, one device).

A dense Adadelta reads and writes a table and its two moment slots whole at
every step, although only the rows the batch looked up have a nonzero
gradient.  Under a sparse plan the stacked `embedding` tables are left out
of the dense `Optimizer`, their slots live on `TrainState.table_slots`, and
each step gathers the touched rows' gradients and updates those rows only,
in place, through `ops/embedding.fused_rows_update` (kernel #6 on the card).
The semantics are TF's lazy sparse ones: untouched rows see no moment
decay.

The ids of the update are the batch's compacted unique ids when the feeder
attached them (embed/dedup, the per-batch tier), else the raw ids of the
batch (the resident tier).  Both go through the kernel on the card: it
takes duplicate ids, and is told when they are unique (`unique=True`), so
that it updates each row without electing one copy (ops/embedding).  The JAX package sends raw ids to its
XLA reference instead, since its TPU kernel needs unique ids; the values
are the same (ROADMAP.md section C).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from ..config.schema import ConfigError, JobConfig
from ..embed.dedup import UNIQUE_KEY
from ..models.embedding import FieldLayout, field_layout, split_features
from ..ops.embedding import fused_rows_update
from .optimizers import learning_rate

# "auto" engages at this largest vocab and above, where the dense update's
# traffic over the tables dominates a step
AUTO_MIN_VOCAB = 100_000

# model types whose stacked CategoricalEmbed tables the sparse rule owns
_TABLE_MODELS = ("wide_deep", "deepfm")


@dataclasses.dataclass(frozen=True)
class SparseEmbedPlan:
    """The resolved plan: the update rule, its rate (a float or a schedule
    of the step), and the tables' field layout."""

    rule: str                    # "adadelta" | "sgd"
    learning_rate: Any
    layout: FieldLayout

    @property
    def num_categorical(self) -> int:
        return self.layout.num_categorical

    @property
    def max_vocab(self) -> int:
        return max(self.layout.vocab_sizes) if self.layout.vocab_sizes else 0


def _is_table_leaf(name: str, leaf: torch.Tensor,
                   plan: SparseEmbedPlan) -> bool:
    """A sparse-updatable table: a stacked CategoricalEmbed param, named
    `embedding`, shaped (num_categorical, max_vocab, D)."""
    return (name.split(".")[-1] == "embedding" and leaf.dim() == 3
            and leaf.shape[0] == plan.num_categorical
            and leaf.shape[1] == plan.max_vocab)


def resolve_plan(job: JobConfig) -> Optional[SparseEmbedPlan]:
    """The job's sparse plan, or None (dense updates).

    "on" demands the JAX package's structural requirements and raises with
    the blocker otherwise; "auto" engages when they hold and the largest
    vocab is at least AUTO_MIN_VOCAB, whatever the device (the JAX package
    also wants a TPU with D % 128 == 0, or its Pallas opt-in: a deliberate
    difference, ROADMAP.md section C); "off" is None.  A model axis above 1
    (vocab-sharded tables) is not ported yet."""
    mode = job.train.sparse_embedding_update
    if mode == "off":
        return None
    opt = job.train.optimizer
    rule = {"adadelta": "adadelta", "sgd": "sgd",
            "gradientdescent": "sgd"}.get(opt.name.lower())

    def blocker() -> Optional[str]:
        if not job.schema.categorical_indices:
            return "the schema has no categorical columns"
        if job.model.model_type not in _TABLE_MODELS:
            return (f"model {job.model.model_type!r} has no stacked "
                    f"embedding tables (supported: "
                    f"{', '.join(_TABLE_MODELS)})")
        if rule is None:
            return (f"optimizer {opt.name!r} has no sparse rule "
                    "(supported: adadelta, sgd)")
        if opt.grad_clip_norm > 0:
            return "grad_clip_norm needs the full gradient tree"
        if opt.accumulate_steps > 1:
            return "gradient accumulation buffers dense gradients"
        if job.train.local_sgd_window > 0:
            return "local-SGD replicas stack params on the data axis"
        if job.runtime.mesh.model > 1:
            v = max(field_layout(job.schema).vocab_sizes)
            if v % job.runtime.mesh.model != 0:
                return (f"vocab-sharded tables need max vocab ({v}) "
                        f"divisible by the model axis "
                        f"({job.runtime.mesh.model})")
        if job.model.pipeline_stages > 1:
            return "pipeline-stacked trunks reshape the param tree"
        return None

    why_not = blocker()
    if why_not is not None:
        if mode == "on":
            raise ConfigError(f"sparse_embedding_update=on but {why_not}")
        return None
    layout = field_layout(job.schema)
    if mode == "auto" and max(layout.vocab_sizes) < AUTO_MIN_VOCAB:
        return None
    if job.runtime.mesh.model > 1:
        raise NotImplementedError(
            f"the sparse plan wants {job.runtime.mesh.model} vocab shards "
            "(mesh.model > 1); vocab-sharded tables are not ported yet "
            "(ROADMAP.md, queue A item (f)); set runtime.mesh.model to 1")
    return SparseEmbedPlan(rule=rule, learning_rate=learning_rate(opt),
                           layout=layout)


def table_names(model: torch.nn.Module, plan: SparseEmbedPlan) -> list[str]:
    """Names of the model's parameters that the sparse rule owns."""
    return [n for n, p in model.named_parameters()
            if _is_table_leaf(n, p, plan)]


def init_table_slots(model: torch.nn.Module,
                     plan: SparseEmbedPlan) -> dict[str, tuple]:
    """The tables' moment slots, by parameter name: two f32 zero tensors
    shaped like the table for adadelta, none for sgd."""
    params = dict(model.named_parameters())
    return {n: (() if plan.rule == "sgd" else
                tuple(torch.zeros(params[n].shape, dtype=torch.float32,
                                  device=params[n].device) for _ in range(2)))
            for n in table_names(model, plan)}


def extract_ids(features: torch.Tensor, plan: SparseEmbedPlan
                ) -> torch.Tensor:
    """(B, F) features -> (B, Nc) int32 ids, by the model's own
    `split_features`: the touched rows are the rows the forward gathered."""
    return split_features(features, plan.layout)[1]


def make_sparse_apply(job: JobConfig) -> Optional[Callable]:
    """None (dense job), or fn(state, batch) -> state that applies one
    update from the parameters' .grad: the dense `Optimizer` on every
    parameter but the tables, and the rows-touched rule on each table.  The
    rate is the schedule's at `state.step` before the increment."""
    plan = resolve_plan(job)
    if plan is None:
        return None
    lr_of = (plan.learning_rate if callable(plan.learning_rate)
             else (lambda _step, _lr=plan.learning_rate: _lr))
    nc, vocab = plan.num_categorical, plan.max_vocab
    dedup_on = job.embed.dedup != "off"

    def apply(state, batch: dict):
        unique = batch.get(UNIQUE_KEY) if dedup_on else None
        ids = (unique if unique is not None
               else extract_ids(batch["features"], plan))
        lr = lr_of(state.step)
        state.optimizer.step()
        with torch.no_grad():
            # touched rows' gradients, (U, Nc, D) f32; the sentinel's rows
            # gather clamped rows that the update skips
            fields = torch.arange(nc, device=ids.device)[None, :]
            safe = ids.long().clamp(0, vocab - 1)
            for name, p in state.model.named_parameters():
                if name not in state.table_slots:
                    continue
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                fused_rows_update(p.detach(), state.table_slots[name],
                                  g[fields, safe].float(), ids, plan.rule, lr,
                                  unique=unique is not None)
        state.step += 1
        return state

    return apply
