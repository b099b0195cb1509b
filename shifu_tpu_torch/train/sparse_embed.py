"""Rows-touched-only optimizer updates for embedding tables (port of
shifu_tpu/train/sparse_embed.py).

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

On a mesh the ids are the global batch's, which every rank holds.  With
`mesh.model` > 1 each table is vocab-sharded and the update runs on the
local slice (embed/shard.py); with `mesh.data` > 1 each rank gathers its
dense gradient's rows at those ids and the (U, Nc, D) rows are averaged
over the data group before the update (never the dense (Nc, V, D)
gradient: at the 4M-vocab shape that is 1.5 GB a step).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from ..config.schema import ConfigError, JobConfig
from ..embed.dedup import UNIQUE_KEY
from ..embed.shard import make_sharded_rows_update
from ..models.embedding import FieldLayout, field_layout, split_features
from ..parallel.mesh import DATA_AXIS
from .optimizers import learning_rate

# "auto" engages at this largest vocab and above, where the dense update's
# traffic over the tables dominates a step
AUTO_MIN_VOCAB = 100_000

# model types whose stacked CategoricalEmbed tables the sparse rule owns
_TABLE_MODELS = ("wide_deep", "deepfm")


@dataclasses.dataclass(frozen=True)
class SparseEmbedPlan:
    """The resolved plan: the update rule, its rate (a float or a schedule
    of the step), the tables' field layout and the vocab shards (the
    mesh's model axis; 1 = replicated tables)."""

    rule: str                    # "adadelta" | "sgd"
    learning_rate: Any
    layout: FieldLayout
    shards: int = 1

    @property
    def num_categorical(self) -> int:
        return self.layout.num_categorical

    @property
    def max_vocab(self) -> int:
        return max(self.layout.vocab_sizes) if self.layout.vocab_sizes else 0


def _is_table_leaf(name: str, leaf: torch.Tensor,
                   plan: SparseEmbedPlan) -> bool:
    """A sparse-updatable table: a stacked CategoricalEmbed param, named
    `embedding`, shaped (num_categorical, max_vocab, D), or its vocab
    slice (num_categorical, max_vocab / shards, D)."""
    return (name.split(".")[-1] == "embedding" and leaf.dim() == 3
            and leaf.shape[0] == plan.num_categorical
            and leaf.shape[1] in (plan.max_vocab,
                                  plan.max_vocab // plan.shards))


def on_mesh(job: JobConfig, mesh) -> JobConfig:
    """`job` with `runtime.mesh` set to the mesh it trains on: the plan
    reads its vocab shards there."""
    if mesh is None or job.runtime.mesh == mesh.config:
        return job
    return job.replace(runtime=dataclasses.replace(job.runtime,
                                                   mesh=mesh.config))


def resolve_plan(job: JobConfig) -> Optional[SparseEmbedPlan]:
    """The job's sparse plan, or None (dense updates).

    "on" demands the JAX package's structural requirements and raises with
    the blocker otherwise; "auto" engages when they hold and the largest
    vocab is at least AUTO_MIN_VOCAB, whatever the device (the JAX package
    also wants a TPU with D % 128 == 0, or its Pallas opt-in: a deliberate
    difference, ROADMAP.md section C); "off" is None.  A model axis above 1
    shards the tables' vocab over it, which must divide the largest
    vocab (the JAX package's blocker)."""
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
    return SparseEmbedPlan(rule=rule, learning_rate=learning_rate(opt),
                           layout=layout,
                           shards=max(job.runtime.mesh.model, 1))


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


def make_sparse_apply(job: JobConfig, mesh=None) -> Optional[Callable]:
    """None (dense job), or fn(state, batch) -> state that applies one
    update from the parameters' .grad: the dense `Optimizer` on every
    parameter but the tables, and the rows-touched rule on each table (on
    its vocab slice under a sharded plan, its rows' gradients averaged
    over the mesh's data group).  The rate is the schedule's at
    `state.step` before the increment."""
    plan = resolve_plan(on_mesh(job, mesh))
    if plan is None:
        return None
    lr_of = (plan.learning_rate if callable(plan.learning_rate)
             else (lambda _step, _lr=plan.learning_rate: _lr))
    if plan.shards > 1 and mesh is None:
        raise ConfigError(f"the sparse plan wants {plan.shards} vocab "
                          "shards but no mesh was built")
    update = make_sharded_rows_update(
        mesh, nc=plan.num_categorical, vocab=plan.max_vocab,
        shards=plan.shards, rule=plan.rule,
        data_group=mesh.group(DATA_AXIS) if mesh is not None else None)
    dedup_on = job.embed.dedup != "off"

    def apply(state, batch: dict):
        unique = batch.get(UNIQUE_KEY) if dedup_on else None
        ids = (unique if unique is not None
               else extract_ids(batch["features"], plan))
        lr = lr_of(state.step)
        state.optimizer.step()
        with torch.no_grad():
            for name, p in state.model.named_parameters():
                if name not in state.table_slots:
                    continue
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                update(p.detach(), state.table_slots[name], g, ids, lr,
                       unique=unique is not None)
        state.step += 1
        return state

    return apply
