"""Batch and parameter placement over a mesh (port of
shifu_tpu/parallel/sharding.py).

A spec is the JAX PartitionSpec as a tuple: one mesh axis name (or None)
per tensor dimension, () for replicated.  The JAX package device_puts a
global array and lets XLA hold each device's block; here each rank holds
its block as an ordinary tensor and the collectives are explicit
(train/step.py, embed/shard.py).

Batches follow the JAX package's single-host semantics: every rank holds
the whole global batch and `shard_batch` takes its rows,
[d * B / Nd, (d + 1) * B / Nd) for data coordinate d (views, no copy).
Ranks along `model` take the same rows, as `P('data', ...)` replicates
over the other axes.  Under a pod each host holds only its own rows, the
host's slice [h * B / H, (h + 1) * B / H) of the global batch (the JAX
package's process-local data): `shard_batch_process_local` and
`shard_blocks_process_local` take a rank's rows out of its host's slice,
so the ranks of one host split it by local rank, as `shard_batch` splits
the global batch.

Parameters are placed by rules, (path regex, spec) pairs matched against
the port's parameter names (`cat_embedding.embedding`; the JAX package's
`['cat_embedding']['embedding']` matches the same patterns): first match
wins, the spec trimmed or padded to the tensor's rank, the rest
replicated.  `sharding_rules` lists them in the JAX package's order
(train/loop.init_state there): the `shifu.sharding.rules` entries, the
vocab rule of a sharded sparse plan, DEFAULT_RULES under a model axis
above 1, MoE experts over `model`, a pipelined trunk's stacked layers
over `pipe`.

`place_model` stores each leaf whose spec names an axis above 1 as this
rank's block.  The module that owns the leaf may consume the block
itself (`accept_split`): a table split by vocab or by field
(models/embedding.py), MoE experts (models/moe.py), a pipeline stage's
layers (models/ft_transformer.StackedBlocks).  Every other split leaf is
all-gathered, with a gradient, where the forward uses it whole
(`model_forward`); its gradient comes back as this rank's slice.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Mapping, Optional, Sequence

import numpy as np
import torch

from ..config.schema import ConfigError
from . import distributed
from .mesh import DATA_AXIS, MODEL_AXIS, PIPE_AXIS, Mesh

Spec = tuple  # one mesh axis name or None per dimension
ShardingRules = Sequence[tuple[str, Spec]]

# the JAX package's default rules: embedding tables split their first
# axis over `model`, everything else replicates
DEFAULT_RULES: ShardingRules = ((r".*[Ee]mbedding.*", (MODEL_AXIS, None)),)
# expert parallelism: the stacked (E, ...) expert leaves split by expert
# (the JAX package's `.*\bexperts/.*`, its leaves named `experts/kernel0`)
EXPERT_RULES: ShardingRules = ((r".*\bexperts\..*", (MODEL_AXIS,)),)
# a pipelined trunk's stacked (L, ...) layers split by stage
STAGE_RULES: ShardingRules = ((r".*\bblocks\b.*", (PIPE_AXIS,)),)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A spec on a mesh: which block of a global tensor this rank holds."""

    mesh: Mesh
    spec: Spec

    def index(self, shape: Sequence[int]) -> tuple:
        out = []
        for n, axis in zip(shape, self.spec):
            if axis is None:
                out.append(slice(None))
                continue
            size = self.mesh.axis_size(axis)
            if n % size:
                raise ValueError(
                    f"a spec of {tuple(self.spec)} on the mesh "
                    f"{self.mesh.shape} implies that the global size of "
                    f"dimension {len(out)} should be divisible by {size}, "
                    f"but it is equal to {n} (full shape: {tuple(shape)})")
            i, per = self.mesh.axis_index(axis), n // size
            out.append(slice(i * per, (i + 1) * per))
        return tuple(out)

    def local(self, x):
        """This rank's block of the global `x` (a view)."""
        return x[self.index(x.shape)]

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The global tensor from this rank's block: collective over the
        groups of the sharded axes (every rank of each must call it)."""
        for dim, axis in enumerate(self.spec):
            if axis is not None:
                x = distributed.all_gather(x, self.mesh.group(axis), dim)
        return x

    def gather_grad(self, x: torch.Tensor) -> torch.Tensor:
        """`gather` with a gradient: the backward hands this rank the
        slice of the cotangent summed over the groups."""
        for dim, axis in enumerate(self.spec):
            if axis is not None:
                x = distributed.gather_grad(x, self.mesh.group(axis), dim)
        return x

    @property
    def axes(self) -> tuple:
        """The mesh axes this block is split over."""
        return tuple(a for a in self.spec if a is not None)

    def groups(self) -> list:
        """The process groups of the axes this block is split over."""
        return [self.mesh.group(a) for a in self.axes]

    def split_factor(self) -> int:
        """How many blocks make the global tensor."""
        return int(np.prod([self.mesh.axis_size(a) for a in self.axes]))

    def full_shape(self, shape: Sequence[int]) -> list:
        return [n * self.mesh.axis_size(a) if a else n
                for n, a in zip(shape, list(self.spec)
                                + [None] * (len(shape) - len(self.spec)))]


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def batch_spec(rank: int = 2) -> Spec:
    return (DATA_AXIS,) + (None,) * (rank - 1)


def batch_sharding(mesh: Mesh, rank: int = 2) -> Sharding:
    """The leading (batch) dimension over `data`, the others whole."""
    return Sharding(mesh, batch_spec(rank))


def block_sharding(mesh: Mesh, rank: int = 3) -> Sharding:
    """Staged (nb, B, ...) blocks: the batch (second) axis over `data`."""
    return Sharding(mesh, (None, DATA_AXIS) + (None,) * (rank - 2))


def shard_batch(batch: Mapping[str, Any], mesh: Mesh,
                keep: Sequence[str] = ()) -> dict:
    """This rank's rows of every array of a global batch (numpy or torch;
    views); the keys in `keep` stay whole (the dedup's unique ids, which
    the update needs for the global batch)."""
    return {k: (v if k in keep else batch_sharding(mesh, v.ndim).local(v))
            for k, v in batch.items()}


def shard_blocks(blocks: Mapping[str, Any], mesh: Mesh,
                 keep: Sequence[str] = ()) -> dict:
    """This rank's rows of every (nb, B, ...) block, sliced on axis 1."""
    return {k: (v if k in keep else block_sharding(mesh, v.ndim).local(v))
            for k, v in blocks.items()}


def _host_rows(local_rows: int, mesh: Mesh,
               hosts: Optional[tuple[int, int]]) -> slice:
    """This rank's rows within its host's `local_rows`: its data
    coordinate's rows of the global batch (`hosts[1]` host slices in host
    order), less the host's offset."""
    from .mesh import host_shard_info
    h, n_hosts = hosts if hosts is not None else host_shard_info(mesh)
    n_data, d = mesh.axis_size(DATA_AXIS), mesh.axis_index(DATA_AXIS)
    total = local_rows * n_hosts
    if total % n_data:
        raise ValueError(f"a global batch of {total} rows ({n_hosts} hosts "
                         f"of {local_rows}) does not split over a data "
                         f"axis of {n_data}")
    per = total // n_data
    lo = d * per - h * local_rows
    if lo < 0 or lo + per > local_rows:
        raise ConfigError(
            f"rank {mesh.rank} (data index {d}) trains rows [{d * per}, "
            f"{(d + 1) * per}) of the global batch, outside host {h}'s "
            f"slice: a pod needs `data` as the mesh's leading axis, over "
            f"a multiple of the {n_hosts} hosts")
    return slice(lo, lo + per)


def shard_batch_process_local(batch: Mapping[str, Any], mesh: Mesh,
                              keep: Sequence[str] = (),
                              hosts: Optional[tuple[int, int]] = None
                              ) -> dict:
    """This rank's rows of its host's slice of a global batch (views); the
    keys in `keep` stay whole.  `hosts` = (host, number of hosts), by
    default this process's (`mesh.host_shard_info`)."""
    rows = None
    out = {}
    for k, v in batch.items():
        if k in keep:
            out[k] = v
            continue
        if rows is None:
            rows = _host_rows(v.shape[0], mesh, hosts)
        out[k] = v[rows]
    return out


def shard_blocks_process_local(blocks: Mapping[str, Any], mesh: Mesh,
                               keep: Sequence[str] = (),
                               hosts: Optional[tuple[int, int]] = None
                               ) -> dict:
    """This rank's rows of its host's (nb, B / H, ...) blocks, sliced on
    axis 1."""
    rows = None
    out = {}
    for k, v in blocks.items():
        if k in keep:
            out[k] = v
            continue
        if rows is None:
            rows = _host_rows(v.shape[1], mesh, hosts)
        out[k] = v[:, rows]
    return out


def _adapt(spec: Spec, ndim: int) -> Spec:
    entries = list(spec) + [None] * (ndim - len(spec))
    return tuple(entries[:ndim])


def param_specs(params: Mapping[str, Any],
                rules: ShardingRules = ()) -> dict[str, Spec]:
    """Each parameter's spec by name: the first rule whose pattern matches
    (fullmatch or search, as in the JAX package), rank-adapted; ()
    (replicated) when none does."""
    out = {}
    for name, leaf in params.items():
        out[name] = ()
        for pattern, spec in rules:
            if re.fullmatch(pattern, name) or re.search(pattern, name):
                out[name] = _adapt(tuple(spec), len(leaf.shape))
                break
    return out


def param_shardings(params: Mapping[str, Any], mesh: Mesh,
                    rules: ShardingRules = ()) -> dict[str, Sharding]:
    return {k: Sharding(mesh, s)
            for k, s in param_specs(params, rules).items()}


def _as_tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    arr = np.asarray(x)
    if arr.dtype.kind == "V":  # JAX's numpy bfloat16: widened exactly
        arr = arr.astype(np.float32)
    return torch.as_tensor(arr)


def place_params(params: Mapping[str, Any], mesh: Mesh,
                 rules: ShardingRules = ()) -> dict[str, torch.Tensor]:
    """Full parameters (tensors or numpy arrays, by name) -> this rank's
    blocks, contiguous copies (replicated ones whole)."""
    shardings = param_shardings(params, mesh, rules)
    return {k: shardings[k].local(_as_tensor(v)).contiguous().clone()
            for k, v in params.items()}


def place_opt_state(opt_state: Any, params: Mapping[str, Any], mesh: Mesh,
                    rules: ShardingRules = ()) -> Any:
    """Optimizer state placed like its parameters: a tensor whose dict-key
    path (sequence indices left out, keys joined by ".") ends with a
    parameter's full name, and which has that parameter's shape, takes its
    block (the moment slots of a split table, keyed by the table's name in
    `TrainState.table_slots`).  Only the longest such suffix counts, as in
    the JAX package: a slot whose longest match differs in shape
    replicates, and never falls back to a shorter, unrelated name.  The
    rest replicates.  (The port's own `Optimizer` is built on the placed
    blocks, so its slots have their shapes from the start.)"""
    shardings = param_shardings(params, mesh, rules)
    shapes = {k: tuple(v.shape) for k, v in params.items()}

    def owner_of(keys: tuple) -> Optional[str]:
        parts = ".".join(keys).split(".")
        for n in range(len(parts), 0, -1):
            name = ".".join(parts[-n:])
            if name in shardings:
                return name
        return None

    def place(obj, keys: tuple):
        if isinstance(obj, dict):
            return {k: place(v, keys + (str(k),)) for k, v in obj.items()}
        if isinstance(obj, (list, tuple)):
            return type(obj)(place(v, keys) for v in obj)
        if isinstance(obj, (torch.Tensor, np.ndarray)) and keys:
            owner = owner_of(keys)
            if owner is not None and tuple(obj.shape) == shapes[owner]:
                return shardings[owner].local(
                    _as_tensor(obj)).contiguous().clone()
        return obj

    return place(opt_state, ())


def sharding_rules(job, mesh: Mesh, plan=None) -> tuple:
    """The placement rules of `job` on `mesh`, in the JAX package's order
    (first match wins): the `shifu.sharding.rules` entries (a bad regex or
    an axis the mesh lacks raises its ConfigError), the vocab rule of a
    sparse plan sharded over `model`, DEFAULT_RULES when the model axis is
    above 1 (with the expert rule for `moe_mlp`), the stage rule of a
    trunk pipelined over `pipe`."""
    rules: tuple = ()
    for pattern, axes in job.runtime.param_sharding_rules:
        try:
            re.compile(pattern)
        except re.error as e:
            raise ConfigError(
                f"shifu.sharding.rules: bad path regex {pattern!r}: {e}")
        for axis in axes:
            if axis is not None and axis not in mesh.shape:
                raise ConfigError(
                    f"sharding rule {pattern!r}: axis {axis!r} not in "
                    f"mesh axes {sorted(mesh.shape)}")
        rules += ((pattern, tuple(axes)),)
    if plan is not None and plan.shards > 1:
        from ..embed.shard import VOCAB_SHARD_RULES
        rules += tuple(VOCAB_SHARD_RULES)
    if mesh.axis_size(MODEL_AXIS) > 1:
        rules += tuple(DEFAULT_RULES)
        if job.model.model_type == "moe_mlp":
            rules += tuple(EXPERT_RULES)
    if job.model.pipeline_stages > 1 and mesh.axis_size(PIPE_AXIS) > 1:
        rules += tuple(STAGE_RULES)
    return rules


def place_model(model: torch.nn.Module, mesh: Mesh,
                rules: ShardingRules) -> dict[str, Sharding]:
    """Store each parameter whose spec names an axis above 1 as this
    rank's block of it (the model holds the full parameters, as init drew
    them); returns {name: Sharding} of the split ones.  The owning module
    is offered the block (`accept_split(leaf, sharding)`); the blocks it
    declines are all-gathered by `model_forward`.  A dimension that its
    axes do not divide raises ValueError, as JAX's device_put does."""
    params = dict(model.named_parameters())
    gathered = {}
    out = {}
    for name, spec in param_specs(params, rules).items():
        spec = tuple(a if a is not None and mesh.axis_size(a) > 1 else None
                     for a in spec)
        if not any(spec):
            continue
        sh = Sharding(mesh, spec)
        prefix, _, leaf = name.rpartition(".")
        owner = model.get_submodule(prefix) if prefix else model
        full = params[name]
        setattr(owner, leaf, torch.nn.Parameter(
            sh.local(full.detach()).contiguous().clone(),
            requires_grad=full.requires_grad))
        accept = getattr(owner, "accept_split", None)
        if accept is None or not accept(leaf, sh):
            gathered[name] = sh
        out[name] = sh
    model.__dict__["_split_gathered"] = gathered
    return out


def model_forward(model: torch.nn.Module, *args) -> torch.Tensor:
    """`model(*args)`, with each split parameter its module does not
    consume as a block all-gathered (with a gradient) for the call."""
    gathered = model.__dict__.get("_split_gathered")
    if not gathered:
        return model(*args)
    params = dict(model.named_parameters())
    full = {n: sh.gather_grad(params[n]) for n, sh in gathered.items()}
    return torch.func.functional_call(model, full, args)
