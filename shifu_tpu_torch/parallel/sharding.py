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
over the other axes.  The process-local variants, where each host holds
only its own rows, belong to the pod launcher (ROADMAP.md queue A item
(f)) and raise.

Parameters are placed by rules, (path regex, spec) pairs matched against
the port's parameter names (`cat_embedding.embedding`; the JAX package's
`['cat_embedding']['embedding']` matches the same patterns): first match
wins, the spec trimmed or padded to the tensor's rank, the rest
replicated.  The port shards only the vocab axis of sparse-plan tables
(embed/shard.VOCAB_SHARD_RULES); the other model-axis placements raise
(train/loop.init_state).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Mapping, Optional, Sequence

import numpy as np
import torch

from . import distributed
from .mesh import DATA_AXIS, MODEL_AXIS, Mesh

Spec = tuple  # one mesh axis name or None per dimension
ShardingRules = Sequence[tuple[str, Spec]]

# the JAX package's default rules: embedding tables split their first
# axis over `model`, everything else replicates
DEFAULT_RULES: ShardingRules = ((r".*[Ee]mbedding.*", (MODEL_AXIS, None)),)


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
                raise ValueError(f"dimension {n} does not split over mesh "
                                 f"axis {axis!r} of size {size}")
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


def _process_local(*_args, **_kwargs):
    raise NotImplementedError(
        "process-local batches (each host holds only its own rows) belong "
        "to the pod launcher and data plane, not ported yet (ROADMAP.md, "
        "queue A item (f))")


shard_batch_process_local = _process_local
shard_blocks_process_local = _process_local


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
    """Optimizer state placed like its parameters: under a dict key that
    names a parameter, every tensor of that parameter's shape takes its
    block (the moment slots of a vocab-sharded table, keyed by the
    table's name in `TrainState.table_slots`); the rest replicates."""
    shardings = param_shardings(params, mesh, rules)
    shapes = {k: tuple(v.shape) for k, v in params.items()}

    def place(obj, owner: Optional[str]):
        if isinstance(obj, dict):
            return {k: place(v, k if k in shardings else owner)
                    for k, v in obj.items()}
        if isinstance(obj, (list, tuple)):
            return type(obj)(place(v, owner) for v in obj)
        if (isinstance(obj, (torch.Tensor, np.ndarray)) and owner is not None
                and tuple(obj.shape) == shapes[owner]):
            return shardings[owner].local(_as_tensor(obj)).contiguous().clone()
        return obj

    return place(opt_state, None)
