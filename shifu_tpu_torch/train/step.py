"""Train and eval steps (port of shifu_tpu/train/step.py, single device).

PyTorch runs eagerly, so a "step builder" returns a plain function: the
train step is forward, backward and the optimizer update on one batch; the
device-resident epoch is a Python loop over the (nb, B, ...) blocks already
on the card, in `epoch_permutation` order, and the staged tier's step a
loop over one host-fed (nb, B, ...) block in its own order; both sum the
loss on the card, which the loop reads once per epoch.

int8 wire features reach the model in one of two ways, as in the JAX
package.  When the model consumes them natively (`wire_fused_into_model`:
an MLP whose layer 0 is within the kernel's shape gate) layer 0 applies
the grid inside `ops/int8_matmul` and no decode runs; otherwise
`make_wire_decode` dequantizes them in f32 before the model.  The JAX
package engages the fused path only on a TPU; the port engages it wherever
the shape gate admits, so a CUDA int8 batch always reaches the kernel (a
deliberate difference, ROADMAP.md section C).

The update is `make_apply_gradients`: the dense optimizer, or under a
sparse embedding plan the dense optimizer on every parameter but the
tables and the rows-touched update on the tables (train/sparse_embed.py),
which reads the batch's ids.

Each builder's function is wrapped by `obs.flops.instrument` under the
name of its JAX program (`train_step`, `device_epoch_step`,
`epoch_scan_step`, `eval_step`), as the JAX package wraps them in
`instrument_jit`: its dispatches run inside a `record_function` range of
that name (the module the flight recorder's rollup attributes device time
to), are tallied, and credit their FLOP count to the goodput ledger.  The
epoch programs call the train step unwrapped, so a batch inside them is
neither named nor credited twice.

On a mesh (`parallel/mesh.py`) every rank receives the whole global
batch and trains its rows of it (`parallel/sharding.shard_batch`), so the
update equals the single-device update on the global batch, as the JAX
package's sharded step does:
- the loss is the weighted mean of the GLOBAL batch: each rank scales its
  own mean by its count over the global count (`ops/losses.
  loss_denominator`, summed over the data group first) and by the data
  axis's size, so that the average of the ranks' losses and gradients is
  the global one, and the L2 term, which every rank adds, counts once;
- one explicit average over the data group carries every dense gradient
  and the loss (NCCL's own average; a sum then a division on gloo), never
  DDP's divide-by-world of per-rank means, which is wrong under weights;
  the tables of a sparse plan average only their touched rows
  (train/sparse_embed.py);
- a rank draws the whole batch's dropout mask and applies its rows
  (`models/base.set_dropout_rows`), so a world of N equals a world of 1
  with dropout on;
- the optimizer then runs on each rank on equal gradients, so replicated
  parameters and optimizer state stay bitwise equal across the ranks.

The model-side axes (`model`, `seq`, `pipe`) split parameters or
activations (parallel/sharding.py) and their collectives carry gradients
(parallel/distributed.py).  One convention makes every reduction right,
whatever a rank computes: the objective is the sum over the ranks of
their losses, each rank's loss (L2 term included) divided by R, the
number of ranks that see its rows (the product of the model-side axes'
sizes), and a split parameter's L2 term counted once for each of its
blocks.  Every collective's backward is its exact transpose under that
sum, so after the backward:
- a parameter replicated over a model-side axis is summed over that
  axis's group (its ranks saw the same rows but may have computed
  different parts: experts, fields, query tokens, stages), then averaged
  over the data group as above;
- a parameter split over an axis is not reduced over it: its block's
  gradient came back summed by the collective's transpose.
The reported loss is the one-device loss, with the L2 term of the whole
parameters.

`make_local_sgd_epoch_step` is the JAX package's local SGD (SAGN): each
data rank runs `local_sgd_window` plain-SGD updates on its own replica,
over its own rows, normalised per rank as the JAX package's vmap over the
shard axis is, with no communication; the replicas are averaged over the
data group every K updates and at the end of every call (a chunk, or the
resident tier's epoch).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..config.schema import JobConfig
from ..data import pipeline as pipe
from ..embed.dedup import UNIQUE_KEY
from ..models.base import Wire, set_dropout_generator, set_dropout_rows
from ..obs.flops import instrument
from ..ops import losses as losses_lib
from ..ops.int8_matmul import int8_available
from ..parallel import distributed
from ..parallel.mesh import DATA_AXIS
from ..parallel.sharding import model_forward, shard_batch
from .train_state import TrainState

Batch = dict[str, torch.Tensor]

# keeps the dropout stream apart from the init stream of the same seed
_DROPOUT_SALT = 0x6B0D01


def _int8_reaches_device(job: JobConfig) -> bool:
    cdt = job.model.compute_dtype
    return (pipe.wire_mode(job.schema, job.data, cdt) == "int8"
            or pipe.resident_feature_format(job.schema, job.data,
                                            cdt) == "int8")


def wire_fused_into_model(job: JobConfig) -> bool:
    """True when the model takes int8 wire features natively: int8
    features reach the card (int8 wire or int8 residency), the model is
    the MLP, and layer 0's shape is within the kernel's gate."""
    if job.model.model_type != "mlp" or not job.model.hidden_nodes:
        return False
    if not _int8_reaches_device(job):
        return False
    return int8_available(job.schema.feature_count, job.model.hidden_nodes[0])


def wire_grid(job: JobConfig) -> Wire:
    """The static grid as the model's layer 0 holds it: (scale, offset or
    None when the offset is all zeros)."""
    scale, offset = pipe.wire_params(job.schema, job.data)
    return (tuple(float(v) for v in scale),
            tuple(float(v) for v in offset) if np.any(offset) else None)


def make_wire_decode(job: JobConfig
                     ) -> Optional[Callable[[torch.Tensor], torch.Tensor]]:
    """f32 inverse of the int8 wire (x = q * scale + offset) before the
    model, or None when no int8 features reach the card or the model
    consumes them natively."""
    if not _int8_reaches_device(job) or wire_fused_into_model(job):
        return None
    scale, offset = pipe.wire_params(job.schema, job.data)
    s = torch.from_numpy(scale)
    o = torch.from_numpy(offset) if np.any(offset) else None

    def decode(features: torch.Tensor) -> torch.Tensor:
        if features.dtype != torch.int8:
            return features
        x = features.float() * s.to(features.device)
        return x if o is None else x + o.to(features.device)

    return decode


def decode_target_weight(batch: Batch) -> tuple[torch.Tensor, torch.Tensor]:
    """Inverse of the compact target/weight wire: integer targets back to
    f32, an elided weight column as ones."""
    target = batch["target"]
    if not target.is_floating_point():
        target = target.float()
    weight = batch.get("weight")
    if weight is None:
        weight = torch.ones((target.shape[0], 1), dtype=torch.float32,
                            device=target.device)
    return target, weight


class DropoutStream:
    """One `torch.Generator` per device, re-seeded for every update from
    (train.seed ^ 0x6B0D01, step): the masks are a pure function of the
    seed and the step, distinct at every step."""

    def __init__(self, seed: int):
        self.seed = seed ^ _DROPOUT_SALT
        self._gens: dict[torch.device, torch.Generator] = {}

    def generator(self, device: torch.device, step: int) -> torch.Generator:
        gen = self._gens.get(device)
        if gen is None:
            gen = self._gens[device] = torch.Generator(device=device)
        gen.manual_seed((self.seed * 1_000_003 + step) % (1 << 63))
        return gen


def make_loss_fn(job: JobConfig, mesh=None, with_l2: Optional[bool] = None):
    """(model, batch, step, rows=None) -> scalar f32 loss.  With
    ModelConfig DropoutRate > 0 the model runs in training mode with the
    dropout generator of this step; `rows` = (lo, hi, global rows) says
    the batch is those rows of a global batch, whose mask it then uses.
    On a mesh whose data axis is above 1 the loss is this rank's share of
    the global batch's, scaled by the axis's size (module docstring).
    The L2 term is added when `with_l2` (default: without a mesh; on a
    mesh `backward_on_mesh` adds it)."""
    if with_l2 is None:
        with_l2 = mesh is None
    base = losses_lib.get_loss(job.train.loss)
    if job.model.num_heads > 1:
        base = losses_lib.multitask_loss(base)
    l2 = job.model.l2_scale if with_l2 else 0.0
    dropout = (DropoutStream(job.train.seed)
               if job.model.dropout_rate > 0 else None)
    decode = make_wire_decode(job)
    n_data = mesh.axis_size(DATA_AXIS) if mesh is not None else 1
    if n_data > 1:
        count_of, floor = losses_lib.loss_denominator(job.train.loss)
        data_group = mesh.group(DATA_AXIS)

    def loss_fn(model, batch: Batch, step: int = 0,
                rows: Optional[tuple[int, int, int]] = None) -> torch.Tensor:
        feats = batch["features"]
        if decode is not None:
            feats = decode(feats)
        if dropout is not None:
            set_dropout_generator(model, dropout.generator(feats.device,
                                                           step))
            set_dropout_rows(model, rows)
        logits = model_forward(model, feats)
        target, weight = decode_target_weight(batch)
        loss = base(logits, target, weight)
        if n_data > 1:
            count = count_of(weight)
            total = distributed.all_reduce(count.clone(), data_group, "sum")
            loss = loss * (n_data * count.clamp(min=floor)
                           / total.clamp(min=floor))
        if l2 > 0:
            loss = loss + losses_lib.l2_penalty(model, l2)
        return loss

    return loss_fn


def make_apply_gradients(job: JobConfig, mesh=None
                         ) -> Callable[[TrainState, Batch], TrainState]:
    """(state, batch) -> state: one update from the parameters' .grad.  The
    dense optimizer, or the sparse plan's apply, which reads the batch's
    features or, when the feeder attached them, its unique ids (of the
    global batch, on a mesh)."""
    from .sparse_embed import make_sparse_apply

    sparse = make_sparse_apply(job, mesh)
    if sparse is None:
        return lambda state, batch: state.apply_gradients()
    return sparse


def _average(tensors: list, group, op: str = "avg") -> None:
    """Average (or with `op`, sum) the tensors over `group` in place, one
    collective for each dtype among them."""
    if group is None or not tensors:
        return
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group_ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group_ts])
        distributed.all_reduce(flat, group, op)
        for t, part in zip(group_ts,
                           flat.split([t.numel() for t in group_ts])):
            t.copy_(part.view_as(t))


def make_train_step(job: JobConfig, mesh=None
                    ) -> Callable[[TrainState, Batch], tuple[TrainState, dict]]:
    """(state, batch) -> (state, {"loss"}): forward, backward, one update
    (on a mesh: this rank's rows, the average over the data group, the
    update; `batch` is the global batch)."""
    return instrument(_train_step_fn(job, mesh), "train_step")


def _model_axes(mesh) -> list:
    """The mesh's model-side axes above 1 (every axis but `data`)."""
    return [a for a in mesh.axis_names
            if a != DATA_AXIS and mesh.axis_size(a) > 1]


def backward_on_mesh(state: TrainState, loss: torch.Tensor,
                     l2: float) -> torch.Tensor:
    """The backward of one step on a mesh, by the convention of the module
    docstring: (loss + the L2 term) / R, then each parameter's gradient
    summed over the model-side axes it is replicated over.  The tables of
    a sparse plan are left to its update.  Returns the reported loss (one
    element, f32): `loss` plus the whole parameters' L2 term; not yet
    averaged over the data group."""
    mesh, model, shardings = state.mesh, state.model, state.shardings
    axes = _model_axes(mesh)
    replicas = int(np.prod([mesh.axis_size(a) for a in axes]))
    params = list(model.named_parameters())
    total = loss
    if l2 > 0:
        squares = []
        for name, p in params:
            sq = torch.sum(torch.square(p.float()))
            if name in shardings:
                sq = shardings[name].split_factor() * sq
            squares.append(sq)
        total = loss + l2 * sum(squares)
    (total / replicas if replicas > 1 else total).backward()
    buckets: dict = {}
    for name, p in params:
        if state.table_slots and name in state.table_slots:
            continue
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        split = shardings[name].axes if name in shardings else ()
        key = tuple(a for a in axes if a not in split)
        buckets.setdefault(key, []).append(p.grad)
    for key, grads in buckets.items():
        for axis in key:
            _average(grads, mesh.group(axis), "sum")
    report = loss.detach().float().reshape(1)
    if l2 > 0:
        with torch.no_grad():
            whole = []
            for name, p in params:
                sq = torch.sum(torch.square(p.float())).reshape(1)
                if name in shardings:
                    for group in shardings[name].groups():
                        sq = distributed.all_reduce(sq, group, "sum")
                whole.append(sq)
            report = report + l2 * sum(whole)
    return report


def _train_step_fn(job: JobConfig, mesh=None):
    loss_fn = make_loss_fn(job, mesh)
    apply_grads = make_apply_gradients(job, mesh)

    if mesh is None:
        def step(state: TrainState, batch: Batch):
            state.model.train()
            for p in state.model.parameters():
                p.grad = None
            loss = loss_fn(state.model, batch, state.step)
            loss.backward()
            state = apply_grads(state, batch)
            return state, {"loss": loss.detach()}

        return step

    data_group = mesh.group(DATA_AXIS)
    n_data, d = mesh.axis_size(DATA_AXIS), mesh.axis_index(DATA_AXIS)
    l2 = job.model.l2_scale

    def mesh_step(state: TrainState, batch: Batch):
        model = state.model
        model.train()
        for p in model.parameters():
            p.grad = None
        local = shard_batch(batch, mesh, keep=(UNIQUE_KEY,))
        b = batch["features"].shape[0]
        loss = loss_fn(model, local, state.step,
                       rows=(d * b // n_data, (d + 1) * b // n_data, b))
        report = backward_on_mesh(state, loss, l2)
        grads = [p.grad for n, p in model.named_parameters()
                 if not (state.table_slots and n in state.table_slots)]
        _average(grads + [report], data_group)
        state = apply_grads(state, batch)
        return state, {"loss": report[0]}

    return mesh_step


def make_device_epoch_step(job: JobConfig, mesh=None):
    """The resident tier's epoch: (state, blocks, order) -> (state, loss
    sum on the card).  `blocks` holds the training partition on the card
    as (nb, B, ...) tensors; `order` is the epoch's block permutation.
    Each block is a view of the resident tensors (no copy)."""
    train_step = _train_step_fn(job, mesh)

    def epoch_step(state: TrainState, blocks: Batch, order):
        acc = None
        for idx in order:
            xs = {k: v[int(idx)] for k, v in blocks.items()}
            state, m = train_step(state, xs)
            acc = m["loss"] if acc is None else acc + m["loss"]
        return state, acc

    return instrument(epoch_step, "device_epoch_step")


def make_epoch_scan_step(job: JobConfig, mesh=None):
    """The staged tier's step (JAX `make_epoch_scan_step`): (state, block)
    -> (state, the loss summed over the block on the card).  `block`
    holds nb host-fed batches on the card as (nb, B, ...) tensors; the
    batches train in their order in the block, each a view (no copy), and
    nothing is read back to the host inside the block."""
    train_step = _train_step_fn(job, mesh)

    def scan_step(state: TrainState, block: Batch):
        acc = None
        for i in range(next(iter(block.values())).shape[0]):
            state, m = train_step(state, {k: v[i] for k, v in block.items()})
            acc = m["loss"] if acc is None else acc + m["loss"]
        return state, acc

    return instrument(scan_step, "epoch_scan_step")


def make_local_sgd_epoch_step(job: JobConfig, mesh=None,
                              with_order: bool = False):
    """Local SGD over one call (JAX `make_local_sgd_epoch_step`): (state,
    blocks) -> (state, loss sum), or (state, blocks, order) on the
    resident tier (`with_order`).  Each data rank trains its rows of every
    global batch with plain p - lr * g updates of its own replica, its
    loss normalised over its own rows (the JAX package's per-shard vmap)
    and its dropout folded from (step + i) * Nd + d, as there; the
    replicas are averaged over the data group after every
    `local_sgd_window` updates and at the end of the call.  The loss sum
    is the average over the ranks of their sums.  The optimizer's state
    is left as it is, as in the JAX package.  With model-side axes the
    gradients are reduced over them as in the synchronous step
    (`backward_on_mesh`) before each update."""
    on_axes = mesh is not None and (mesh.size > mesh.axis_size(DATA_AXIS))
    loss_fn = make_loss_fn(job, with_l2=not on_axes)
    l2 = job.model.l2_scale
    k = job.train.local_sgd_window
    lr = job.train.optimizer.learning_rate
    n_data = mesh.axis_size(DATA_AXIS) if mesh is not None else 1
    d = mesh.axis_index(DATA_AXIS) if mesh is not None else 0
    group = mesh.group(DATA_AXIS) if mesh is not None else None

    def epoch_step(state: TrainState, blocks: Batch, order=None):
        model = state.model
        model.train()
        params = list(model.parameters())
        nb = blocks["features"].shape[0]
        acc = None
        for i, idx in enumerate(order if with_order else range(nb)):
            xs = {key: v[int(idx)] for key, v in blocks.items()}
            if mesh is not None:
                xs = shard_batch(xs, mesh)
            for p in params:
                p.grad = None
            loss = loss_fn(model, xs, (state.step + i) * n_data + d)
            if on_axes:
                loss = backward_on_mesh(state, loss, l2)[0]
            else:
                loss.backward()
            with torch.no_grad():
                for p in params:
                    if p.grad is not None:
                        p.sub_(lr * p.grad)
            acc = loss.detach() if acc is None else acc + loss.detach()
            if (i + 1) % k == 0:
                with torch.no_grad():
                    _average(params, group)
        with torch.no_grad():
            _average(params, group)  # the call's end is a sync point
        acc = distributed.all_reduce(acc.reshape(1), group, "avg")[0]
        state.step += nb
        return state, acc

    if with_order:
        return instrument(epoch_step, "local_sgd_epoch_step")
    return instrument(lambda state, blocks: epoch_step(state, blocks),
                      "local_sgd_epoch_step")


def make_eval_step(job: JobConfig) -> Callable[[TrainState, Batch],
                                              torch.Tensor]:
    """Scores (sigmoid probabilities) of a batch, the model in eval mode
    (dropout off).  Accepts int8 wire batches, decoded as in training."""
    decode = make_wire_decode(job)

    def score(state: TrainState, batch: Batch) -> torch.Tensor:
        feats = batch["features"]
        if decode is not None:
            feats = decode(feats)
        model = state.model
        was_training = model.training
        model.eval()
        try:
            with torch.no_grad():
                return torch.sigmoid(model_forward(model, feats).float())
        finally:
            model.train(was_training)

    return instrument(score, "eval_step")
