"""Train and eval steps (port of shifu_tpu/train/step.py, single device).

PyTorch runs eagerly, so a "step builder" returns a plain function: the
train step is forward, backward and the optimizer update on one batch; the
device-resident epoch is a Python loop over the (nb, B, ...) blocks already
on the card, in `epoch_permutation` order, with the loss summed on the card
and read once per epoch.

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

Waits for later slices: local SGD and the staged (scan over host-fed
blocks) step.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..config.schema import JobConfig
from ..data import pipeline as pipe
from ..models.base import Wire, set_dropout_generator
from ..ops import losses as losses_lib
from ..ops.int8_matmul import int8_available
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


def make_loss_fn(job: JobConfig):
    """(model, batch, step) -> scalar f32 loss.  With ModelConfig
    DropoutRate > 0 the model runs in training mode with the dropout
    generator of this step."""
    base = losses_lib.get_loss(job.train.loss)
    if job.model.num_heads > 1:
        base = losses_lib.multitask_loss(base)
    l2 = job.model.l2_scale
    dropout = (DropoutStream(job.train.seed)
               if job.model.dropout_rate > 0 else None)
    decode = make_wire_decode(job)

    def loss_fn(model, batch: Batch, step: int = 0) -> torch.Tensor:
        feats = batch["features"]
        if decode is not None:
            feats = decode(feats)
        if dropout is not None:
            set_dropout_generator(model, dropout.generator(feats.device,
                                                           step))
        logits = model(feats)
        target, weight = decode_target_weight(batch)
        loss = base(logits, target, weight)
        if l2 > 0:
            loss = loss + losses_lib.l2_penalty(model, l2)
        return loss

    return loss_fn


def make_apply_gradients(job: JobConfig
                         ) -> Callable[[TrainState, Batch], TrainState]:
    """(state, batch) -> state: one update from the parameters' .grad.  The
    dense optimizer, or the sparse plan's apply, which reads the batch's
    features or, when the feeder attached them, its unique ids."""
    from .sparse_embed import make_sparse_apply

    sparse = make_sparse_apply(job)
    if sparse is None:
        return lambda state, batch: state.apply_gradients()
    return sparse


def make_train_step(job: JobConfig
                    ) -> Callable[[TrainState, Batch], tuple[TrainState, dict]]:
    """(state, batch) -> (state, {"loss"}): forward, backward, one update."""
    loss_fn = make_loss_fn(job)
    apply_grads = make_apply_gradients(job)

    def step(state: TrainState, batch: Batch):
        state.model.train()
        for p in state.model.parameters():
            p.grad = None
        loss = loss_fn(state.model, batch, state.step)
        loss.backward()
        state = apply_grads(state, batch)
        return state, {"loss": loss.detach()}

    return step


def make_device_epoch_step(job: JobConfig):
    """The resident tier's epoch: (state, blocks, order) -> (state, loss
    sum on the card).  `blocks` holds the training partition on the card
    as (nb, B, ...) tensors; `order` is the epoch's block permutation.
    Each block is a view of the resident tensors (no copy)."""
    train_step = make_train_step(job)

    def epoch_step(state: TrainState, blocks: Batch, order):
        acc = None
        for idx in order:
            xs = {k: v[int(idx)] for k, v in blocks.items()}
            state, m = train_step(state, xs)
            acc = m["loss"] if acc is None else acc + m["loss"]
        return state, acc

    return epoch_step


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
                return torch.sigmoid(model(feats).float())
        finally:
            model.train(was_training)

    return score
