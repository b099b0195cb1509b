"""Mixture-of-experts MLP (port of shifu_tpu/models/moe.py): a dense
softmax gate `gate` over the raw features (softmax in float32), E expert
trunks held as stacked kernels `experts/kernel{i}` (E, in, out) and biases
`experts/bias{i}` (E, out), one batched product over every expert per
layer, a gate-weighted combination in float32 and the shared head
`shifu_output_0` of width `num_heads`.

Every expert sees the whole batch (soft gating, no routing), so the model
is static-shape products: `torch.einsum` over the expert axis, as the JAX
module's XLA einsums, which reach no Pallas kernel.  The stacked kernels
are Xavier-uniform per expert over (in, out), the expert axis a batch
axis, drawn from the module's `torch.Generator`; the biases start at 0.

Expert parallelism: with the expert leaves split by expert over a mesh
axis (the JAX package's `.*\bexperts/.*` rule over `model`,
parallel/sharding.EXPERT_RULES), each rank holds E/n experts and runs
their batched products only; the gate stays whole, and the gate-weighted
combination of this rank's experts is summed over the axis with a
gradient (the psum XLA inserts in JAX).  An expert leaf that no rule
splits is sliced to this rank's experts where it is used."""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..config.schema import ModelSpec
from ..ops.activations import get_activation
from ..parallel.distributed import sum_forward
from .base import Dropout, ShifuDense, dtype_of


def stacked_xavier(shape: tuple[int, int, int],
                   generator: Optional[torch.Generator]) -> torch.Tensor:
    """Glorot uniform over the last two axes with the first a batch axis:
    limit sqrt(6 / (in + out)) for every expert."""
    _e, d_in, d_out = shape
    limit = math.sqrt(6.0 / (d_in + d_out))
    return torch.empty(shape, dtype=torch.float32).uniform_(
        -limit, limit, generator=generator)


class _Experts(nn.Module):
    """Holds `kernel{i}` / `bias{i}`: the state_dict keys
    `experts.kernel{i}`, which the artifact writes as the Flax names
    `experts/kernel{i}`.  Under expert parallelism `shard` is (first
    expert, expert count, axis, group) of this rank and `split` names the
    leaves held as this rank's block."""

    def __init__(self):
        super().__init__()
        self.shard = None
        self.split: set = set()

    def accept_split(self, leaf: str, sharding) -> bool:
        spec = tuple(sharding.spec)
        if not spec or spec[0] is None or any(spec[1:]):
            return False
        mesh, axis = sharding.mesh, spec[0]
        count = getattr(self, leaf).shape[0]
        shard = (mesh.axis_index(axis) * count, count, axis,
                 mesh.group(axis))
        if self.shard is not None and self.shard != shard:
            return False
        self.shard = shard
        self.split.add(leaf)
        return True

    def leaf(self, name: str) -> torch.Tensor:
        """This rank's experts of a leaf (all of them without a shard)."""
        t = getattr(self, name)
        if self.shard is None or name in self.split:
            return t
        lo, count = self.shard[:2]
        return t[lo:lo + count]


class MoEMLP(nn.Module):

    def __init__(self, spec: ModelSpec, in_features: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cdt = dtype_of(spec.compute_dtype)
        pdt = dtype_of(spec.param_dtype)
        e = spec.num_experts
        self.gate = ShifuDense(in_features, e, None, spec.xavier_bias_init,
                               spec.compute_dtype, generator,
                               param_dtype=spec.param_dtype)
        self.experts = _Experts()
        self.activations = tuple(spec.activations)
        d_in = in_features
        for i, n in enumerate(spec.hidden_nodes):
            self.experts.register_parameter(f"kernel{i}", nn.Parameter(
                stacked_xavier((e, d_in, n), generator).to(pdt)))
            self.experts.register_parameter(f"bias{i}", nn.Parameter(
                torch.zeros((e, n), dtype=pdt)))
            d_in = n
        self.dropouts = nn.ModuleList(Dropout(spec.dropout_rate)
                                      for _ in spec.hidden_nodes)
        self.shifu_output_0 = ShifuDense(
            d_in, spec.num_heads, None, spec.xavier_bias_init,
            spec.compute_dtype, generator, param_dtype=spec.param_dtype)

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        cdt = self.cdt
        x = features.to(cdt)
        gate = torch.softmax(self.gate(x).float(), dim=-1)      # (B, E)
        shard = self.experts.shard
        if shard is not None:
            gate = gate[:, shard[0]:shard[0] + shard[1]]
        h = x
        for i, (act, drop) in enumerate(zip(self.activations,
                                            self.dropouts)):
            kernel = self.experts.leaf(f"kernel{i}").to(cdt)
            bias = self.experts.leaf(f"bias{i}").to(cdt)
            # layer 0 shares its input across experts: (B, I) x (E, I, O)
            eq = "bi,eio->beo" if i == 0 else "bei,eio->beo"
            h = drop(get_activation(act)(torch.einsum(eq, h, kernel)
                                         + bias[None]))
        combined = torch.einsum("beh,be->bh", h.float(), gate)
        if shard is not None:
            combined = sum_forward(combined, shard[3])
        combined = combined.to(cdt)
        return self.shifu_output_0(combined).float()
