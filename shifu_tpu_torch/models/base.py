"""Shared model building blocks (port of shifu_tpu/models/base.py).

Parameters keep the JAX package's names and layouts so that an artifact's
`weights.npz` maps one to one onto a module's `state_dict` (`/` becomes
`.`): a dense kernel is `(in, out)` and the product is `y = x @ W + b`.
Compute runs in `compute_dtype` with parameters held in float32, casting
where Flax's `nn.Dense(dtype=cdt)` casts: inputs, kernel and bias to the
compute dtype, product and bias add in it.

The int8-wire first layer (`_WireDense`) belongs to the training slice and
is not ported yet (ROADMAP.md).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..config.schema import ModelSpec
from ..ops.activations import get_activation
from ..ops.initializers import bias_init, xavier_uniform, zeros_bias

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


class Dense(nn.Module):
    """Counterpart of flax `nn.Dense` with `dtype=cdt`: params `kernel`
    (in, out) and `bias` (out,), float32; xavier kernel."""

    def __init__(self, in_features: int, out_features: int,
                 compute_dtype: str = "bfloat16", bias_fn=zeros_bias,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cdt = dtype_of(compute_dtype)
        self.kernel = nn.Parameter(
            xavier_uniform((in_features, out_features), generator))
        self.bias = nn.Parameter(bias_fn((out_features,), generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return (x.to(self.cdt) @ self.kernel.to(self.cdt)
                + self.bias.to(self.cdt))


class ShifuDense(nn.Module):
    """The reference's `nn_layer`: xavier kernel, xavier-init bias (the
    reference quirk, `xavier_bias`), activation on `x @ W + b`.  The
    dense sits in a child named `Dense_0`, the name Flax gives it."""

    def __init__(self, in_features: int, features: int,
                 activation: Optional[str] = None, xavier_bias: bool = True,
                 compute_dtype: str = "bfloat16",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.Dense_0 = Dense(in_features, features, compute_dtype,
                             bias_init(xavier_bias), generator)
        self.activation = activation

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.Dense_0(x)
        if self.activation is not None:
            y = get_activation(self.activation)(y)
        return y


class MLPTrunk(nn.Module):
    """The hidden stack from ModelConfig (NumHiddenLayers / NumHiddenNodes /
    ActivationFunc), layers named `hidden_layer{i}`.  Scoring only: dropout
    is a training-time op and belongs to the training slice."""

    def __init__(self, spec: ModelSpec, in_features: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        n_in = in_features
        for i, (n, act) in enumerate(zip(spec.hidden_nodes,
                                         spec.activations)):
            self.add_module(f"hidden_layer{i}", ShifuDense(
                n_in, n, act, spec.xavier_bias_init, spec.compute_dtype,
                generator))
            n_in = n
        self.out_features = n_in

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.children():
            x = layer(x)
        return x


class ScoringHead(nn.Module):
    """Linear head(s) `shifu_output_0` producing float32 logits; the
    sigmoid lives in the scorer."""

    def __init__(self, spec: ModelSpec, in_features: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.shifu_output_0 = ShifuDense(
            in_features, spec.num_heads, None, spec.xavier_bias_init,
            spec.compute_dtype, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.shifu_output_0(x).float()
