"""Shared model building blocks (port of shifu_tpu/models/base.py).

Parameters keep the JAX package's names and layouts so that an artifact's
`weights.npz` maps one to one onto a module's `state_dict` (`/` becomes
`.`): a dense kernel is `(in, out)` and the product is `y = x @ W + b`.
Compute runs in `compute_dtype` with parameters held in `param_dtype`
(ModelSpec.param_dtype, float32 by default), casting where Flax's
`nn.Dense(dtype=cdt, param_dtype=pdt)` casts: inputs, kernel and bias to
the compute dtype, product and bias add in it.  Parameters are drawn in
float32 and then rounded to `param_dtype`.

`_WireDense` is the int8-wire first layer of a model trained on the int8
wire: the same `kernel`/`bias`, but an int8 input goes through
`ops/int8_matmul` with the static wire grid instead of a separate dequant.
Dropout (`Dropout`, after each hidden layer of `MLPTrunk`) runs only in
training mode and draws from an explicit `torch.Generator`
(`set_dropout_generator`).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..config.schema import ModelSpec
from ..ops.activations import get_activation
from ..ops.initializers import bias_init, xavier_uniform, zeros_bias
from ..ops.int8_matmul import int8_available, int8_matmul_dequant

# the int8 wire grid: (per-column scale, per-column offset or None)
Wire = tuple[tuple[float, ...], Optional[tuple[float, ...]]]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


def cat_promoted(tensors: list, dim: int) -> torch.Tensor:
    """torch.cat after promoting every part to their widest dtype, as
    jnp.concatenate does (torch.cat refuses mixed dtypes)."""
    dt = tensors[0].dtype
    for t in tensors[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return torch.cat([t.to(dt) for t in tensors], dim=dim)


class Dense(nn.Module):
    """Counterpart of flax `nn.Dense` with `dtype=cdt`: params `kernel`
    (in, out) and `bias` (out,) in `param_dtype`; xavier kernel."""

    def __init__(self, in_features: int, out_features: int,
                 compute_dtype: str = "bfloat16", bias_fn=zeros_bias,
                 generator: Optional[torch.Generator] = None,
                 param_dtype: str = "float32"):
        super().__init__()
        self.cdt = dtype_of(compute_dtype)
        pdt = dtype_of(param_dtype)
        self.kernel = nn.Parameter(
            xavier_uniform((in_features, out_features), generator).to(pdt))
        self.bias = nn.Parameter(bias_fn((out_features,), generator).to(pdt))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return (x.to(self.cdt) @ self.kernel.to(self.cdt)
                + self.bias.to(self.cdt))


class _WireDense(Dense):
    """A Dense that takes int8 wire features natively (port of the JAX
    `_WireDense`): same params, names, shapes and init order as `Dense`,
    so the state_dict is the same either way.  An int8 input runs
    `int8_matmul_dequant` (the kernel on the card, its plain version on
    the CPU) with the grid held as non-persistent buffers.  Only shapes
    within the kernel's gate are built: outside it the trainer decodes the
    wire before the model (`train/step.make_wire_decode`).  Float inputs
    take the ordinary Dense math."""

    def __init__(self, in_features: int, out_features: int, wire: Wire,
                 compute_dtype: str = "bfloat16", bias_fn=zeros_bias,
                 generator: Optional[torch.Generator] = None,
                 param_dtype: str = "float32"):
        if not int8_available(in_features, out_features):
            raise ValueError(
                f"_WireDense: {in_features} -> {out_features} is outside the "
                "int8 kernel's shape gate; decode the wire before the model")
        super().__init__(in_features, out_features, compute_dtype, bias_fn,
                         generator, param_dtype)
        scale, offset = wire
        self.register_buffer("wire_scale",
                             torch.tensor(scale, dtype=torch.float32),
                             persistent=False)
        self.register_buffer(
            "wire_offset", None if offset is None
            else torch.tensor(offset, dtype=torch.float32), persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype != torch.int8:
            return super().forward(x)
        return int8_matmul_dequant(x, self.kernel, self.bias, self.wire_scale,
                                   self.wire_offset, self.cdt)


class ShifuDense(nn.Module):
    """The reference's `nn_layer`: xavier kernel, xavier-init bias (the
    reference quirk, `xavier_bias`), activation on `x @ W + b`.  The
    dense sits in a child named `Dense_0`, the name Flax gives it; with a
    `wire` grid it is a `_WireDense`."""

    def __init__(self, in_features: int, features: int,
                 activation: Optional[str] = None, xavier_bias: bool = True,
                 compute_dtype: str = "bfloat16",
                 generator: Optional[torch.Generator] = None,
                 wire: Optional[Wire] = None, param_dtype: str = "float32"):
        super().__init__()
        if wire is None:
            self.Dense_0 = Dense(in_features, features, compute_dtype,
                                 bias_init(xavier_bias), generator,
                                 param_dtype)
        else:
            self.Dense_0 = _WireDense(in_features, features, wire,
                                      compute_dtype, bias_init(xavier_bias),
                                      generator, param_dtype)
        self.activation = activation

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.Dense_0(x)
        if self.activation is not None:
            y = get_activation(self.activation)(y)
        return y


class Dropout(nn.Module):
    """Flax `nn.Dropout`: in training mode keep each value with
    probability 1 - rate and scale it by 1 / (1 - rate); identity in eval
    mode.  Draws from `generator` (set by `set_dropout_generator`; the
    device's default generator when None).  The draws differ from
    `jax.random`'s for the same seed."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate
        self.generator: Optional[torch.Generator] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate <= 0:
            return x
        keep_prob = 1.0 - self.rate
        u = torch.rand(x.shape, generator=self.generator, device=x.device)
        return torch.where(u < keep_prob, x / keep_prob, torch.zeros_like(x))


def set_dropout_generator(model: nn.Module,
                          generator: Optional[torch.Generator]) -> None:
    """Point every `Dropout` of `model` at `generator`."""
    for m in model.modules():
        if isinstance(m, Dropout):
            m.generator = generator


class MLPTrunk(nn.Module):
    """The hidden stack from ModelConfig (NumHiddenLayers / NumHiddenNodes /
    ActivationFunc), layers named `hidden_layer{i}`.  With
    `spec.dropout_rate > 0` each hidden layer's activation is followed by
    dropout, active only in training mode.  `wire` attaches to layer 0
    only: the one layer that sees wire-format inputs."""

    def __init__(self, spec: ModelSpec, in_features: int,
                 generator: Optional[torch.Generator] = None,
                 wire: Optional[Wire] = None):
        super().__init__()
        n_in = in_features
        for i, (n, act) in enumerate(zip(spec.hidden_nodes,
                                         spec.activations)):
            self.add_module(f"hidden_layer{i}", ShifuDense(
                n_in, n, act, spec.xavier_bias_init, spec.compute_dtype,
                generator, wire=wire if i == 0 else None,
                param_dtype=spec.param_dtype))
            n_in = n
        self.out_features = n_in
        # parameterless: the state_dict keeps only the hidden layers
        self.dropouts = nn.ModuleList(Dropout(spec.dropout_rate)
                                      for _ in spec.hidden_nodes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, drop in enumerate(self.dropouts):
            x = drop(getattr(self, f"hidden_layer{i}")(x))
        return x


class ScoringHead(nn.Module):
    """Linear head(s) `shifu_output_0` producing float32 logits; the
    sigmoid lives in the scorer."""

    def __init__(self, spec: ModelSpec, in_features: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.shifu_output_0 = ShifuDense(
            in_features, spec.num_heads, None, spec.xavier_bias_init,
            spec.compute_dtype, generator, param_dtype=spec.param_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.shifu_output_0(x).float()
