"""Model factory: ModelSpec.model_type -> torch module (port of
shifu_tpu/models/registry.py): a table of builders by type name, filled by
`@register`, with every model of the JAX ladder registered below."""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from ..config.schema import DataSchema, ModelSpec
from ..device import DeviceLike, resolve_device
from .base import Wire

Builder = Callable[..., nn.Module]
_BUILDERS: dict[str, Builder] = {}


def register(name: str):
    """Decorator: make `fn` the builder of model type `name` (replacing
    the one registered under it, as in JAX)."""
    def deco(fn: Builder) -> Builder:
        _BUILDERS[name] = fn
        return fn
    return deco


def build_model(spec: ModelSpec, schema: DataSchema,
                device: DeviceLike = None,
                generator: Optional[torch.Generator] = None,
                wire: Optional[Wire] = None, train: bool = False,
                mesh=None) -> nn.Module:
    """Build the module for `spec` on `device` (default `cuda:0`), in eval
    mode for scoring or in training mode (`train=True`: dropout active).

    The builder registered under `spec.model_type` is called as
    `builder(spec, schema, generator, mesh=mesh)` and builds on the CPU,
    drawing its parameters from `generator` (a fresh one seeded 0 when
    None), so one seed gives the same weights on every device; the module
    is then moved to `device`.  Every builder accepts `mesh`
    (parallel/mesh.Mesh) and may ignore it: the FT-Transformer's
    ring/Ulysses attention and pipelined trunk use its `seq` and `pipe`
    axes, the other placements are made on the built model
    (parallel/sharding.place_model).  `wire` (the int8 grid of
    data/pipeline.wire_params) is passed, as `wire=`, only to the "mlp"
    builder, for its layer 0; other types never see wire inputs, as in
    the JAX package."""
    try:
        builder = _BUILDERS[spec.model_type]
    except KeyError:
        raise KeyError(f"unknown model_type {spec.model_type!r}; "
                       f"available: {sorted(_BUILDERS)}") from None
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    if spec.model_type == "mlp" and wire is not None:
        model = builder(spec, schema, generator, mesh=mesh, wire=wire)
    else:
        model = builder(spec, schema, generator, mesh=mesh)
    return model.to(dev).train(train)


@register("mlp")
def _build_mlp(spec: ModelSpec, schema: DataSchema,
               generator: torch.Generator, mesh=None,
               wire: Optional[Wire] = None) -> nn.Module:
    from .mlp import ShifuMLP
    return ShifuMLP(spec, schema.feature_count, generator, wire)


@register("wide_deep")
def _build_wide_deep(spec: ModelSpec, schema: DataSchema,
                     generator: torch.Generator, mesh=None) -> nn.Module:
    from .embedding import field_layout
    from .wide_deep import WideDeep
    return WideDeep(spec, field_layout(schema), generator)


@register("deepfm")
def _build_deepfm(spec: ModelSpec, schema: DataSchema,
                  generator: torch.Generator, mesh=None) -> nn.Module:
    from .deepfm import DeepFM
    from .embedding import field_layout
    return DeepFM(spec, field_layout(schema), generator)


@register("multitask")
def _build_multitask(spec: ModelSpec, schema: DataSchema,
                     generator: torch.Generator, mesh=None) -> nn.Module:
    from .multitask import MultiTask
    return MultiTask(spec, schema.feature_count, generator)


@register("moe_mlp")
def _build_moe_mlp(spec: ModelSpec, schema: DataSchema,
                   generator: torch.Generator, mesh=None) -> nn.Module:
    from .moe import MoEMLP
    return MoEMLP(spec, schema.feature_count, generator)


@register("ft_transformer")
def _build_ft_transformer(spec: ModelSpec, schema: DataSchema,
                          generator: torch.Generator,
                          mesh=None) -> nn.Module:
    from .embedding import field_layout
    from .ft_transformer import FTTransformer
    return FTTransformer(spec, field_layout(schema), generator, mesh=mesh)
