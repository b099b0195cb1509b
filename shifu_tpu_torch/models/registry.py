"""Model factory: ModelSpec.model_type -> torch module (port of
shifu_tpu/models/registry.py): every model of the JAX ladder."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..config.schema import DataSchema, ModelSpec
from ..device import DeviceLike, resolve_device
from .base import Wire


def build_model(spec: ModelSpec, schema: DataSchema,
                device: DeviceLike = None,
                generator: Optional[torch.Generator] = None,
                wire: Optional[Wire] = None, train: bool = False
                ) -> nn.Module:
    """Build the module for `spec` on `device` (default `cuda:0`), in eval
    mode for scoring or in training mode (`train=True`: dropout active).
    Parameters are drawn from `generator` (a fresh one seeded 0 when None)
    on the CPU and then moved, so one seed gives the same weights on every
    device.  `wire` (the int8 grid of data/pipeline.wire_params) goes to
    the MLP's layer 0; other model types never see wire inputs and ignore
    it, as in the JAX package."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    if spec.model_type == "mlp":
        from .mlp import ShifuMLP
        model = ShifuMLP(spec, schema.feature_count, generator, wire)
    elif spec.model_type == "multitask":
        from .multitask import MultiTask
        model = MultiTask(spec, schema.feature_count, generator)
    elif spec.model_type == "moe_mlp":
        from .moe import MoEMLP
        model = MoEMLP(spec, schema.feature_count, generator)
    elif spec.model_type in ("ft_transformer", "wide_deep", "deepfm"):
        from .deepfm import DeepFM
        from .embedding import field_layout
        from .ft_transformer import FTTransformer
        from .wide_deep import WideDeep
        cls = {"ft_transformer": FTTransformer, "wide_deep": WideDeep,
               "deepfm": DeepFM}[spec.model_type]
        model = cls(spec, field_layout(schema), generator)
    else:
        raise KeyError(f"unknown model_type {spec.model_type!r}")
    return model.to(dev).train(train)
