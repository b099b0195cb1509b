"""Activation registry with the reference's name mapping (port of
shifu_tpu/ops/activations.py).

sigmoid/tanh/relu/leakyrelu by name; anything else (including None) falls
back to leaky_relu.  TF's leaky_relu alpha of 0.2 is pinned explicitly:
torch's default negative slope is 0.01.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

Activation = Callable[[torch.Tensor], torch.Tensor]

_LEAKY_ALPHA = 0.2  # tf.nn.leaky_relu default (TF 1.4), used by the reference


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope=_LEAKY_ALPHA)


_REGISTRY: dict[str, Activation] = {
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "relu": torch.relu,
    "leakyrelu": leaky_relu,
}


def get_activation(name: str | None) -> Activation:
    if not name:
        return leaky_relu
    return _REGISTRY.get(str(name).lower(), leaky_relu)
