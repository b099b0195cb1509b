"""Parameter initializers matching the reference's choices (port of
shifu_tpu/ops/initializers.py), drawing from an explicit `torch.Generator`.

The distributions match the JAX package's; the numbers do not (a
`torch.Generator` and a `jax.random` key give different draws from one
seed).  Weights carried from a JAX artifact go through
`export/artifact.params_from_jax`, not through these.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch


def _uniform(shape: Sequence[int], limit: float,
             generator: Optional[torch.Generator]) -> torch.Tensor:
    out = torch.empty(tuple(shape), dtype=torch.float32)
    return out.uniform_(-limit, limit, generator=generator)


def xavier_uniform(shape: Sequence[int],
                   generator: Optional[torch.Generator] = None
                   ) -> torch.Tensor:
    """Glorot uniform as `jax.nn.initializers.glorot_uniform()` computes
    it: fan_in = shape[-2] * receptive, fan_out = shape[-1] * receptive,
    receptive = prod(shape[:-2]); limit sqrt(6 / (fan_in + fan_out))."""
    shape = tuple(int(s) for s in shape)
    receptive = math.prod(shape[:-2]) if len(shape) > 2 else 1
    fan_in = (shape[-2] if len(shape) > 1 else shape[-1]) * receptive
    fan_out = shape[-1] * receptive
    return _uniform(shape, math.sqrt(6.0 / (fan_in + fan_out)), generator)


def xavier_bias(shape: Sequence[int],
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """TF-style xavier init for a rank-1 bias: fan_in = fan_out = n, so
    uniform(-sqrt(3/n), +sqrt(3/n))."""
    n = int(shape[-1])
    return _uniform(shape, math.sqrt(3.0 / n), generator)


def zeros_bias(shape: Sequence[int],
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
    return torch.zeros(tuple(shape), dtype=torch.float32)


def bias_init(xavier: bool):
    """Bias initializer factory: reference parity (xavier) or zero init."""
    return xavier_bias if xavier else zeros_bias
