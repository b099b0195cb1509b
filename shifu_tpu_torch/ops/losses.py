"""Losses with the reference's semantics (port of shifu_tpu/ops/losses.py).

The reference loss is `tf.losses.mean_squared_error(predictions=sigmoid_out,
labels=y, weights=sample_weight)` with TF's SUM_BY_NONZERO_WEIGHTS
reduction: sum(w * (p - y)^2) / count(w != 0), squared error on the sigmoid
probability.  `bce` / `weighted_bce` are the cross-entropy alternatives.
Every loss takes logits, target and weight of shape (B, H) and upcasts the
logits to f32 before the sigmoid.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

LossFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


def weighted_mse(logits: torch.Tensor, target: torch.Tensor,
                 weight: torch.Tensor) -> torch.Tensor:
    """sum(w * (sigmoid(logits) - y)^2) / count(w != 0)."""
    p = torch.sigmoid(logits.float())
    sq = weight * torch.square(p - target)
    nonzero = torch.clamp((weight != 0).sum(), min=1)
    return sq.sum() / nonzero.float()


def _bce_rows(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    logits = logits.float()
    return (torch.clamp(logits, min=0) - logits * target
            + torch.log1p(torch.exp(-logits.abs())))


def bce(logits: torch.Tensor, target: torch.Tensor,
        weight: torch.Tensor) -> torch.Tensor:
    """Unweighted sigmoid binary cross-entropy, mean over all rows."""
    del weight
    return _bce_rows(logits, target).mean()


def weighted_bce(logits: torch.Tensor, target: torch.Tensor,
                 weight: torch.Tensor) -> torch.Tensor:
    """Weight-normalized sigmoid binary cross-entropy."""
    denom = torch.clamp(weight.sum(), min=1e-6)
    return (weight * _bce_rows(logits, target)).sum() / denom


_REGISTRY: dict[str, LossFn] = {
    "weighted_mse": weighted_mse,
    "bce": bce,
    "weighted_bce": weighted_bce,
}


# what each loss divides its row sum by, before the clamp, and the clamp's
# floor: a data-parallel rank rescales its loss by the global count
# (train/step.make_loss_fn)
_DENOMINATORS: dict[str, tuple[Callable[[torch.Tensor], torch.Tensor],
                               float]] = {
    "weighted_mse": (lambda w: (w != 0).sum().float(), 1.0),
    "bce": (lambda w: torch.full((), float(w.shape[0]),
                                 device=w.device), 0.0),
    "weighted_bce": (lambda w: w.sum().float(), 1e-6),
}


def loss_denominator(name: str
                     ) -> tuple[Callable[[torch.Tensor], torch.Tensor], float]:
    """(fn(weight) -> the count the loss divides by, the floor it clamps
    that count to): nonzero weights for weighted_mse, rows for bce, the
    weight sum for weighted_bce.  The same for every head of a
    multi-task loss."""
    get_loss(name)  # the registry's error for an unknown name
    return _DENOMINATORS[name]


def get_loss(name: str) -> LossFn:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown loss {name!r}; available: "
                       f"{sorted(_REGISTRY)}") from None


def multitask_loss(base: LossFn) -> LossFn:
    """Average `base` over the H heads of (B, H) logits and targets."""
    def fn(logits: torch.Tensor, target: torch.Tensor,
           weight: torch.Tensor) -> torch.Tensor:
        per_head = [base(logits[:, i:i + 1], target[:, i:i + 1], weight)
                    for i in range(logits.shape[-1])]
        return torch.stack(per_head).mean()
    return fn


def l2_penalty(model: nn.Module, scale: float) -> torch.Tensor:
    """scale * the sum of squares of every parameter (kernels and biases)."""
    params = list(model.parameters())
    if scale <= 0.0:
        return torch.zeros((), device=params[0].device if params else None)
    return scale * sum(torch.sum(torch.square(p.float())) for p in params)
