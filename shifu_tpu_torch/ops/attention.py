"""Multi-head attention (port of `mha` in shifu_tpu/ops/attention.py).

Ring and Ulysses attention (sequence parallelism) are not ported yet; see
ROADMAP.md.
"""

from __future__ import annotations

from typing import Optional

import torch


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        scale: Optional[float] = None) -> torch.Tensor:
    """Standard multi-head attention.  q,k,v: (B, H, S, D) -> (B, H, S, D).

    Scores are formed in the input dtype and the softmax runs in float32;
    the weights are cast to `v.dtype` before the second product, as the JAX
    code does."""
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * scale
    w = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", w.to(v.dtype), v)
