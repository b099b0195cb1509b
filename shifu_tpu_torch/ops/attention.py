"""Attention ops (port of shifu_tpu/ops/attention.py): multi-head
attention, and ring and Ulysses attention for sequence parallelism over
the mesh's `seq` axis.

As in the JAX package, ring and Ulysses attention run no kernel of their
own: their per-block math is plain products and the streamed softmax, and
their communication the collectives of parallel/distributed.py.  Where the
JAX functions take and return global arrays sharded on the sequence, these
take and return this rank's blocks: q, k, v (B, H, S/n, D), the rows of
this rank's data coordinate and its S/n tokens, so that no rank computes
attention for another data replica's rows (JAX's `_sp_spec`).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..parallel import distributed
from ..parallel.mesh import SEQ_AXIS


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


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mesh, seq_axis: str = SEQ_AXIS,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Sequence-parallel attention: this rank's q, k, v blocks (B, H,
    S/n, D) -> its block of the output.  K and V travel around the ring
    (the neighbour exchange j -> j + 1 mod n) while a streamed softmax
    keeps the running max and normaliser in float32, so no rank holds the
    S x S scores.  The JAX body rotates n times, the last rotation
    bringing the blocks home unused; here it rotates n - 1 times (the
    same math).  Equals `mha` on the gathered sequence."""
    n = mesh.axis_size(seq_axis)
    group = mesh.group(seq_axis)
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    b, h, sq, _ = q.shape
    qf = q.float()
    o = torch.zeros((b, h, sq, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, sq), float("-inf"), dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    kv = torch.stack([k, v])
    for i in range(n):
        k_blk, v_blk = kv[0], kv[1]
        scores = torch.einsum("bhqd,bhkd->bhqk", qf, k_blk.float()) * scale
        new_m = torch.maximum(m, scores.amax(dim=-1))
        corr = torch.exp(m - new_m)
        p = torch.exp(scores - new_m[..., None])
        l = l * corr + p.sum(dim=-1)
        o = o * corr[..., None] + torch.einsum("bhqk,bhkd->bhqd", p,
                                               v_blk.float())
        m = new_m
        if i < n - 1:
            kv = distributed.ppermute(kv, group, 1, ring=True)
    return (o / l[..., None]).to(q.dtype)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      mesh, seq_axis: str = SEQ_AXIS,
                      scale: Optional[float] = None) -> torch.Tensor:
    """All-to-all sequence-parallel attention (DeepSpeed-Ulysses): this
    rank's q, k, v blocks (B, H, S/n, D) -> its block of the output.  One
    all-to-all re-shards heads <-> sequence (each rank then holds H/n
    heads over the whole sequence; q, k and v travel together), `mha`
    runs on them, and the inverse all-to-all brings the output back.
    Needs the heads divisible by the `seq_axis` size."""
    n = mesh.axis_size(seq_axis)
    h = q.shape[1]
    if h % n != 0:
        raise ValueError(
            f"ulysses_attention needs heads ({h}) divisible by the "
            f"'{seq_axis}' mesh axis ({n}); use ring_attention otherwise")
    group = mesh.group(seq_axis)
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    # (3, B, H, S/n, D) -> (3, B, H/n, S, D): scatter heads, gather tokens
    qkv = distributed.all_to_all_grad(torch.stack([q, k, v]), group, 2, 3)
    out = mha(qkv[0], qkv[1], qkv[2], scale=scale)
    # (B, H/n, S, D) -> (B, H, S/n, D): gather heads, scatter tokens
    return distributed.all_to_all_grad(out, group, 2, 1)
