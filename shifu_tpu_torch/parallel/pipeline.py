"""GPipe pipeline parallelism over the `pipe` mesh axis (port of
shifu_tpu/parallel/pipeline.py on torch.distributed).

A stack of identical layer stages, parameter leaves shaped (num_layers,
...) and split on the leading axis over `pipe` so that each rank holds its
stage's layers only, runs a train of microbatches: the fill/drain schedule
of n_micro + n_stages - 1 ticks, activations sent stage -> stage with a
neighbour exchange (`distributed.ppermute` over the open chain i -> i + 1)
after every tick but the last.  The outputs are the last stage's, summed
over the pipe group (JAX's psum), so that every stage holds them.

The JAX package computes every stage at every tick and throws the bubble
ticks' results away; here a stage computes only its n_micro ticks and
passes the activation it received through on the others (the same math;
ROADMAP.md section C).  A stage therefore runs its layers n_micro times a
step, whatever the stage count.

Differentiable end to end: autograd runs the transposed schedule, each
exchange's backward sending the cotangent back one stage.  Every rank runs
every exchange, and each exchange's result stays in the rank's graph (a
stage that does not use it attaches it with a zero cotangent), so the
ranks run the exchanges' backwards in the same order.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from . import distributed
from .mesh import PIPE_AXIS, Mesh

Params = dict[str, torch.Tensor]


def stage_slice(stacked_params: Params, stage: int, n_stages: int) -> Params:
    """The per-stage slice of (num_layers, ...) stacked params: layers
    [stage * lps, (stage + 1) * lps) where lps = num_layers / n_stages."""
    def cut(leaf):
        lps = leaf.shape[0] // n_stages
        return leaf[stage * lps:(stage + 1) * lps]
    return {k: cut(v) for k, v in stacked_params.items()}


def pipeline_reference(stage_fn: Callable[[Params, torch.Tensor],
                                          torch.Tensor],
                       stacked_params: Params, x: torch.Tensor,
                       n_stages: int) -> torch.Tensor:
    """Sequential oracle: every microbatch through all stages in order.
    x: (n_micro, mb, ...) -> (n_micro, mb, ...)."""
    outs = []
    for m in range(x.shape[0]):
        h = x[m]
        for s in range(n_stages):
            h = stage_fn(stage_slice(stacked_params, s, n_stages), h)
        outs.append(h)
    return torch.stack(outs)


def pipeline_apply(stage_fn: Callable[[Params, torch.Tensor], torch.Tensor],
                   stage_params: Params, x: torch.Tensor, mesh: Mesh,
                   axis: str = PIPE_AXIS) -> torch.Tensor:
    """Run microbatches through the stage pipeline over `axis`.

    stage_fn(params, h) -> h applies ONE stage (its share of layers) to one
    microbatch; the activation's shape is stage-invariant.  `stage_params`
    are this rank's stage's leaves, (num_layers / n_stages, ...); x is this
    rank's (n_micro, mb, ...) microbatches (its data rows).  Returns the
    (n_micro, mb, ...) outputs on every stage.  Equals `pipeline_reference`
    over the whole stack (tests/test_torch_pipeline.py)."""
    n_stages = mesh.axis_size(axis)
    if n_stages == 1:
        return pipeline_reference(stage_fn, stage_params, x, 1)
    group = mesh.group(axis)
    stage = mesh.axis_index(axis)
    last = n_stages - 1
    n_micro = x.shape[0]
    ticks = n_micro + n_stages - 1
    outs: list = []
    recv = None
    y = None
    for t in range(ticks):
        m = t - stage
        active = 0 <= m < n_micro
        if stage == 0:
            h = (x[m] if active else recv)
            if active and recv is not None:
                h = distributed.attach(h, recv)
        elif recv is not None:
            h = recv
        else:
            # what the first exchange sends from here is a placeholder,
            # but it must be in the graph (a leaf that asks for a
            # gradient), so that its exchange runs backward here too
            h = torch.zeros_like(x[0]).requires_grad_(
                torch.is_grad_enabled())
        y = stage_fn(stage_params, h) if active else h
        if stage == last and active:
            outs.append(y)
        if t < ticks - 1:
            recv = distributed.ppermute(y, group, 1, ring=False)
    if stage == last:
        out = torch.stack(outs)
    else:
        out = distributed.attach(torch.zeros_like(x), recv)
    return distributed.sum_forward(out, group)


def n_microbatches(spec: Any) -> int:
    """ModelSpec.pipeline_microbatches, 0 meaning one per stage."""
    return spec.pipeline_microbatches or spec.pipeline_stages
