"""The numbers that decide `correct`, each a gap between the program and
the reference (or the control and the reference) that its limit in
`workloads/<cell>.json` bounds.

Training (`train_gaps`) reads, after the checked steps:

- `loss_gap`: the largest relative gap of a step's loss;
- `grad_gap`: the first step's gradient, leaf by leaf: the gap between
  the two sides' norms of a leaf, over the larger of the reference's norm
  of that leaf and its median leaf's norm (some gradients are all but
  zero), and the worst leaf of them;
- `grad_diff`: the same, with the norm of the two gradients' difference
  in place of the gap of their norms;
- `grad_noise`: the norm of the first gradient's difference from the
  reference's, leaf by leaf, over the larger of that leaf's and the median
  leaf's norm of the batch's sampling noise (the difference between the
  reference's gradients on the batch's two halves), the worst leaf of
  them: the error in units of the noise that the batch itself carries,
  which does not shrink on a seed whose first gradient is small.  A step
  that takes half of the batch reads 0.5 on every leaf;
- `step_gap`: the change of the weights over the checked steps, leaf by
  leaf as `grad_gap`, over the leaves whose reference gradient is at
  least a thousandth of the median leaf's: a leaf below that moves under
  Adam by round-off alone;
- and, beside them, the first step's loss gap, `step_diff` and the
  median leaf's gaps.

Which of them a cell compares, and against what limit, its
`workloads/<cell>.json` says; PERF.md gives the readings each limit was
set from.

Scoring (`score_gap`) is the largest absolute gap between a served
probability and the reference's for the same row.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

NEGLIGIBLE_GRAD = 1e-3  # of the median leaf's gradient norm


def _norms(leaves: dict) -> dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in
            leaves.items()}


def _median(values) -> float:
    vals = sorted(values)
    n = len(vals)
    return 0.5 * (vals[(n - 1) // 2] + vals[n // 2])


def _leaf_gaps(side: dict, ref: dict, only: Optional[set],
               of_difference: bool, scale: Optional[dict] = None
               ) -> dict[str, float]:
    """Each leaf's gap over the larger of the norm of that leaf and of the
    median leaf of `scale` (by default the reference): the gap of the two
    norms, or with `of_difference` the norm of the difference."""
    ns, nr = _norms(side), _norms(ref)
    nscale = nr if scale is None else _norms(scale)
    floor = _median(nscale.values())
    out = {}
    for k in nr:
        if only is not None and k not in only:
            continue
        gap = (float(torch.linalg.vector_norm((side[k] - ref[k]).double()))
               if of_difference else abs(ns[k] - nr[k]))
        out[k] = gap / max(nscale[k], floor, 1e-30)
    return out


def leaf_gap(side: dict, ref: dict, only: Optional[set] = None,
             of_difference: bool = False, scale: Optional[dict] = None
             ) -> tuple[float, str]:
    """(worst leaf's gap, that leaf's name); inf for a gap that is not
    finite."""
    gaps = _leaf_gaps(side, ref, only, of_difference, scale)
    worst, name = 0.0, ""
    for k, gap in gaps.items():
        if not math.isfinite(gap):
            return math.inf, k
        if gap > worst:
            worst, name = gap, k
    return worst, name


def median_leaf_gap(side: dict, ref: dict,
                    only: Optional[set] = None) -> float:
    return _median(_leaf_gaps(side, ref, only, False).values())


def moving_leaves(ref_grads: dict) -> set:
    """The leaves whose reference gradient is not nought to rounding."""
    nr = _norms(ref_grads)
    floor = NEGLIGIBLE_GRAD * _median(nr.values())
    return {k for k, v in nr.items() if v >= floor}


def train_gaps(side: dict, ref: dict, p0: dict, noise: dict) -> dict:
    """`side` and `ref`: {"losses": [...], "grads": {leaf: g}, "params":
    {leaf: w after the checked steps}}; `p0` the weights both began
    from; `noise` the difference of the reference's first gradients on
    the first batch's two halves."""
    loss_gap = max((abs(a - b) / max(abs(b), 1e-30)
                    if math.isfinite(a) else math.inf)
                   for a, b in zip(side["losses"], ref["losses"]))
    grad_gap, grad_leaf = leaf_gap(side["grads"], ref["grads"])
    moved = moving_leaves(ref["grads"])
    delta = {k: side["params"][k].float() - p0[k].float() for k in p0}
    ref_delta = {k: ref["params"][k].float() - p0[k].float() for k in p0}
    step_gap, step_leaf = leaf_gap(delta, ref_delta, moved)
    a, b = side["losses"][0], ref["losses"][0]
    return {"loss_gap": loss_gap, "grad_gap": grad_gap,
            "step_gap": step_gap, "grad_leaf": grad_leaf,
            "step_leaf": step_leaf, "leaves_compared": len(moved),
            "leaves": len(p0),
            "grad_diff": leaf_gap(side["grads"], ref["grads"],
                                  of_difference=True)[0],
            "grad_noise": leaf_gap(side["grads"], ref["grads"],
                                   of_difference=True, scale=noise)[0],
            "loss1_gap": abs(a - b) / max(abs(b), 1e-30),
            "step_diff": leaf_gap(delta, ref_delta, moved,
                                  of_difference=True)[0],
            "grad_gap_median": median_leaf_gap(side["grads"],
                                               ref["grads"]),
            "step_gap_median": median_leaf_gap(delta, ref_delta, moved)}


def score_gap(served: torch.Tensor, ref: torch.Tensor) -> float:
    """Largest |served - reference| over rows; inf for a row that is not
    finite."""
    diff = (served.float() - ref.float()).abs()
    if not bool(torch.isfinite(diff).all()):
        return math.inf
    return float(diff.max()) if diff.numel() else 0.0
