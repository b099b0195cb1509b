"""The training step's share of the card's bf16 peak: the model's FLOPs
per trained row (3 x the forward, perfbench/core/flops.py; a recomputed
forward is not counted) times the rows trained in the window, over the
window's seconds and 989 TFLOP/s."""

from perfbench.core import flops, peaks


def read(run: dict):
    if "samples" not in run:
        return None
    rate = flops.ft_train_flops(run["config"]) * run["samples"] \
        / run["window_s"]
    return 100.0 * rate / peaks.BF16_FLOPS
