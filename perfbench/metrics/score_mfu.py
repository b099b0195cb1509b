"""Scoring's share of the card's bf16 peak: the forward's FLOPs per row
(perfbench/core/flops.py) times the rows scored in the window, over the
window's seconds and 989 TFLOP/s."""

from perfbench.core import flops, peaks


def read(run: dict):
    if "rows" not in run:
        return None
    rate = flops.ft_forward_flops(run["config"]) * run["rows"] \
        / run["window_s"]
    return 100.0 * rate / peaks.BF16_FLOPS
