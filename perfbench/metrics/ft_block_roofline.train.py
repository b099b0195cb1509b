"""The fused FT block's (#1, csrc/ft_block.cu) share of its roofline in
the traced segment of a training run: the bound of one call at the
cell's shapes (perfbench/core/flops.ft_block_bound_s) times the calls the
trace holds, over their device time.  The calls are the trace's device
events whose names hold one of NAMES."""

from perfbench.core import flops

NAMES = ("ft_block_kernel",)


def read(run: dict):
    t = run.get("trace")
    if not t:
        return None
    count, seconds = 0, 0.0
    for name, (n, s) in t["kernels"].items():
        if any(k in name for k in NAMES):
            count += n
            seconds += s
    if count == 0 or seconds <= 0:
        return None
    cfg = run["config"]
    b = run["traffic"]["batch_rows"]
    bound = flops.ft_block_bound_s(
        b, cfg["n_num_features"] + 1, cfg["token_dim"],
        cfg["num_attention_heads"], cfg["mlp_ratio"])
    return 100.0 * count * bound / seconds
