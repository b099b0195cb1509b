"""Operation and byte counts from shapes, frozen here so that no later
change to the program's own counters moves the yardstick.

`ft_forward_flops` is the model's FLOPs per row: the products of the
forward pass (each block's QKV, projection and FFN matrices, the two
attention products, and the head), at 2 operations a multiply-add.
Elementwise work (tokenizer, LayerNorm, softmax, GELU, residuals) is not
counted, as model-FLOP utilisation conventionally leaves it out.  A
training step is 3 times the forward (forward, gradient of the inputs,
gradient of the weights); a recomputed forward, as the fused block's
backward does, is work the model does not need and is not counted.

`ft_block_ops`, `ft_block_cost` and `ft_block_bound_s` copy the fused
block's (`#1`, `shifu_tpu_torch/csrc/ft_block.cu`) operations, bytes and
bound as the port's kernel table states them: the four products on the
tensor cores in 3 bf16 passes (each f32 operand as 16-bit parts), the
rest of its work at the f32 rate, and x read and the output written in
f32 with every parameter read once.
"""

from __future__ import annotations

from . import peaks

FT_SPLIT_PASSES = 3


def ft_block_forward_flops(s: int, d: int, r: int) -> int:
    """Products of one pre-LN block on one row of s tokens of width d."""
    dense = 2 * s * (3 * d * d + d * d + 2 * r * d * d)
    attention = 2 * 2 * s * s * d
    return dense + attention


def ft_forward_flops(cfg: dict) -> int:
    """Forward FLOPs of one row of the FT-Transformer in `cfg` (a
    configuration file's dict)."""
    s = cfg["n_num_features"] + 1  # the CLS token
    d, r = cfg["token_dim"], cfg["mlp_ratio"]
    head = 2 * d * cfg["num_heads"]
    return cfg["num_layers"] * ft_block_forward_flops(s, d, r) + head


def ft_train_flops(cfg: dict) -> int:
    """Model FLOPs of one trained row: 3 x the forward."""
    return 3 * ft_forward_flops(cfg)


def ft_block_ops(b: int, s: int, d: int, h: int, r: int
                 ) -> tuple[float, float]:
    """(the four products, the rest) of one fused-block call: the rest is
    the attention products and the elementwise work (LayerNorm ~8 a
    element, gelu ~10, softmax ~4 a score, the residual adds)."""
    m = b * s
    products = 2 * m * (3 * d * d + d * d + 2 * r * d * d)
    attention = 4 * b * h * s * s * (d // h)
    elementwise = (2 * 8 * m * d + 10 * m * r * d + 4 * b * h * s * s
                   + 2 * m * d)
    return float(products), float(attention + elementwise)


def ft_block_params(d: int, r: int) -> int:
    """Parameters of one block: two LayerNorms, QKV, projection, FFN."""
    return (2 * 2 * d + (d * 3 * d + 3 * d) + (d * d + d)
            + (d * r * d + r * d) + (r * d * d + d))


def ft_block_cost(b: int, s: int, d: int, h: int, r: int
                  ) -> tuple[float, float]:
    """(operations, bytes) of one fused-block call."""
    products, rest = ft_block_ops(b, s, d, h, r)
    n_bytes = 2 * b * s * d * 4 + ft_block_params(d, r) * 4
    return products + rest, float(n_bytes)


def ft_block_bound_s(b: int, s: int, d: int, h: int, r: int) -> float:
    """The least time one fused-block call can take on the card: the
    largest of its bytes over the memory rate, its products in
    FT_SPLIT_PASSES bf16 passes over the tensor-core rate, and the rest
    over the f32 rate."""
    products, rest = ft_block_ops(b, s, d, h, r)
    n_bytes = ft_block_cost(b, s, d, h, r)[1]
    return max(n_bytes / peaks.HBM_BYTES_PER_S,
               FT_SPLIT_PASSES * products / peaks.BF16_FLOPS,
               rest / peaks.F32_FLOPS)
