"""The port's ops: the hand-written kernels' wrappers with their plain
twins, and the model-level math around them.  The JAX package's exports
load on first use.  One name differs: `ops.flash_attention` is the module
of kernels #7 and #8 (the JAX package's `pallas_attention`), and the
function is `ops.flash_attention.flash_attention`."""

from .._lazy import exports

__getattr__, _lazy_all = exports(__name__, {
    "activations": ("get_activation", "leaky_relu"),
    "initializers": ("bias_init", "xavier_bias", "xavier_uniform"),
    "losses": ("bce", "get_loss", "l2_penalty", "multitask_loss",
               "weighted_bce", "weighted_mse"),
    "metrics": ("auc", "weighted_error"),
    "ft_block": ("fused_block_engaged", "fused_transformer_block"),
    "int8_matmul": ("int8_matmul_dequant",),
})
__all__ = [*_lazy_all, "launch_counters", "register_operators"]


def register_operators() -> None:
    """Import the modules that register the `shifu_tpu_torch::` operators
    (ft_block, small_attention, embedding_lookup, flash_fwd), as
    `torch.export.load` needs before it reads a program that calls them."""
    from . import embedding, flash_attention, ft_block, small_attention  # noqa: F401


def launch_counters() -> dict:
    """Every kernel wrapper by kernel name.  A wrapper adds one to its
    `.launches` where it launches its kernel (on a CUDA tensor), and
    nowhere else: the evidence that a path ran on the card's kernels."""
    from . import flash_attention as fa
    from .embedding import embedding_lookup, fused_rows_update
    from .ft_block import fused_transformer_block
    from .int8_matmul import int8_matmul_dequant
    from .small_attention import small_attention_bwd, small_token_attention
    return {"ft_block": fused_transformer_block,
            "small_attention": small_token_attention,
            "small_attention_bwd": small_attention_bwd,
            "int8_matmul": int8_matmul_dequant,
            "embedding_lookup": embedding_lookup,
            "rows_update": fused_rows_update,
            "flash_fwd": fa.flash_fwd, "flash_bwd_dq": fa.flash_bwd_dq,
            "flash_bwd_dkv": fa.flash_bwd_dkv}
