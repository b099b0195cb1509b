"""The port's ops: the hand-written kernels' wrappers with their plain
twins, and the model-level math around them."""


def register_operators() -> None:
    """Import the modules that register the `shifu_tpu_torch::` operators
    (ft_block, small_attention, embedding_lookup, flash_fwd), as
    `torch.export.load` needs before it reads a program that calls them."""
    from . import embedding, flash_attention, ft_block, small_attention  # noqa: F401
