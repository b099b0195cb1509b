"""shifu_tpu_torch — the PyTorch/CUDA port of shifu_tpu.

The JAX package `shifu_tpu` stays beside this one as the reference; this
package imports none of it.  Module names mirror the JAX package's so each
counterpart is easy to find (`ops/ft_block.py` <-> `ops/pallas_ft_block.py`,
`export/scorer.py` <-> `export/scorer.py`, ...).

What is ported so far: the serving path of an exported artifact (the
micro-batching daemon `runtime/serve.py` over `TorchScorer`,
`export/scorer.py`, for the MLP and the FT-Transformer) and the training
path on one GPU (`train/loop.train`, from Shifu config files or in-memory
datasets) of the MLP, on the int8 wire, and of the FT-Transformer, with
local or flash attention.  Seven hand-written CUDA kernels for Hopper run
on these paths, in six sources (`csrc/ft_block.cu`,
`csrc/small_attention.cu`, `csrc/int8_matmul.cu`, `csrc/flash_fwd.cu`,
`csrc/flash_bwd_dq.cu`, `csrc/flash_bwd_dkv.cu`); each has a plain
PyTorch twin in its wrapper module that serves CPU tensors only.

Entry points run on `cuda:0` unless the caller passes `device="cpu"`
(`device.resolve_device`).
"""

__version__ = "0.1.0"
