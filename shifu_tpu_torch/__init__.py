"""shifu_tpu_torch — the PyTorch/CUDA port of shifu_tpu.

The JAX package `shifu_tpu` stays beside this one as the reference; this
package imports none of it.  Module names mirror the JAX package's so each
counterpart is easy to find (`ops/ft_block.py` <-> `ops/pallas_ft_block.py`,
`export/scorer.py` <-> `export/scorer.py`, ...).

What is ported so far is the serving path of an exported artifact: the
micro-batching daemon (`runtime/serve.py`) over `TorchScorer`
(`export/scorer.py`), which rebuilds the model (MLP or FT-Transformer) from
`topology.json` + `weights.npz`.  The FT-Transformer's blocks run through two
hand-written CUDA kernels for Hopper (`csrc/ft_block.cu`,
`csrc/small_attention.cu`); each has a plain PyTorch twin in its wrapper
module that serves CPU tensors only.

Entry points run on `cuda:0` unless the caller passes `device="cpu"`
(`device.resolve_device`).
"""

__version__ = "0.1.0"
