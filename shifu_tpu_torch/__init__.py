"""shifu_tpu_torch — the PyTorch/CUDA port of shifu_tpu.

The JAX package `shifu_tpu` stays beside this one as the reference; this
package imports none of it.  Module names mirror the JAX package's so each
counterpart is easy to find (`ops/ft_block.py` <-> `ops/pallas_ft_block.py`,
`export/scorer.py` <-> `export/scorer.py`, ...).

What is ported so far: the serving path of an exported artifact (the
micro-batching daemon `runtime/serve.py` over `TorchScorer`,
`export/scorer.py`, for the MLP and the FT-Transformer) and the training
path on one GPU (`train/loop.train`, from Shifu config files or in-memory
datasets) of the MLP, on the int8 wire, of the FT-Transformer, with local
or flash attention, and of Wide&Deep and DeepFM; and the operator's
command, `python -m shifu_tpu_torch.launcher.cli train` (the Shifu XML
overlay, the restart supervisor, the chaos plan), with its data plane:
the native C++ parser, the parse-once cache and out-of-core ingest; every
scoring tier of an artifact (`runtime/serve.load_engine`: torch, the
`torch.export` program, the AOT pack, the numpy op list and the native C++
scorer) and the commands `score`, `eval`, `export`, `serve` and
`loadtest`; the operator's views (`metrics`, `profile`, `trace`, `top`,
`drift`, `timeline`, `chaos-verify`) and detached jobs (`train --detach`,
`status`, `attach`, `kill`); the frequency-tiered embedding table; the
one-host serving fleet; data-parallel training, local SGD and
vocab-sharded tables on torch.distributed, one process per device
(`parallel/`, `train(..., mesh=)`, `train --devices N`).  Nine hand-written CUDA kernels for Hopper, in eight sources
under `csrc/`, replace the JAX package's TPU kernels; each has a plain
PyTorch twin in its wrapper module that serves CPU tensors only, and the
scoring path's forwards are `shifu_tpu_torch::` operators.

Entry points run on `cuda:0` unless the caller passes `device="cpu"`
(`device.resolve_device`).
"""

__version__ = "0.1.0"
