"""The benchmark of `shifu_tpu_torch` on one NVIDIA H100.

`perfbench/run.py` runs one cell of `BENCHMARK.json`.  Everything that
belongs to one model configuration, traffic mix, cell or metric is a file
of its own, found by its name: `configs/<config>.json`,
`traffic/<traffic>.json` (which names its driver, `drivers/<driver>.py`),
`workloads/<cell>.json` (the cell's correctness limits) and
`metrics/<metric>.py`.  `core/` is the yardstick: the generator of inputs
and weights, the peaks, the FLOP and byte formulas and the reduction of a
profiler trace.  `reference/` is the plain PyTorch model that decides
`correct`.  Nothing here imports JAX or the JAX package.
"""
