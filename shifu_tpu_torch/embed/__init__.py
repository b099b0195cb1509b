"""Sparse embedding engine (port of shifu_tpu/embed/, the parts one GPU
needs): per-batch unique-id compaction (`dedup`, with its journaled
report) and the frequency-tiered table (`tiering`: hot rows in memory, the
cold tail on a host memmap).  Its kernels, the lookup and the fused
rows-touched update, live in ops/embedding.py; train/sparse_embed.py wires
them into the step.  Vocab sharding waits for the multi-GPU slice
(ROADMAP.md queue A item (f))."""

from .dedup import (INVERSE_KEY, UNIQUE_KEY, attach_dedup, dedup_ids,
                    dedup_lookup, host_ids)
from .tiering import TieredTable

__all__ = ["INVERSE_KEY", "UNIQUE_KEY", "TieredTable", "attach_dedup",
           "dedup_ids", "dedup_lookup", "host_ids"]
