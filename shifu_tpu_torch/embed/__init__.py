"""Sparse embedding engine (port of shifu_tpu/embed/): per-batch
unique-id compaction (`dedup`, with its journaled report), the
frequency-tiered table (`tiering`: hot rows in memory, the cold tail on a
host memmap) and vocab-sharded tables over a mesh's model axis
(`shard`).  Its kernels, the lookup and the fused rows-touched update,
live in ops/embedding.py; train/sparse_embed.py wires them into the
step."""

from .dedup import (INVERSE_KEY, UNIQUE_KEY, attach_dedup, dedup_ids,
                    dedup_lookup, host_ids)
from .tiering import TieredTable

__all__ = ["INVERSE_KEY", "UNIQUE_KEY", "TieredTable", "attach_dedup",
           "dedup_ids", "dedup_lookup", "host_ids"]
